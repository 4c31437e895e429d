"""Device selection for the port's entry points.

Every entry point takes ``device="cuda"`` by default and runs on the CPU
only when the caller asks for it: a missing card raises, it never falls
back to the CPU.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``torch.device(device)``; raise RuntimeError for a CUDA device on a
    machine without one."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: CUDA is not available "
                           f"(pass device='cpu' to run on the CPU)")
    return device
