"""Device selection for the port's entry points, and indexing that keeps
the host off the device's queue.

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


def index0(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] along dim 0 for a 0-dim index tensor, without a host sync
    (``x[i]`` reads a 0-dim index to the host)."""
    return x.index_select(0, i.reshape(1).long())[0]
