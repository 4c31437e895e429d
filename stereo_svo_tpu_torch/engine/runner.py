"""Host-side sequence runner around the per-frame step — port of
``StereoSvo`` and ``run_sequence`` of ``stereo_svo_tpu/engine/runner.py``.

Poses and metrics stay on the device until read, so a frame costs the
step's single host sync and nothing more.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import SvoConfig
from ..device import resolve
from .state import FrameOut, SlamState, init_state
from .step import HostFlags, make_step


class StereoSvo:
    """Construct with settings and a device, feed stereo pairs, read
    poses/trajectory. Runs on the card unless ``device="cpu"``; raises
    RuntimeError where CUDA is missing."""

    def __init__(self, cfg: SvoConfig, device="cuda"):
        device = resolve(device)
        self.cfg = cfg
        self.device = device
        self._step = make_step(cfg)
        self.state: SlamState = init_state(cfg, device)
        self._flags = HostFlags(booted=False, tracking_ok=True)
        self._trajectory: List[torch.Tensor] = []
        self._metrics: List[FrameOut] = []

    def new_image(self, left, right) -> FrameOut:
        """Process one stereo pair ((H,W) arrays or tensors in [0, 255])."""
        left = torch.as_tensor(left, dtype=torch.float32,
                               device=self.device).contiguous()
        right = torch.as_tensor(right, dtype=torch.float32,
                                device=self.device).contiguous()
        self.state, out, self._flags = self._step(self.state, left, right,
                                                  self._flags)
        self._trajectory.append(out.T_wc)
        self._metrics.append(out)
        return out

    @property
    def pose(self) -> np.ndarray:
        """Current camera→world pose (3,4)."""
        return self._trajectory[-1].cpu().numpy()

    def trajectory(self) -> np.ndarray:
        return torch.stack(self._trajectory).cpu().numpy()

    def metrics(self) -> Dict[str, np.ndarray]:
        return {k: torch.stack([getattr(m, k) for m in self._metrics])
                .cpu().numpy()
                for k in FrameOut._fields if k != "T_wc"}


def run_sequence(cfg: SvoConfig, lefts, rights, device="cuda"
                 ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Run a whole sequence; returns (T_wc trajectory (N,3,4), metrics)."""
    svo = StereoSvo(cfg, device)
    for left, right in zip(lefts, rights):
        svo.new_image(left, right)
    return svo.trajectory(), svo.metrics()
