"""Host-side sequence runners around the per-frame step — port of
``stereo_svo_tpu/engine/runner.py``: ``StereoSvo``, ``run_sequence``,
``run_sequence_scan`` (the reference's ``lax.scan`` runner, the one
``bench.py`` drives) and ``run_sequence_batched`` (B sequences per step).

Poses and metrics stay on the device until read, so a frame costs the
step's single host sync and nothing more (one per batched frame for the
batched runner).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import SvoConfig
from ..device import resolve
from .state import FrameOut, SlamState, init_state
from .step import HostFlags, host_flags, make_batched_step, make_step


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

    def resume(self, state: SlamState) -> None:
        """Continue from ``state`` (a checkpoint loaded onto this engine's
        device): the host's flags are read from it, one host sync."""
        self.state = state
        self._flags = host_flags(state)

    @property
    def tracking_ok(self) -> bool:
        """Whether the last frame tracked: the host's copy of the flag,
        read in the step's one sync (no device read here)."""
        return self._flags.tracking_ok

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


def _images(frames, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(frames, dtype=torch.float32,
                           device=device).contiguous()


def _stack(items):
    """Stack a list of NamedTuples (nested ones too) field by field."""
    first = items[0]
    if isinstance(first, tuple):
        return type(first)(*(_stack(list(f)) for f in zip(*items)))
    return torch.stack(items)


def run_sequence_scan(cfg: SvoConfig, lefts, rights, device="cuda"
                      ) -> Tuple[SlamState, FrameOut]:
    """Whole-sequence processing: lefts/rights (T,H,W) in, (final state,
    FrameOut stacked over T) out, everything on the device."""
    device = resolve(device)
    lefts, rights = _images(lefts, device), _images(rights, device)
    step = make_step(cfg)
    state = init_state(cfg, device)
    flags = HostFlags(booted=False, tracking_ok=True)
    outs = []
    for t in range(lefts.shape[0]):
        state, out, flags = step(state, lefts[t], rights[t], flags)
        outs.append(out)
    return state, _stack(outs)


def run_sequence_batched(cfg: SvoConfig, lefts, rights, device="cuda"
                         ) -> Tuple[SlamState, FrameOut]:
    """Multi-sequence batched odometry: lefts/rights (B,T,H,W) in; the
    final states stacked (every field with a leading B axis) and a
    FrameOut with leading (B,T) axes out. One host sync per batched frame
    after the first (:func:`step.make_batched_step`); the states are
    stacked once, at the end."""
    device = resolve(device)
    lefts, rights = _images(lefts, device), _images(rights, device)
    B, T = lefts.shape[:2]
    bstep = make_batched_step(cfg)
    states = [init_state(cfg, device) for _ in range(B)]
    flags = [HostFlags(booted=False, tracking_ok=True)] * B
    outs = []
    for t in range(T):
        states, out, flags = bstep(states, lefts[:, t], rights[:, t], flags)
        outs.append(out)
    per_seq = [_stack([outs[t][b] for t in range(T)]) for b in range(B)]
    return _stack(states), _stack(per_seq)
