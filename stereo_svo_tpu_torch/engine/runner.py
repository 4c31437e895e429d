"""Host-side sequence runners around the per-frame step — port of
``stereo_svo_tpu/engine/runner.py``: ``StereoSvo``, ``run_sequence``,
``run_sequence_scan`` (the reference's ``lax.scan`` runner, the one
``bench.py`` drives) and ``run_sequence_batched`` (B sequences per step).

``StereoSvo``, ``run_sequence`` and ``run_sequence_scan`` run the
graph-captured step (``graphed.make_graphed_step``), as the reference's
runners run the jitted, state-donating one; ``run_sequence_batched`` runs
its batched form (``graphed.make_graphed_batched_step``), as the
reference's runs the jitted batched step. Every frame, the bootstrap
included, is one launch of the step's frame graph, whose branches run on
the device. Poses and metrics stay on the device until read:
``run_sequence_scan`` and ``run_sequence_batched`` read nothing between
frames (the reference's "zero host involvement between frames"), and
``StereoSvo`` reads only when asked. ``run_frames`` and
``run_frames_batched`` are those two runners' frame loops on a step made
once: reset and run again, a step replays what a fresh one gives (the
benchmark's repeated runs, ``bench_torch.py``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import SvoConfig
from ..device import resolve
from .graphed import make_graphed_batched_step, make_graphed_step
from .state import FrameOut, SlamState


class StereoSvo:
    """Construct with settings and a device, feed stereo pairs, read
    poses/trajectory. Runs on the card unless ``device="cpu"``; raises
    RuntimeError where CUDA is missing. The step's graphs are captured
    here, once (``graphed.make_graphed_step``)."""

    def __init__(self, cfg: SvoConfig, device="cuda"):
        device = resolve(device)
        self.cfg = cfg
        self.device = device
        self._step = make_graphed_step(cfg, device)
        self._trajectory: List[torch.Tensor] = []
        self._metrics: List[FrameOut] = []

    @property
    def state(self) -> SlamState:
        """The live state: the step's own buffers, which the next frame
        overwrites (as donation does in JAX) — clone what is kept across
        frames. Assigning copies into them, as :meth:`resume` does."""
        return self._step.state

    @state.setter
    def state(self, state: SlamState) -> None:
        self._step.load(state)

    def new_image(self, left, right) -> FrameOut:
        """Process one stereo pair ((H,W) arrays or tensors in [0, 255]).
        The FrameOut returned is the engine's own copy, on the device: the
        step reads nothing back."""
        left = torch.as_tensor(left, dtype=torch.float32, device=self.device)
        right = torch.as_tensor(right, dtype=torch.float32,
                                device=self.device)
        _, out = self._step(self._step.state, left, right)
        out = FrameOut(*(x.clone() for x in out))
        self._trajectory.append(out.T_wc)
        self._metrics.append(out)
        return out

    def resume(self, state: SlamState) -> None:
        """Continue from ``state`` (a checkpoint loaded onto this engine's
        device), copied into the live buffers."""
        self._step.load(state)

    @property
    def tracking_ok(self) -> bool:
        """Whether the last frame tracked: the live state's flag, read
        from the device (one read)."""
        return bool(self._step.state.tracking_ok)

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


def _rows(out: FrameOut, lead: Tuple[int, ...]) -> FrameOut:
    """A FrameOut like ``out`` with the leading axes ``lead`` before every
    field, allocated on its device."""
    return FrameOut(*(torch.empty(lead + tuple(x.shape), dtype=x.dtype,
                                  device=x.device) for x in out))


def run_frames(step, lefts, rights, after_frame=None
               ) -> Tuple[SlamState, FrameOut]:
    """Run (T,H,W) frames through a made graphed step
    (:func:`graphed.make_graphed_step`) from its live state: (final state,
    FrameOut stacked over T), everything on the step's device. Each frame
    is a device copy of its images into the step's, one launch of its
    frame graph and a device copy of its FrameOut into row t of the
    stacked one: no host read between frames, as the reference's
    ``lax.scan``. ``after_frame(t)``, when given, runs after frame t is
    enqueued (a CUDA event there times the frames).

    A step reset (``step.reset()``) and run again gives what a fresh
    step gives, bit for bit: the counterpart of a second call of the
    reference's jitted runner, which does not compile again."""
    lefts, rights = _images(lefts, step.device), _images(rights, step.device)
    T = lefts.shape[0]
    outs = None
    for t in range(T):
        _, out = step(step.state, lefts[t], rights[t])
        if outs is None:
            outs = _rows(out, (T,))
        torch._foreach_copy_([x[t] for x in outs], list(out))
        if after_frame is not None:
            after_frame(t)
    return step.state, outs


def run_frames_batched(bstep, lefts, rights, after_frame=None
                       ) -> Tuple[SlamState, FrameOut]:
    """:func:`run_frames` for a made graphed batched step
    (:func:`graphed.make_graphed_batched_step`): lefts/rights (B,T,H,W)
    in; the final states stacked (every field with a leading B axis) and
    a FrameOut with leading (B,T) axes out; one launch of its frame graph
    a batched frame, ``after_frame(t)`` after batched frame t."""
    lefts = _images(lefts, bstep.device)
    rights = _images(rights, bstep.device)
    T = lefts.shape[1]
    outs = None
    for t in range(T):
        _, out = bstep(bstep.state, lefts[:, t], rights[:, t])
        if outs is None:
            outs = _rows(out, (T,))       # (T,B,…), as (B,T,…) below
        torch._foreach_copy_([x[t] for x in outs], list(out))
        if after_frame is not None:
            after_frame(t)
    return bstep.state, FrameOut(*(x.transpose(0, 1) for x in outs))


def run_sequence_scan(cfg: SvoConfig, lefts, rights, device="cuda"
                      ) -> Tuple[SlamState, FrameOut]:
    """Whole-sequence processing: lefts/rights (T,H,W) in, (final state,
    FrameOut stacked over T) out, everything on the device, through a
    graph-captured step made here (:func:`run_frames`): no host read
    between frames, as the reference's ``lax.scan``."""
    return run_frames(make_graphed_step(cfg, resolve(device)), lefts,
                      rights)


def run_sequence_batched(cfg: SvoConfig, lefts, rights, device="cuda"
                         ) -> Tuple[SlamState, FrameOut]:
    """Multi-sequence batched odometry: lefts/rights (B,T,H,W) in; the
    final states stacked (every field with a leading B axis) and a
    FrameOut with leading (B,T) axes out, through the graph-captured
    batched step (:func:`graphed.make_graphed_batched_step`; captured here,
    once), whose every phase runs once for the whole batch: one launch of
    its frame graph a batched frame, and no host read between frames
    (:func:`run_frames_batched`)."""
    B = len(lefts)
    return run_frames_batched(
        make_graphed_batched_step(cfg, B, resolve(device)), lefts, rights)
