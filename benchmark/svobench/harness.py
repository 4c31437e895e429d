"""What every traffic mode shares: the cell as a run sees it, the sequences
rendered from the seed, the chunked window of the offline modes with its
device clock, and the record a mode hands back once its window has
closed."""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import render, stats, trace, traffic as traffic_mod


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Cell:
    """One run of one cell: its configuration and traffic files' contents,
    the run's arguments and the device it drives."""
    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float                     # host clock at process start
    render_s: float = 0.0              # set-up seconds spent rendering

    def program_config(self):
        """The configuration as the program takes it."""
        from stereo_svo_tpu_torch.config import CameraConfig, SvoConfig
        return _svo_config(SvoConfig, CameraConfig, self.config)

    def sequences(self, n: int, frames: Optional[int] = None
                  ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """The run's ``n`` sequences, rendered on the device from the seed:
        (T,H,W) left and right float32 frames and (T,3,4) ground truth, T
        the traffic's length or ``frames``."""
        tr = self.traffic
        t = time.perf_counter()
        out = [render.render_sequence(
            self.config["camera"], frames or tr["frames"], tr["dt"],
            tr["trajectory"],
            tr["scene"], s, tr.get("aa", 1), self.device)
            for s in traffic_mod.sequence_seeds(self.seed, n,
                                                tr.get("pool"))]
        self.sync()
        self.render_s = time.perf_counter() - t
        return out

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _svo_config(SvoConfig, CameraConfig, config: dict):
    svo = dict(config["svo"])
    if svo.get("align_iters_per_level") is not None:
        svo["align_iters_per_level"] = tuple(svo["align_iters_per_level"])
    return SvoConfig(camera=CameraConfig(**config["camera"]), **svo)


@dataclasses.dataclass
class Compared:
    """One sequence held against the reference: the frames it was given
    (float32, (T,H,W)) and every run of it in the window, as (poses (t,3,4),
    tracking_ok (t,), kf_inserted (t,)) numpy arrays over its first t
    frames."""
    lefts: torch.Tensor
    rights: torch.Tensor
    runs: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]


@dataclasses.dataclass
class Record:
    """What a mode hands back once its window has closed."""
    e2e: Dict[str, float]              # end-to-end metrics
    layer: Dict[str, object]           # what the per-layer readers read
    attempted: int                     # frames completed in the window
    failed: int                        # of those, frames not tracked
    memory_peak_bytes: int
    compared: List[Compared]
    # every sequence run in the window: (poses, ground truth, tracking_ok)
    gated: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]
    summary: Optional[trace.Summary] = None
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)


def outs_to_host(outs) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    return (outs.T_wc.cpu().numpy(), outs.tracking_ok.cpu().numpy(),
            outs.kf_inserted.cpu().numpy())


class DeviceClock:
    """Marks after each piece of work, by CUDA events on the card (the host
    clock on the CPU), keeping at most one piece in flight: each mark waits
    for the one before it, so the host never runs far ahead of the device
    and the device never waits for the host."""

    def __init__(self, device: torch.device):
        self.on_card = device.type == "cuda"
        self.marks: List[object] = []

    def mark(self) -> int:
        if self.on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
            if len(self.marks) > 1:
                self.marks[-2].synchronize()
        else:
            self.marks.append(time.perf_counter())
        return len(self.marks) - 1

    def seconds(self, a: int, b: int) -> float:
        """Device seconds from mark ``a`` to mark ``b`` (after a sync)."""
        if self.on_card:
            return self.marks[a].elapsed_time(self.marks[b]) * 1e-3
        return self.marks[b] - self.marks[a]


@dataclasses.dataclass
class Piece:
    stream: int        # which sequence (or batch of sequences)
    a: int             # its first frame
    b: int             # one past its last frame
    mark: int          # the device mark after it
    host_s: float      # host seconds inside the runner's call
    traced: bool       # inside the profiler (its warm-up frame or slice)
    outs: object       # the runner's FrameOut, on the device


def chunked_window(cell: Cell, n_streams: int, T: int, chunk: int,
                   call: Callable, reset: Callable
                   ) -> Tuple[List[Piece], DeviceClock, float, float,
                              Optional[trace.Summary]]:
    """The offline modes' window: streams (a sequence, or a batch of them)
    run one after another from a reset, ``chunk`` frames a runner call,
    cycling, until ``cell.seconds`` have passed on the host clock at a
    call's end. ``call(stream, a, b)`` runs frames a..b of a stream and
    returns the runner's FrameOut. With ``cell.trace``, the window is
    followed by the traced slice (:func:`traced_slice`): the next frames
    of the stream the window ended in, or of the next one from its reset.
    Returns the pieces, their clock, the window's host start and end, and
    the slice's summary."""
    clock = DeviceClock(cell.device)
    pieces: List[Piece] = []

    def run(stream, a, b, traced):
        t = time.perf_counter()
        with trace.mark("bench.runner"):
            outs = call(stream, a, b)
        host = time.perf_counter() - t
        pieces.append(Piece(stream, a, b, clock.mark(), host, traced, outs))

    t0 = time.perf_counter()
    clock.mark()
    stream, b = 0, T
    while True:
        if b == T:
            with trace.mark("bench.reset"):
                reset()
            a = 0
        else:
            a = b
        b = min(a + chunk, T)
        run(stream, a, b, False)
        if b == T:
            stream = (stream + 1) % n_streams
        if time.perf_counter() - t0 >= cell.seconds:
            break
    t1 = time.perf_counter()
    cell.sync()
    summary = None
    if cell.trace:
        n = 1 + cell.traffic["slice_frames"]
        if T - b < n:
            with trace.mark("bench.reset"):
                reset()
            b = 0
        summary = traced_slice(cell, [lambda a=a: run(stream, a, a + 1, True)
                                      for a in range(b, b + n)])
    return pieces, clock, t0, t1, summary


def traced_slice(cell: Cell, frames: List[Callable]) -> trace.Summary:
    """Profile the frames after the window: the first in the profiler's
    warm-up step, the others in its active one, all in the ``bench.slice``
    range, synchronised at both ends. The trace is reduced after the
    slice, outside the window."""
    tracer = trace.Slice()
    cell.sync()
    with tracer:
        frames[0]()
        cell.sync()
        tracer.step()
        with tracer.profiled():
            for f in frames[1:]:
                f()
            with trace.mark("bench.sync"):
                cell.sync()
        tracer.step()
    return tracer.summary


def window_rates(pieces: List[Piece], clock: DeviceClock, per_step: int):
    """Frames and device seconds over the window (the traced slice after
    it left out), and the window's per-second timeline."""
    window = [p for p in pieces if not p.traced]     # the slice follows
    frames = sum(p.b - p.a for p in window) * per_step
    total = clock.seconds(0, window[-1].mark)
    segs = [(clock.seconds(0, p.mark), (p.b - p.a) * per_step)
            for p in window]
    return frames, total, segs


def runs_of(pieces: List[Piece]):
    """The pieces grouped into runs of a stream from its reset: a list of
    (stream, [pieces]) in window order."""
    runs: List[Tuple[int, List[Piece]]] = []
    for p in pieces:
        if p.a == 0 or not runs:
            runs.append((p.stream, []))
        runs[-1][1].append(p)
    return runs


def chunked_record(cell: Cell, seqs, pieces: List[Piece], clock: DeviceClock,
                   t0: float, t1: float, summary, peak: int, per_step: int,
                   notes: dict) -> Record:
    """The Record of a chunked window over ``seqs``; with ``per_step`` > 1
    a step runs that many sequences, every FrameOut field (B,t,…)."""
    frames, total, segs = window_rates(pieces, clock, per_step)
    axis = 0 if per_step == 1 else 1
    gated, by_seq, failed, keyframes, seen = [], {}, 0, 0, 0
    runs = runs_of(pieces)
    for stream, run_pieces in runs:
        cols = [outs_to_host(p.outs) for p in run_pieces]
        poses, ok, kf = (np.concatenate([c[i] for c in cols], axis)
                         for i in range(3))
        members = ([(stream, poses, ok, kf)] if per_step == 1 else
                   [(b, poses[b], ok[b], kf[b]) for b in range(per_step)])
        for s, p, o, k in members:
            gated.append((p, seqs[s][2][:len(p)].cpu().numpy(), o))
            by_seq.setdefault(s, []).append((p, o, k))
            failed += int((~o).sum())
            keyframes += int(k.sum())
            seen += len(k)
    picks = traffic_mod.compared(cell.seed, len(seqs),
                                 cell.traffic["compared"])
    compared = [Compared(seqs[s][0], seqs[s][1], by_seq.get(s, []))
                for s in picks]
    untraced = [p for p in pieces if not p.traced]
    sliced = [p for p in pieces if p.traced][1:]   # past the warm-up frame
    setup_s = t0 - cell.t_start
    notes.update({
        "setup_s": setup_s, "window_host_s": t1 - t0, "frames": frames,
        "device_s": total, "runs": len(runs), "keyframes": keyframes,
        "keyframe_share": keyframes / max(seen, 1),
        "frames_per_s_each_second": [round(x, 2)
                                     for x in stats.timeline(segs)]})
    return Record(
        e2e={"frames_per_s": stats.rate(frames, total), "setup_s": setup_s},
        layer={"runner_s": sum(p.host_s for p in untraced),
               "runner_steps": sum(p.b - p.a for p in untraced),
               "slice_steps": sum(p.b - p.a for p in sliced),
               "slice_frames": sum(p.b - p.a for p in sliced) * per_step,
               "window": (t0, t1)},
        attempted=frames, failed=failed, memory_peak_bytes=peak,
        compared=compared, gated=gated, summary=summary, notes=notes)


def peak_bytes(device: torch.device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
