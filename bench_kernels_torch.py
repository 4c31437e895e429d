#!/usr/bin/env python3
"""Per-stage timings of the PyTorch/CUDA port's pipeline on the card — the
port's counterpart of bench_kernels.py, with bench_amortized.py's frame
accounting.

Run from the repository root:
    python3 bench_kernels_torch.py [--stress | --kitti]
(``BENCH_AMORT_STRESS=1``, the reference's name, is ``--stress``.) Prints
one JSON object. CUDA is required; the tests call :func:`stage_table` with
``device="cpu"``.

Inputs: a real evolved state, as bench_amortized.py's. The sequence is
chip_smoke.py phase 3's (``SvoConfig()``, the ``planes`` scene on the
``arc`` trajectory, 752x480, seed 0, dt 0.08, 100 frames; ``--stress``:
``stress_config()`` on the same frames; ``--kitti``: ``kitti_config()`` on
phase 4's ``road`` scene and ``kitti`` trajectory at 1241x376, 2x2
anti-aliased). It runs through a graphed step to frame AT = 40. The first
non-keyframe frame from there gives the inputs of the per-frame rows, the
first keyframe frame from there those of the keyframe rows: each row's
arguments are those of the call the eager step (``engine/step.make_step``)
makes on that frame from the graphed run's state, recorded as it makes
them.

Rows: bench_kernels.py's (``pyramid_ms`` … ``full_step_ms``, :42-103),
then the per-frame costs bench_amortized.py adds: ``reloc_ms``,
``stereo_refresh_ms`` (the narrow stereo re-measurement and its depth
update), ``rebuild_template_ms`` and, where the configuration searches
epipolar segments (KITTI), ``epi_search_ms``. Each row gives:

- ``eager_ms``: CUDA events around each call (``utils/profiling.time_fn``);
- ``graphed_ms``: the row captured alone as a ``torch.cuda.CUDAGraph``
  after a warm-up, the mean of back-to-back replays between one pair of
  CUDA events (the device's time: the host issues them faster than even
  a one-kernel graph runs);
- ``kernel_nodes``: the graph's kernel nodes, and ``b_kernels`` those of
  B1-B4 among them, by the kernel's launch counter (read through libcuda,
  ``engine/graphed.scan``).

A fused kernel against the chain of ops it replaced is chip_smoke.py
phase 2's (``align_rows``, ``refine_rows``), timed by :func:`graphed_ms`.

``full_step_ms``: the eager step on the tracked frame, and the graphed
step's frame graph replayed on it (its kernel nodes: the bodies a tracked
frame runs, P, flags, A_ok and B). ``step_nonkf_ms`` (the median of the
non-keyframe frames) and ``scan_frame_ms`` (the frames after the
bootstrap over their span) come from one run of every frame through
``engine/runner.run_frames`` on one step, a CUDA event after each frame;
``kf_rate`` is keyframes / frames of that run. ``accounting`` is
bench_amortized.py's, with its keys, over the graphed rows:

    frame_ms ≈ step_nonkf_ms + kf_rate · (kf_insert_ms + window_ba_ms)

On the CPU (the tests) the rows are the plain versions' host-clock ms,
there are no graphs (``graphed_ms`` and the node counts null) and the
accounting is over ``eager_ms``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import statistics
import sys
import time

import bench_torch

AT = 40
N_FRAMES = 100
PKG = "stereo_svo_tpu_torch."
# row: (module, function) whose call in the frame gives the row
RECORDED = {
    "pyramid_ms": ("ops.pyramid", "build_with_gradients"),
    "detector_ms": ("frontend.detector", "detect"),
    "align_ms": ("ops.align", "align"),
    "align_template_ms": ("ops.align", "make_template"),
    "klt_ms": ("ops.klt", "track"),
    "klt_template_ms": ("ops.klt", "make_template"),
    "pose_refine_ms": ("frontend.pose_refine", "refine"),
    "stereo_match_ms": ("ops.stereo_match", "match"),
    "depth_filter_ms": ("ops.depth_filter", "observe_and_update"),
    "kf_insert_ms": ("frontend.keyframe", "insert"),
    "window_ba_ms": ("engine.step", "run_window_ba"),
    "reloc_ms": ("backend.loop_closure", "relocalize"),
    "epi_search_ms": ("ops.depth_filter", "epipolar_search"),
    "rebuild_template_ms": ("engine.step", "_rebuild_template"),
    "refine_disparity": ("ops.stereo_match", "refine_disparity"),
    "stereo_update": ("ops.depth_filter", "stereo_observe_and_update"),
}
# rows from the keyframe frame's calls; the others from the tracked frame's
KF_ROWS = ("detector_ms", "klt_template_ms", "stereo_match_ms",
           "kf_insert_ms", "window_ba_ms")
# bench_amortized.py's every-frame rows (align_template_ms is inside
# rebuild_template_ms: counted once)
EVERY_FRAME = ("align_ms", "klt_ms", "pyramid_ms", "align_template_ms",
               "pose_refine_ms", "depth_filter_ms", "reloc_ms",
               "epi_search_ms", "stereo_refresh_ms", "rebuild_template_ms")
# the order of the output: bench_kernels.py's rows, then
# bench_amortized.py's
ROWS = ("pyramid_ms", "fast_score_l0_ms", "detector_ms", "align_ms",
        "align_template_ms", "klt_ms", "klt_template_ms", "pose_refine_ms",
        "stereo_match_ms", "depth_filter_ms", "kf_insert_ms",
        "window_ba_ms", "full_step_ms", "reloc_ms", "stereo_refresh_ms",
        "rebuild_template_ms", "epi_search_ms")
GRAPH_REPLAYS = 50


def _clone(x):
    """A copy of a tensor or of a (named) tuple or list of them."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


@contextlib.contextmanager
def recording():
    """While the block runs, each function of RECORDED (looked up by its
    callers at each call) keeps the arguments of its first call: yields
    {row: (function, args, kwargs)}."""
    calls, originals = {}, []
    for row, (mod_name, name) in RECORDED.items():
        mod = importlib.import_module(PKG + mod_name)
        fn = getattr(mod, name)

        def wrapped(*args, _row=row, _fn=fn, **kwargs):
            calls.setdefault(_row, (_fn, args, kwargs))
            return _fn(*args, **kwargs)
        originals.append((mod, name, fn))
        setattr(mod, name, wrapped)
    try:
        yield calls
    finally:
        for mod, name, fn in reversed(originals):
            setattr(mod, name, fn)


def frame_inputs(cfg, step, lefts, rights, t: int) -> dict:
    """The recorded calls (:func:`recording`) of the eager step on frame
    ``t``, from the state the graphed ``step`` reaches after frames
    0..t-1."""
    from stereo_svo_tpu_torch.engine import runner
    from stereo_svo_tpu_torch.engine import step as step_mod

    step.reset()
    runner.run_frames(step, lefts[:t], rights[:t])
    state = _clone(step.state)
    flags = step_mod.HostFlags(booted=True,
                               tracking_ok=bool(state.tracking_ok))
    eager = step_mod.make_step(cfg)
    with recording() as calls:
        eager(state, lefts[t], rights[t], flags)
    calls["full_step_ms"] = (eager, (state, lefts[t], rights[t], flags), {})
    return calls


def rows_of(calls_track: dict, calls_kf: dict) -> dict:
    """{row: (fn, args)}: each row a call ``fn(*args)`` (keyword arguments
    bound into ``fn``)."""
    from stereo_svo_tpu_torch.ops import fast

    def bound(fn, args, kwargs):
        return (lambda *a: fn(*a, **kwargs)), args

    rows = {}
    for row in RECORDED:
        calls = calls_kf if row in KF_ROWS else calls_track
        if row in calls:
            rows[row] = bound(*calls[row])
    fn, args = rows["pyramid_ms"]
    rows["fast_score_l0_ms"] = (fast.corner_score, (fn(*args)[0][0],))
    if "refine_disparity" in rows:
        (f1, a1), (f2, a2) = rows.pop("refine_disparity"), rows.pop(
            "stereo_update")
        rows["stereo_refresh_ms"] = (
            lambda x, y: (f1(*x), f2(*y)), (a1, a2))
    rows["full_step_ms"] = bound(*calls_track["full_step_ms"])
    return rows


def graphed_ms(fn, args, stream, replays: int = GRAPH_REPLAYS):
    """``fn(*args)`` captured alone as a CUDA graph on ``stream`` after a
    warm-up there: (ms of a replay, the mean of ``replays`` back-to-back
    replays between one pair of CUDA events, the graph's nodes by kind,
    B1-B4 nodes by launch counter). An event pair around each replay
    would add the host's issue time to a short graph's."""
    import torch
    from stereo_svo_tpu_torch.engine import graphed

    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn(*args)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph, _, _ = graphed.capture(lambda: fn(*args), None, stream)
    kinds, b_kernels = graphed.scan(graph)
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / replays
    del graph
    return ms, kinds, b_kernels


def step_graphed_ms(step, state, left, right,
                    replays: int = GRAPH_REPLAYS) -> float:
    """The graphed step's frame graph on one frame from ``state``: median
    ms between CUDA events (the state copied back in before each)."""
    import torch
    pairs = []
    for _ in range(replays + 1):
        step.load(state)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step(step.state, left, right)
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs[1:])


def frame_times(step, lefts, rights):
    """One run of every frame through ``runner.run_frames`` on ``step``
    (reset first), a CUDA event (the host clock on the CPU) after each
    frame: (ms of each frame, the FrameOuts)."""
    import torch
    from stereo_svo_tpu_torch.engine import runner

    on_card = step.device.type == "cuda"

    def mark():
        if not on_card:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    step.reset()
    if on_card:
        torch.cuda.synchronize()
    marks = [mark()]
    _, outs = runner.run_frames(step, lefts, rights,
                                after_frame=lambda t: marks.append(mark()))
    if on_card:
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return ms, outs


def accounting(rows: dict, step_nonkf_ms: float, scan_frame_ms: float,
               kf_rate: float, column: str) -> dict:
    """bench_amortized.py's budget closure over ``rows[...][column]``."""
    ms = {k: v[column] for k, v in rows.items()}
    every = [k for k in EVERY_FRAME if k in ms and k != "align_template_ms"]
    per_frame_sum = sum(ms[k] for k in every)
    kf_cost = ms.get("kf_insert_ms", 0.0) + ms.get("window_ba_ms", 0.0)
    model_ms = step_nonkf_ms + kf_rate * kf_cost
    return {
        "rows": column,
        "per_op_sum_ms": per_frame_sum,
        "step_nonkf_ms": step_nonkf_ms,
        "intra_frame_residual_ms": step_nonkf_ms - per_frame_sum,
        "kf_phase_ms": kf_cost,
        "kf_rate": kf_rate,
        "model_frame_ms": model_ms,
        "measured_frame_ms": scan_frame_ms,
        "unaccounted_ms": scan_frame_ms - model_ms,
        "kf_phase_share_of_frame": kf_rate * kf_cost / scan_frame_ms,
    }


def stage_table(cfg, lefts, rights, at: int = AT, device="cuda",
                iters: int = 20) -> dict:
    """The table of the module docstring for ``cfg`` on the frames (T,H,W):
    the rows from frame ``at`` on, the frame accounting over all frames."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.device import resolve
    from stereo_svo_tpu_torch.engine import runner
    from stereo_svo_tpu_torch.engine.graphed import make_graphed_step
    from stereo_svo_tpu_torch.utils.profiling import time_fn

    device = resolve(device)
    on_card = device.type == "cuda"
    step = make_graphed_step(cfg, device)
    runner.run_frames(step, lefts, rights)          # warm-up
    ms, outs = frame_times(step, lefts, rights)
    kf = outs.kf_inserted.cpu().numpy()
    T = len(kf)
    after = range(max(at, 1), T)
    t_track = next((t for t in after if not kf[t]), None)
    t_kf = next((t for t in after if kf[t]), None)
    if t_track is None or t_kf is None:
        raise ValueError(f"no tracked or no keyframe frame from frame {at} "
                         f"of {T} (keyframes {np.nonzero(kf)[0].tolist()})")
    rows = rows_of(frame_inputs(cfg, step, lefts, rights, t_track),
                   frame_inputs(cfg, step, lefts, rights, t_kf))
    stream = torch.cuda.Stream(device) if on_card else None
    table = {}
    for name in (r for r in ROWS if r in rows):
        fn, args = rows[name]
        row = {"eager_ms": time_fn(fn, *args, iters=iters) * 1e3,
               "graphed_ms": None, "kernel_nodes": None, "b_kernels": None}
        if on_card and name == "full_step_ms":
            state = args[0]
            row["graphed_ms"] = step_graphed_ms(step, state, *args[1:3])
            bodies = ("P", "flags", "A_ok", "B")
            row["kernel_nodes"] = sum(step.nodes[b]["kernel"]
                                      for b in bodies)
            row["b_kernels"] = {k: sum(step.kernel_nodes[b][k]
                                       for b in bodies)
                                for k in step.kernel_nodes["P"]}
        elif on_card:
            row["graphed_ms"], kinds, row["b_kernels"] = graphed_ms(
                fn, args, stream)
            row["kernel_nodes"] = kinds["kernel"]
        table[name] = row
    steady = ms[1:]
    step_nonkf = statistics.median(
        m for t, m in enumerate(ms) if t > 0 and not kf[t])
    scan_frame = sum(steady) / len(steady)
    kf_rate = float(kf.sum()) / T
    return dict(
        table, step_nonkf_ms=step_nonkf, scan_frame_ms=scan_frame,
        kf_rate=kf_rate, frames=T, track_frame=t_track, kf_frame=t_kf,
        accounting=accounting(table, step_nonkf, scan_frame, kf_rate,
                              "graphed_ms" if on_card else "eager_ms"))


def main(argv=None) -> int:
    from stereo_svo_tpu_torch.config import (SvoConfig, kitti_config,
                                             stress_config)
    from stereo_svo_tpu_torch.device import resolve

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--stress", action="store_true",
                       help="stress_config() on phase 3's frames")
    which.add_argument("--kitti", action="store_true",
                       help="kitti_config() on phase 4's road sequence")
    args = ap.parse_args(argv)
    device = resolve("cuda:0")
    if args.kitti:
        cfg, name = kitti_config(), "kitti_config()"
        frames = bench_torch.render_sequence(cfg.camera, N_FRAMES, "road",
                                             "kitti", device=device)
    else:
        stress = args.stress or os.environ.get("BENCH_AMORT_STRESS") == "1"
        cfg, name = ((stress_config(), "stress_config()") if stress
                     else (SvoConfig(), "SvoConfig()"))
        frames = bench_torch.render_sequence(cfg.camera, N_FRAMES,
                                             device=device)
    out = stage_table(cfg, frames[0], frames[1], device=device)
    out.update(config=name, at=AT, device=bench_torch.device_line(device),
               timing="eager_ms: CUDA events around each call (median of "
                      "20); graphed_ms: the row's own CUDA graph, mean "
                      f"of {GRAPH_REPLAYS} back-to-back replays between "
                      "CUDA events")
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
