"""Tracing/profiling helpers — port of ``stereo_svo_tpu/utils/profiling.py``.

``trace()`` wraps ``torch.profiler`` and writes a Chrome trace (open it in
Perfetto or chrome://tracing); ``time_fn`` is the micro-benchmark harness:
CUDA events when the arguments live on the card, the host clock on the
CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(logdir: str = "build/svo_trace"):
    """Profile a block: ``with trace(d): run()`` writes ``d/trace.json``
    (host activity, and the card's where there is one)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _on_card(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda
               or isinstance(a, (tuple, list)) and _on_card(a)
               for a in args)


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 2) -> float:
    """Median time (s) of ``fn(*args)``.

    With an argument on the card: the device time between a pair of CUDA
    events around each call (one synchronisation after the last call). On
    the CPU: the host clock around each call, with no synchronisation.
    """
    for _ in range(warmup):
        fn(*args)
    if _on_card(args):
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn(*args)
            t1.record()
            pairs.append((t0, t1))
        torch.cuda.synchronize()
        times = [a.elapsed_time(b) * 1e-3 for a, b in pairs]
    else:
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
