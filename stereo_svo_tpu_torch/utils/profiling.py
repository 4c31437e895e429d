"""Tracing/profiling helpers — port of ``stereo_svo_tpu/utils/profiling.py``.

``trace()`` wraps ``torch.profiler`` and writes a Chrome trace (open it in
Perfetto or chrome://tracing), with the frame, body and stage spans of the
graphed steps alive in its block; ``write_spans`` exports a step's spans
(``engine/graphed.py``) as one JSON line; ``stage`` and ``count`` mark a
stage of a body and a per-frame counter for the graphed step that captures
or runs the body (no-ops anywhere else); ``time_fn`` is the
micro-benchmark harness: CUDA events when the arguments live on the card,
the host clock on the CPU.

The spans' export. A graphed step on the card that is dropped (or still
alive when the process exits) appends its spans as one JSON line to
``build/svo_trace/spans-<pid>.jsonl`` at the root of the checkout, a file
the process truncates at its first write: the step's ``kind`` ("single",
"batched") and ``batch``, its ``bodies``, ``runs`` and ``ns`` (summed
device nanoseconds) by body, ``frames`` and ``launches``, the filled rows
of the device ring (``device_columns``: a frame's start and end, each
body's and each stage's nanoseconds in it and its start after the
frame's, 0 where it did not run, then each counter's value) and of the
host ring (``host_columns``: the step's call and its
launch of the frame graph, start and end), both oldest first, row k of one
the frame of row k of the other, and ``clock``: device times are
``%globaltimer`` nanoseconds, host times ``time.perf_counter_ns``; a
device time less ``device_minus_host_ns`` is on the host's clock, and a
host time plus ``realtime_minus_host_ns`` on the wall clock that
``torch.profiler``'s Chrome trace is stamped on (``ts`` in µs after its
``baseTimeNanoseconds``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from pathlib import Path
from typing import Callable, List, Optional

import torch

SPANS_DIR = Path(__file__).resolve().parents[2] / "build" / "svo_trace"
_written: set = set()      # span files this process has written to
_warned: List[str] = []
# the span table that stage() and count() write: set by a graphed step
# (engine/graphed.py) while it captures a body, or runs one in its plain
# version; None anywhere else
_stages = [None]


@contextlib.contextmanager
def stages(spans):
    """``stage()`` and ``count()`` inside the block go to ``spans`` (an
    object with ``open(name)``, ``close(name)`` and ``count(name,
    value)``, the stages and counters it keeps in ``stages`` and
    ``counters``), or nowhere with None."""
    before, _stages[0] = _stages[0], spans
    try:
        yield
    finally:
        _stages[0] = before


@contextlib.contextmanager
def stage(name: str):
    """A stage of a body, ``svo.stage.<name>``: an entry and an exit stamp
    around the block where a graphed step that keeps the stage captures or
    runs the body; nothing elsewhere."""
    spans = _stages[0]
    if spans is None or name not in spans.stages:
        yield
        return
    spans.open(name)
    yield
    spans.close(name)


def count(name: str, value: Callable[[], torch.Tensor]) -> None:
    """The frame's value of counter ``svo.count.<name>``, ``value()`` (a
    0-dim integer tensor, computed only where the counter is kept), where
    a graphed step that keeps the counter captures or runs the body."""
    spans = _stages[0]
    if spans is not None and name in spans.counters:
        spans.count(name, value())


def spans_path() -> Path:
    """This process's span file."""
    return SPANS_DIR / f"spans-{os.getpid()}.jsonl"


def write_spans(record: Callable[[], dict],
                path: Optional[Path] = None) -> None:
    """Append ``record()`` as one JSON line to ``path`` (this process's
    span file by default), truncating the file at the process's first
    write to it. A failure warns once and never raises."""
    path = Path(path or spans_path())
    try:
        line = json.dumps(record()) + "\n"
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a" if path in _written else "w") as f:
            f.write(line)
        _written.add(path)
    except (OSError, RuntimeError, ValueError) as e:
        if not _warned:
            _warned.append(str(e))
            warnings.warn(f"spans not written to {path}: {e}")


def span_events(record: dict, start_ns: int, end_ns: int, base_ns: int,
                pid: int, tid: int) -> List[dict]:
    """Chrome trace events of a span record's device frames that start
    between ``start_ns`` and ``end_ns`` (host clock): one ``svo.frame``
    span a frame and one ``svo.body.<name>`` or ``svo.stage.<name>`` span
    a body or stage that ran, on the profiler's clock (µs after ``base_ns``
    of the wall clock)."""
    clock = record["clock"]
    shift = clock["realtime_minus_host_ns"] - clock["device_minus_host_ns"]
    cols = record["device_columns"]
    spans = [c[:-3] for c in cols if c.endswith(".ns")]
    first = record["frames"] - len(record["device_rows"])
    out = []
    for k, row in enumerate(record["device_rows"]):
        t0 = row[0] - clock["device_minus_host_ns"]
        if not start_ns <= t0 <= end_ns:
            continue
        at = (row[0] + shift - base_ns) / 1e3
        args = {"frame": first + k}
        out.append({"ph": "X", "cat": "svo_span", "name": "svo.frame",
                    "pid": pid, "tid": tid, "ts": at,
                    "dur": (row[1] - row[0]) / 1e3, "args": args})
        for g in spans:
            ns = row[cols.index(f"{g}.ns")]
            if ns:
                out.append({
                    "ph": "X", "cat": "svo_span", "name": g,
                    "pid": pid, "tid": tid, "args": args, "dur": ns / 1e3,
                    "ts": at + row[cols.index(f"{g}.at")] / 1e3})
    return out


@contextlib.contextmanager
def trace(logdir: str = "build/svo_trace"):
    """Profile a block: ``with trace(d): run()`` writes ``d/trace.json``
    (host activity, and the card's where there is one), with the device
    frame and body spans of the graphed steps alive at its end, one track
    a step (``svo spans: <kind> step <i>``), for the frames that began in
    the block."""
    from torch.profiler import ProfilerActivity, profile

    from ..engine import graphed

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    t0 = time.perf_counter_ns()
    try:
        yield logdir
    finally:
        t1 = time.perf_counter_ns()
        prof.stop()
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        pid = os.getpid()
        for i, spans in enumerate(graphed.live_spans()):
            record = spans.record()
            tid = 1 << 30 | i
            doc["traceEvents"].append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": f"svo spans: {record['kind']} step {i}"}})
            doc["traceEvents"].extend(span_events(
                record, t0, t1, doc.get("baseTimeNanoseconds", 0), pid, tid))
        with open(path, "w") as f:
            json.dump(doc, f)


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
