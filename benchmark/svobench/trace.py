"""The traced slice: ``torch.profiler`` over a short steady stretch of the
window, and its reduction to device operations, busy and idle time.

A replayed CUDA graph's kernels are recorded only when the profiler was
already on for the frame before, so a slice is one frame in the
profiler's warm-up step, then the profiled frames. The host's calls are
marked with ``record_function`` ranges named ``bench.*``; an idle gap of
the device is named by the innermost such range that was open when the
gap began."""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "bench.slice"


class Op(NamedTuple):
    name: str
    cat: str
    start: float      # µs, the trace's clock
    dur: float        # µs


class Summary(NamedTuple):
    """What one slice's trace holds: its span (the ``bench.slice`` range),
    the device operations in it and the host's ``bench.*`` ranges."""
    start: float
    end: float
    ops: List[Op]
    host: List[Op]

    @property
    def span_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def kernels(self) -> List[Op]:
        return [o for o in self.ops if o.cat == "kernel"]

    def device_s(self, names=None) -> float:
        """Summed kernel time, of the kernels named ``names`` or of all."""
        return 1e-6 * sum(o.dur for o in self.kernels()
                          if names is None or _named(o.name, names))

    def count(self) -> int:
        return len(self.kernels())

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        span."""
        ivs = sorted((max(o.start, self.start),
                      min(o.start + o.dur, self.end)) for o in self.ops)
        out: List[Tuple[float, float]] = []
        for a, b in ivs:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return 1e-6 * sum(b - a for a, b in self.busy_intervals())

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle stretches of the span, (start, end) in µs."""
        out, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return out

    def host_at(self, t: float) -> str:
        """The innermost ``bench.*`` range open at ``t`` (the slice's own
        when none inside it is)."""
        best = None
        for h in self.host:
            if h.start <= t < h.start + h.dur and (
                    best is None or h.dur < best.dur):
                best = h
        return best.name if best is not None else "outside"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The kernels with the most device time, and the longest idle
        gaps by the host range they began in, each [name, seconds]."""
        by_name: Dict[str, float] = {}
        for o in self.kernels():
            by_name[o.name] = by_name.get(o.name, 0.0) + o.dur * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(((self.host_at(a), (b - a) * 1e-6)
                       for a, b in self.gaps()), key=lambda g: -g[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _named(name: str, names) -> bool:
    """Whether a recorded kernel name (a bare name or a whole signature)
    holds one of ``names`` as a whole identifier."""
    return any(re.search(rf"(?<![A-Za-z0-9_]){re.escape(n)}(?![A-Za-z0-9_])",
                         name) for n in names)


def parse(trace: dict) -> Optional[Summary]:
    """A Chrome trace (``export_chrome_trace``) reduced to its slice; None
    where it holds no ``bench.slice`` range."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    span = [e for e in events if e.get("name") == SLICE]
    if not span:
        return None
    start = float(span[0]["ts"])
    end = start + float(span[0]["dur"])
    ops, host = [], []
    for e in events:
        cat = e.get("cat", "")
        op = Op(e.get("name", ""), cat, float(e["ts"]), float(e.get("dur", 0)))
        if cat in DEVICE_CATS:
            if op.start < end and op.start + op.dur > start:
                ops.append(op)
        elif cat == "user_annotation" and op.name.startswith("bench."):
            host.append(op)
    return Summary(start, end, ops, host)


class Slice:
    """``with Slice() as s:`` run the warm-up frame, ``s.step()``, run the
    profiled frames inside ``s.profiled()``, ``s.step()``; then
    ``s.summary`` holds the reduced trace."""

    def __init__(self):
        self.summary: Optional[Summary] = None
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1),
            on_trace_ready=self._ready)

    def __enter__(self) -> "Slice":
        self._prof.__enter__()
        return self

    def step(self) -> None:
        self._prof.step()

    def profiled(self):
        return torch.profiler.record_function(SLICE)

    def _ready(self, prof) -> None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.summary = parse(json.load(f))
        finally:
            os.remove(path)

    def __exit__(self, *exc) -> None:
        self._prof.__exit__(*exc)


def mark(name: str):
    """A ``bench.*`` host range, for naming the device's idle gaps."""
    return torch.profiler.record_function(name)
