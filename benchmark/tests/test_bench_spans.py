"""The span readers (``device.frame_busy_share``,
``tracking.device_us_per_step``, ``keyframe.device_us_per_run``,
``runner.launch_us_per_step``) on a synthetic export written where the
program writes its own, this process's ``build/svo_trace/spans-<pid>.jsonl``:
the window's rows picked with and without the traced ones, None where
there is nothing to read, and each value against sums by hand."""

import json
import os
import types
from pathlib import Path

import pytest

from svobench import layers

ROOT = Path(__file__).resolve().parents[2]
BODIES = ["P", "flags", "boot", "A_ok", "A_fail", "K", "B"]
READERS = ("device.frame_busy_share", "tracking.device_us_per_step",
           "keyframe.device_us_per_run", "runner.launch_us_per_step")


def _row(k, ns):
    """Device row of frame k: it starts at 10,000 k and lasts 6,000 + k;
    body g lasts ns[g] and starts 10 after the frame."""
    start = 10_000 * k
    return ([start, start + 6_000 + k]
            + [ns.get(g, 0) for g in BODIES]
            + [10 if ns.get(g) else 0 for g in BODIES])


def _record(n, kf_at=()):
    """An export of n frames: A_ok takes 1,000 + k ns in frame k (A_fail
    instead on frame 1), K 3,000 + k on the frames ``kf_at``; the launch
    of frame k takes 100 + k host ns."""
    rows, host = [], []
    for k in range(n):
        ns = {"P": 50, "flags": 5, "B": 200,
              "A_fail" if k == 1 else "A_ok": 1_000 + k}
        if k in kf_at:
            ns["K"] = 3_000 + k
        rows.append(_row(k, ns))
        host.append([7 * k, 7 * k + 500, 7 * k + 50, 7 * k + 150 + k])
    return {
        "kind": "single", "batch": 1, "bodies": BODIES,
        "device_columns": (["svo.frame.start", "svo.frame.end"]
                           + [f"svo.body.{g}.ns" for g in BODIES]
                           + [f"svo.body.{g}.at" for g in BODIES]),
        "device_rows": rows,
        "host_columns": ["svo.step.start", "svo.step.end",
                         "svo.step.launch.start", "svo.step.launch.end"],
        "host_rows": host}


@pytest.fixture
def export():
    """Write records as this process's export (the last one counts)."""
    path = ROOT / "build" / "svo_trace" / f"spans-{os.getpid()}.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    saved = path.read_bytes() if path.exists() else None

    def write(*records):
        path.write_text("".join(json.dumps(r) + "\n" for r in records))
    if path.exists():
        path.unlink()
    yield write
    if saved is None:
        path.unlink(missing_ok=True)
    else:
        path.write_bytes(saved)


def _ctx(runner_steps, slice_steps):
    return types.SimpleNamespace(layer={"runner_steps": runner_steps,
                                        "slice_steps": slice_steps})


def _read(name, ctx):
    return layers.reader(name).read(ctx)


@pytest.mark.parametrize("name", READERS)
def test_no_export_reads_none(export, name):
    assert _read(name, _ctx(5, 3)) is None


def test_window_left_of_the_traced_rows(export):
    """20 frames: the last 1 + 3 traced, the 5 before them (frames 11–15)
    the window's; an earlier line of the file is not read."""
    export(_record(4), _record(20))
    w = layers.reader("device.frame_busy_share").window(_ctx(5, 3))
    assert [r[0] // 10_000 for r in w[1]] == [11, 12, 13, 14, 15]
    assert [r[0] // 7 for r in w[2]] == [11, 12, 13, 14, 15]


def test_window_without_traced_rows(export):
    export(_record(20))
    w = layers.reader("device.frame_busy_share").window(_ctx(5, 0))
    assert [r[0] // 10_000 for r in w[1]] == [15, 16, 17, 18, 19]


def test_a_ring_shorter_than_the_window_gives_what_it_holds(export):
    """The ring kept 10 frames of a 100-step window and 4 traced: the 6
    window frames it holds."""
    export(_record(10))
    w = layers.reader("device.frame_busy_share").window(_ctx(100, 3))
    assert [r[0] // 10_000 for r in w[1]] == [0, 1, 2, 3, 4, 5]


def test_values_from_sums_by_hand(export):
    """Window frames 1–5 of 10 (4 traced): K ran on frames 3 and 8."""
    export(_record(10, kf_at=(3, 8)))
    ctx = _ctx(5, 3)
    frames = range(1, 6)
    busy = sum(6_000 + k for k in frames)
    span = (10_000 * 5 + 6_005) - 10_000
    assert _read("device.frame_busy_share", ctx) == pytest.approx(
        busy / span)
    assert _read("tracking.device_us_per_step", ctx) == pytest.approx(
        sum(1_000 + k for k in frames) / 5 / 1e3)
    assert _read("keyframe.device_us_per_run", ctx) == pytest.approx(
        3.003)
    assert _read("runner.launch_us_per_step", ctx) == pytest.approx(
        sum(100 + k for k in frames) / 5 / 1e3)


def test_no_keyframe_in_the_window_reads_none(export):
    """K ran only on a traced frame: no run in the window."""
    export(_record(10, kf_at=(8,)))
    assert _read("keyframe.device_us_per_run", _ctx(5, 3)) is None
    assert _read("tracking.device_us_per_step", _ctx(5, 3)) is not None
