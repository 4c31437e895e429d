"""The pyramid's least bytes from the configuration's shapes, and the
reduction of a trace to busy time, idle gaps and kernel shares."""

import json
from pathlib import Path

import pytest

from svobench import layers, trace

BENCH = Path(__file__).resolve().parents[1]


def test_pyramid_bytes_from_the_shapes():
    m = layers.reader("pyramid_roofline")
    # 752x480, 4 levels: the frame in, three planes a level out
    assert m.pyramid_bytes(480, 752, 4) == 4 * (
        480 * 752 + 3 * (480 * 752 + 240 * 376 + 120 * 188 + 60 * 94))
    # odd KITTI sizes round down level by level
    assert m.pyramid_bytes(376, 1241, 4) == 4 * (
        376 * 1241 + 3 * (376 * 1241 + 188 * 620 + 94 * 310 + 47 * 155))
    for cfg in (BENCH / "configs").glob("*.json"):
        c = json.loads(cfg.read_text())
        assert m.pyramid_bytes(c["camera"]["height"], c["camera"]["width"],
                               c["svo"]["num_levels"]) > 0


def _summary():
    ops = [trace.Op("pyramid_levels_kernel", "kernel", 10, 4),
           trace.Op("void (anonymous namespace)::gradients_levels_kernel"
                    "<4>(float*, int)", "kernel", 12, 6),
           trace.Op("pyramid_levels_kernel_other", "kernel", 20, 1),
           trace.Op("other", "kernel", 30, 10),
           trace.Op("Memcpy DtoD", "gpu_memcpy", 45, 5)]
    host = [trace.Op("bench.slice", "user_annotation", 0, 100),
            trace.Op("bench.sync", "user_annotation", 50, 40)]
    return trace.Summary(0.0, 100.0, ops, host)


def test_busy_idle_and_gaps():
    s = _summary()
    assert s.busy_intervals() == [(10, 18), (20, 21), (30, 40), (45, 50)]
    assert s.busy_s() == pytest.approx(24e-6)
    assert s.gaps() == [(0, 10), (18, 20), (21, 30), (40, 45), (50, 100)]
    b = s.breakdown()
    assert b["idle_gaps"][0] == ["bench.sync", pytest.approx(50e-6)]
    assert b["device_ops"][0] == ["other", pytest.approx(10e-6)]


def test_readers_on_a_summary():
    s = _summary()

    class Ctx:
        summary = s
        layer = {"slice_frames": 1, "slice_steps": 1}

        class cell:
            config = {"camera": {"height": 480, "width": 752},
                      "svo": {"num_levels": 4}}
    ctx = Ctx()
    # B1 and B2 (a whole signature too, never a longer identifier)
    assert layers.reader("kernels.b1_b4_device_share").read(ctx) == \
        pytest.approx(10 / 21)
    assert layers.reader("graphed.kernels_per_step").read(ctx) == 4
    share = layers.reader("pyramid_roofline").read(ctx)
    assert share == pytest.approx(100 * 7196640 / 3.35e12 / 10e-6)
    ctx.summary = None
    for name in ("pyramid_roofline", "kernels.b1_b4_device_share",
                 "graphed.kernels_per_step"):
        assert layers.reader(name).read(ctx) is None


def test_parse_keeps_the_slice():
    t = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "bench.slice",
         "ts": 100, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 90, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 200, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 101,
         "dur": 1}]}
    s = trace.parse(t)
    assert (s.start, s.end) == (100.0, 150.0)
    assert [o.start for o in s.ops] == [90.0]
    assert s.busy_s() == pytest.approx(10e-6)
    assert trace.parse({"traceEvents": []}) is None
