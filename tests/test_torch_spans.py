"""The graphed steps' spans (``engine/graphed._Spans``, the stamp nodes of
``csrc/frame_graph.cu``, the export of ``utils/profiling.py``).

On the CPU the frame graph's plain version stamps the same table on the
host clock. Over a bootstrap, tracked frames, failed frames and a keyframe
of the single step (tests/test_torch_graphed.py's frames) and of the
batched step (tests/test_torch_graphed_batched.py's): the bodies each
ring row shows ran are those whose ``replays`` moved on that frame, and
the table's runs are ``replays``; every body's span lies inside its
frame's; the host ring has a row for every device row; the ring wraps at
its length; the record round-trips through JSON with every field; and
``svo.step`` / ``svo.step.launch`` are profiler ranges only while a
profiler is on.

Stages and counters: with the epipolar search on, every track body holds
an ``svo.stage.epi`` span and every keyframe body an ``svo.stage.ba``
span, each inside its body's, and the frame's row holds the step's
``n_epi_recovered`` and the keyframes window BA ran over; a configuration
without the stage has neither its columns nor its stamps, and the batched
step has none.

The ``cuda`` tests (skipped without a card) check the same on the card,
and that each exported frame span starts within 100 µs of the profiler's
record of that frame's B1 kernel: ``python -m pytest --noconftest -m cuda
tests/test_torch_spans.py``.
"""

import dataclasses
import json
import os

import pytest
import torch

from stereo_svo_tpu_torch.engine import graphed
from stereo_svo_tpu_torch.utils import profiling
from test_torch_graphed import CFG, _frames
import test_torch_graphed_batched as tgb

torch.set_num_threads(1)

SINGLE_FRAMES = 10      # boot, tracked, blackout 6-7, A_fail 7-8, K at 9
BATCH_FRAMES = 9        # boot, tracked, A_fail at 7-8, K at 8
B1 = "pyramid_levels_kernel"


def _drive(step, lefts, rights):
    """Run the frames; per frame the bodies whose ``replays`` moved (each
    by one at most), and the step's record after the last frame."""
    ran, before = [], step.replays
    for i in range(len(lefts)):
        step(step.state, lefts[i], rights[i])
        now = step.replays
        assert all(0 <= now[g] - before[g] <= 1 for g in now), (
            i, before, now)
        ran.append({g for g in now if now[g] > before[g]})
        before = now
    return ran, step.spans()


def _single(device):
    lefts, rights, _ = _frames(device)
    step = graphed.make_graphed_step(CFG, device)
    ran, record = _drive(step, lefts[:SINGLE_FRAMES],
                         rights[:SINGLE_FRAMES])
    return step, ran, record


def _batched(device):
    lefts, rights = tgb._frames(device)
    step = graphed.make_graphed_batched_step(CFG, len(tgb.SEQS), device)
    ran, record = _drive(step, lefts[:, :BATCH_FRAMES].transpose(0, 1),
                         rights[:, :BATCH_FRAMES].transpose(0, 1))
    return step, ran, record


@pytest.fixture(scope="module", params=["single", "batched"])
def driven(request):
    return (_single if request.param == "single" else _batched)("cpu")


def _column(record, name):
    return record["device_columns"].index(name)


def _check_runs(step, ran, record):
    """Ring rows against ``replays``, frame for frame; the table's runs
    and nanoseconds against ``replays`` and the rows."""
    rows = record["device_rows"]
    assert record["frames"] == record["launches"] == len(rows) == len(ran)
    for row, bodies in zip(rows, ran):
        shown = {g for g in record["bodies"]
                 if row[_column(record, f"svo.body.{g}.ns")] > 0}
        assert shown == bodies
    replays = step.replays
    assert record["runs"] == {g: replays[g] for g in record["bodies"]}
    for g in record["bodies"]:
        assert record["ns"][g] == sum(
            row[_column(record, f"svo.body.{g}.ns")] for row in rows)
    # every branch: the bootstrap, tracked and failed frames, a keyframe
    assert ran[0] == {"P", "flags", "boot"}
    assert {"A_ok", "A_fail", "K", "B"} <= set().union(*ran[1:])


def _check_nesting(record):
    """Each body inside its frame; frames in order; a host row (the call
    around the launch) for every device row."""
    rows, host = record["device_rows"], record["host_rows"]
    assert len(host) == len(rows)
    for row in rows:
        assert row[0] < row[1]
        for g in record["bodies"]:
            ns = row[_column(record, f"svo.body.{g}.ns")]
            at = row[_column(record, f"svo.body.{g}.at")]
            assert ns >= 0 and at >= 0 and at + ns <= row[1] - row[0]
    for a, b in zip(rows, rows[1:]):
        assert a[1] <= b[0]
    for h in host:
        assert h[0] <= h[2] <= h[3] <= h[1]
    for a, b in zip(host, host[1:]):
        assert a[1] <= b[0]


def test_ring_rows_are_the_replays_frame_for_frame(driven):
    _check_runs(*driven)


def test_every_body_lies_inside_its_frame(driven):
    _, _, record = driven
    _check_nesting(record)
    # the plain version stamps the host clock: each frame inside its call
    for row, h in zip(record["device_rows"], record["host_rows"]):
        assert h[2] <= row[0] < row[1] <= h[3]


def test_the_record_round_trips_through_json(driven, tmp_path):
    """What a dropped step on the card writes, one line a record, the
    file truncated at the process's first write."""
    step, _, record = driven
    path = tmp_path / "spans.jsonl"
    path.write_text("stale\n")
    profiling.write_spans(step.spans, path)
    profiling.write_spans(step.spans, path)
    lines = path.read_text().splitlines()
    assert len(lines) == 2
    back = json.loads(lines[-1])
    assert back == json.loads(json.dumps(record))
    assert set(back) == {"kind", "batch", "bodies", "runs", "ns", "frames",
                         "launches", "ring", "device_columns",
                         "device_rows", "host_columns", "host_rows",
                         "clock"}
    assert back["kind"] == ("single" if back["batch"] == 1 else "batched")
    assert back["bodies"] == list(step.graph_names)
    assert set(back["clock"]) == {"host", "device_minus_host_ns",
                                  "realtime_minus_host_ns",
                                  "calibration_ns"}


def test_a_failed_write_warns_once_and_does_not_raise(tmp_path):
    def broken():
        raise RuntimeError("no device")
    profiling._warned.clear()
    with pytest.warns(UserWarning, match="spans not written"):
        profiling.write_spans(broken, tmp_path / "a.jsonl")
    profiling.write_spans(broken, tmp_path / "a.jsonl")    # silent
    assert not (tmp_path / "a.jsonl").exists()


def test_the_ring_wraps(monkeypatch):
    """With a ring of 4 rows, 6 frames keep the last 4, oldest first; the
    runs and the nanoseconds count all 6."""
    monkeypatch.setattr(graphed, "RING", 4)
    lefts, rights, _ = _frames()
    step = graphed.make_graphed_step(CFG, "cpu")
    ran, record = _drive(step, lefts[:6], rights[:6])
    rows = record["device_rows"]
    assert record["ring"] == 4 and record["frames"] == 6
    assert len(rows) == len(record["host_rows"]) == 4
    assert [r[0] < s[0] for r, s in zip(rows, rows[1:])] == [True] * 3
    for row, bodies in zip(rows, ran[2:]):
        assert {g for g in record["bodies"]
                if row[_column(record, f"svo.body.{g}.ns")]} == bodies
    assert record["runs"]["P"] == 6 and record["runs"]["boot"] == 1
    assert record["ns"]["P"] > sum(
        r[_column(record, "svo.body.P.ns")] for r in rows)
    _check_nesting(record)


def test_profiler_ranges_only_under_a_profiler(monkeypatch, tmp_path):
    """No ``record_function`` is made without a profiler; under
    ``profiling.trace()`` the Chrome trace holds ``svo.step`` and
    ``svo.step.launch`` once a frame, and the frame's ``svo.frame`` and
    ``svo.body.*`` spans inside its launch."""
    made = []
    real = torch.profiler.record_function

    def counted(name, *args):
        made.append(name)
        return real(name, *args)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    lefts, rights, _ = _frames()
    step = graphed.make_graphed_step(CFG, "cpu")
    step(step.state, lefts[0], rights[0])
    assert made == []
    with profiling.trace(str(tmp_path)) as logdir:
        for i in (1, 2):
            step(step.state, lefts[i], rights[i])
    assert made == ["svo.step", "svo.step.launch"] * 2
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    named = {}
    for e in events:
        if e.get("ph") == "X" and str(e.get("name", "")).startswith("svo."):
            named.setdefault(e["name"], []).append(e)
    assert len(named["svo.step"]) == len(named["svo.step.launch"]) == 2
    assert len(named["svo.frame"]) == 2
    assert len(named["svo.body.A_ok"]) == len(named["svo.body.B"]) == 2
    for launch, frame in zip(sorted(named["svo.step.launch"],
                                    key=lambda e: e["ts"]),
                             sorted(named["svo.frame"],
                                    key=lambda e: e["ts"])):
        slack = 50.0       # µs: the clocks' offsets, read apart
        assert launch["ts"] - slack <= frame["ts"]
        assert (frame["ts"] + frame["dur"]
                <= launch["ts"] + launch["dur"] + slack)


# --- stages and counters ---

EPI_CFG = dataclasses.replace(CFG, epi_samples=16)
STAGE_COLUMNS = ("svo.stage.epi.ns", "svo.stage.epi.at", "svo.stage.ba.ns",
                 "svo.stage.ba.at", "svo.count.epi_recovered",
                 "svo.count.ba_keyframes")


def _staged(device):
    """SINGLE_FRAMES frames of EPI_CFG's graphed step: per frame the
    bodies that ran and the FrameOut's ``n_epi_recovered`` and
    ``kf_inserted``; the step's record."""
    lefts, rights, _ = _frames(device)
    step = graphed.make_graphed_step(EPI_CFG, device)
    ran, before, epi, kf = [], step.replays, [], []
    for i in range(SINGLE_FRAMES):
        _, out = step(step.state, lefts[i], rights[i])
        now = step.replays
        ran.append({g for g in now if now[g] > before[g]})
        before = now
        epi.append(int(out.n_epi_recovered))
        kf.append(bool(out.kf_inserted))
    return step, ran, epi, kf, step.spans()


def _check_stages(ran, epi, kf, record):
    """Each stage runs exactly in the frames whose body holds it and lies
    inside that body's span; the counters are the FrameOut's recoveries
    and the window's keyframes, in the frames they belong to."""
    col = {c: _column(record, c) for c in record["device_columns"]}
    assert all(c in col for c in STAGE_COLUMNS)
    window = 0
    for row, bodies, n_epi, is_kf in zip(record["device_rows"], ran, epi,
                                         kf):
        window = min(window + is_kf, EPI_CFG.max_keyframes)
        for stage, holders in (("epi", ("A_ok", "A_fail")),
                               ("ba", ("K", "K_loop"))):
            ns = row[col[f"svo.stage.{stage}.ns"]]
            at = row[col[f"svo.stage.{stage}.at"]]
            body = [g for g in holders if g in bodies]
            assert (ns > 0) == bool(body), (stage, bodies, ns)
            if body:
                b_ns = row[col[f"svo.body.{body[0]}.ns"]]
                b_at = row[col[f"svo.body.{body[0]}.at"]]
                assert b_at <= at and at + ns <= b_at + b_ns
        tracked = bool({"A_ok", "A_fail"} & bodies)
        assert row[col["svo.count.epi_recovered"]] == (n_epi if tracked
                                                       else 0)
        ran_ba = bool({"K", "K_loop"} & bodies)
        assert row[col["svo.count.ba_keyframes"]] == (window if ran_ba
                                                      else 0)
    # the frames hold every branch, and the search recovered seeds
    assert ran[0] == {"P", "flags", "boot"} and any(kf[1:])
    assert {"A_ok", "A_fail"} <= set().union(*ran) and sum(epi) > 0


def test_stage_spans_and_counters_fill_on_the_cpu():
    _, ran, epi, kf, record = _staged("cpu")
    _check_stages(ran, epi, kf, record)
    _check_nesting(record)


@pytest.mark.parametrize("kw, kept", [
    ({}, ("svo.stage.ba.ns", "svo.stage.ba.at", "svo.count.ba_keyframes")),
    ({"use_ba": False}, ()),
    ({"epi_samples": 16, "use_ba": False},
     ("svo.stage.epi.ns", "svo.stage.epi.at", "svo.count.epi_recovered")),
], ids=["no_epi", "neither", "no_ba"])
def test_a_stage_the_configuration_does_not_run_has_no_columns(kw, kept):
    """Without the epipolar search (``epi_samples=0``, the EuRoC
    configuration) no epi column, without window BA no BA column; the
    batched step keeps none."""
    cfg = dataclasses.replace(CFG, **kw)
    lefts, rights, _ = _frames()
    step = graphed.make_graphed_step(cfg, "cpu")
    for i in range(3):
        step(step.state, lefts[i], rights[i])
    cols = step.spans()["device_columns"]
    assert tuple(c for c in cols if c in STAGE_COLUMNS) == kept
    assert len(step.spans()["device_rows"][0]) == len(cols)
    bstep = graphed.make_graphed_batched_step(cfg, 2, "cpu")
    assert not any(c.startswith(("svo.stage.", "svo.count."))
                   for c in bstep.spans()["device_columns"])


def test_stages_stamp_nothing_outside_a_graphed_step():
    """The eager step (the plain version the tests hold the graphed one
    to) runs the same phases with no span table: stage() and count() do
    nothing there."""
    from stereo_svo_tpu_torch.engine import step as step_mod
    from stereo_svo_tpu_torch.engine.state import init_state
    calls = []

    class Spy:
        stages, counters = ("epi", "ba"), ("epi_recovered", "ba_keyframes")

        def open(self, name):
            calls.append(name)

        close = open

        def count(self, name, value):
            calls.append(name)
    lefts, rights, _ = _frames()
    eager = step_mod.make_step(EPI_CFG)
    st, flags = init_state(EPI_CFG, "cpu"), None
    for i in range(3):
        st, _, flags = eager(st, lefts[i], rights[i], flags)
    assert calls == []
    with profiling.stages(Spy()):
        st, _, flags = eager(st, lefts[3], rights[3], flags)
    assert calls == ["epi", "epi", "epi_recovered"]


# --- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("make", [_single, _batched],
                         ids=["single", "batched"])
def test_cuda_spans_are_the_replays(cuda_device, make):
    """On the card: the stamp nodes' ring rows against ``replays`` frame
    for frame, each body inside its frame, a host row a device row, and
    the calibration's two host reads within a millisecond."""
    step, ran, record = make(cuda_device)
    _check_runs(step, ran, record)
    _check_nesting(record)
    assert 0 < record["clock"]["calibration_ns"] < 1_000_000


@pytest.mark.cuda
def test_cuda_frame_spans_meet_the_profilers_b1(cuda_device, tmp_path):
    """Each exported frame span starts within 100 µs of the profiler's
    record of that frame's first kernel, B1 (the pyramid), which the
    frame graph runs right after its start stamp and P's."""
    lefts, rights, _ = _frames(cuda_device)
    step = graphed.make_graphed_step(CFG, cuda_device)
    for i in range(3):
        step(step.state, lefts[i], rights[i])
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)) as logdir:
        for i in range(3, 9):
            step(step.state, lefts[i], rights[i])
        torch.cuda.synchronize()
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    frames = [e for e in events if e.get("name") == "svo.frame"]
    b1 = [e["ts"] for e in events
          if e.get("cat") == "kernel" and B1 in e.get("name", "")]
    assert len(frames) == 6 and len(b1) >= 4
    gaps = [min(abs(t - f["ts"]) for f in frames) for t in b1]
    assert max(gaps) < 100.0, gaps


@pytest.mark.cuda
def test_cuda_stage_spans_and_counters(cuda_device):
    """On the card: the stage stamps and counters, kernel nodes of the
    track and keyframe bodies' own graphs, fill the same columns as the
    plain version does."""
    step, ran, epi, kf, record = _staged(cuda_device)
    _check_stages(ran, epi, kf, record)
    _check_nesting(record)
