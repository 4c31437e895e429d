"""The ``kitti.offline`` cell (configuration ``kitti00_1241x376``, traffic
``offline_road_kitti_10hz``) at the tests' tiny size: the reference is the
program's plain path bit for bit on its frames (the road scene, the kitti
trajectory, 2x2 anti-aliasing, the epipolar search on); a sound run is
correct and a broken one is not; the control (TF32, on a card) fails the
cell's pose limit. And the cell's two span readers,
``epipolar.device_us_per_step`` and ``ba.device_us_per_run``, on a
synthetic export: None where the program wrote no stage columns (a program
without stage spans, or a configuration without the stage), and each value
against sums by hand."""

import json

import pytest
import torch

import tiny
from svobench import correct, harness, layers, render
from test_bench_faults import altered_answer, altered_decision  # noqa: F401
from test_bench_spans import _ctx, _record, export  # noqa: F401

CELL = "kitti.offline"
READERS = ("epipolar.device_us_per_step", "ba.device_us_per_run")


def test_the_cell_runs_the_kitti_configuration():
    """The files as the cell reads them: kitti_config() field for field,
    the epipolar search on, KITTI 00's camera."""
    import dataclasses
    from stereo_svo_tpu_torch.config import kitti_config
    bench, _, tr = tiny.cell_files(CELL)
    wl = next(w for w in bench["workloads"] if w["name"] == CELL)
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cfg = json.loads((tiny.BENCH.parent / entry["file"]).read_text())
    cell = harness.Cell(CELL, cfg, tr, 0, 0.0, False, torch.device("cpu"),
                        0.0)
    assert cell.program_config() == kitti_config()
    assert dataclasses.asdict(kitti_config())["epi_samples"] == 16
    assert (tr["scene"], tr["trajectory"], tr["dt"], tr["aa"]) == (
        "road", "kitti", 0.1, 2)


def test_reference_equals_the_programs_plain_path():
    from stereo_svo_tpu_torch.engine import graphed, runner
    _, cfg, tr = tiny.cell_files(CELL)
    L, R, _ = render.render_sequence(cfg["camera"], 16, tr["dt"],
                                     tr["trajectory"], tr["scene"], 5,
                                     tr["aa"], "cpu")
    cell = harness.Cell(CELL, cfg, tr, 5, 0.0, False, torch.device("cpu"),
                        0.0)
    step = graphed.make_graphed_step(cell.program_config(), "cpu")
    _, outs = runner.run_frames(step, L, R)
    assert int(outs.n_epi_recovered.sum()) > 0     # the search works
    ref = correct.reference_run(cfg, L, R, 16, "cpu")
    got = correct.against([harness.outs_to_host(outs)], ref)
    assert got == {"pose_gap_m": 0.0, "decision_mismatches": 0}


def test_sound_run_is_correct():
    res = tiny.run(CELL)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}


def test_altered_answer_fails(altered_answer):  # noqa: F811
    res = tiny.run(CELL)
    assert not res["correct"]
    assert res["checks"]["pose_gap_m"]["value"] > \
        res["checks"]["pose_gap_m"]["limit"]


def test_altered_decision_fails(altered_decision):  # noqa: F811
    res = tiny.run(CELL)
    assert not res["correct"]
    assert res["checks"]["decision_mismatches"]["value"] > 0


@pytest.mark.cuda
def test_control_fails_the_limit():
    """TF32 in the reference's place, at the tiny size the test runs,
    three seeds: each reads a pose gap over the cell's limit."""
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 exists only on a card")
    from svobench import control
    bench, cfg, tr = tiny.cell_files(CELL)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        got = control.control_reading(bench, CELL, seed, 60,
                                      torch.device("cuda", 0), cfg, tr)
        assert got["pose_gap_m"] > tr["limits"]["pose_gap_m"], got


# --- the readers ---

def _staged(n, epi_at=(), ba_at=()):
    """_record(n) with the stage columns the kitti configuration's step
    writes: the search takes 400 + k ns in frame k of ``epi_at``, BA
    2,000 + k in frame k of ``ba_at``; the counters after them."""
    rec = _record(n, kf_at=ba_at)
    stages = ("epi", "ba")
    rec["device_columns"] = (
        rec["device_columns"][:2 + 2 * len(rec["bodies"])]
        + [f"svo.stage.{g}.ns" for g in stages]
        + [f"svo.stage.{g}.at" for g in stages]
        + ["svo.count.epi_recovered", "svo.count.ba_keyframes"])
    for k, row in enumerate(rec["device_rows"]):
        epi = 400 + k if k in epi_at else 0
        ba = 2_000 + k if k in ba_at else 0
        row += [epi, ba, 30 if epi else 0, 50 if ba else 0, 3, 4 if ba else 0]
    return rec


@pytest.mark.parametrize("name", READERS)
def test_no_stage_columns_read_none(export, name):  # noqa: F811
    """The parent's program (or EuRoC's configuration) writes no stage
    columns: nothing to read, and nothing raises."""
    export(_record(10, kf_at=(3,)))
    assert layers.reader(name).read(_ctx(5, 3)) is None


@pytest.mark.parametrize("name", READERS)
def test_no_export_reads_none(export, name):  # noqa: F811
    assert layers.reader(name).read(_ctx(5, 3)) is None


def test_values_from_sums_by_hand(export):  # noqa: F811
    """Window frames 1–5 of 10 (4 traced): the search ran in frames 2–9,
    BA in frames 3, 4 and 8."""
    export(_staged(10, epi_at=range(2, 10), ba_at=(3, 4, 8)))
    ctx = _ctx(5, 3)
    epi = layers.reader("epipolar.device_us_per_step").read(ctx)
    assert epi == pytest.approx(sum(400 + k for k in range(2, 6)) / 5 / 1e3)
    ba = layers.reader("ba.device_us_per_run").read(ctx)
    assert ba == pytest.approx((2_003 + 2_004) / 2 / 1e3)


def test_a_window_with_no_stage_run_reads_none(export):  # noqa: F811
    export(_staged(10, epi_at=(8,), ba_at=(8,)))
    for name in READERS:
        assert layers.reader(name).read(_ctx(5, 3)) is None
