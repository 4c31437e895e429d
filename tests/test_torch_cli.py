"""The port's command-line app on the synthetic dataset with
``--device cpu``, at the small camera of tests/test_torch_ops.py (handed
over as a flat calibration file), and the overlay dumps. The slow mirror
runs the reference's CLI on the same seed.
"""

import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("yaml")

from stereo_svo_tpu_torch import cli
from stereo_svo_tpu_torch.config import CameraConfig, SvoConfig
from stereo_svo_tpu_torch.engine import runner
from stereo_svo_tpu_torch.io import synthetic, trajectory

# one intra-op thread: the tier-1 run's parallel workers already fill the
# cores, and oversubscribed torch threads slow every small op ~100×
torch.set_num_threads(1)

SMALL = ("fx: 240.0\nfy: 240.0\ncx: 188.0\ncy: 120.0\nbaseline: 0.11\n"
         "width: 376\nheight: 240\ngrid_rows: 10\ngrid_cols: 13\n"
         "max_features: 130\nnum_levels: 3\nalign_levels: 3\nklt_levels: 3\n"
         "stereo_max_disp: 64\nkf_min_tracked: 40\nborder_margin: 10\n")
SUMMARY_KEYS = {"frames", "fps", "keyframes", "tracking_ok_frac",
                "mean_tracked", "loop_edges", "out", "ate_rmse_m",
                "rpe_t_m", "rpe_r_rad"}


def _run(main, tmp_path, capsys, *extra, frames=8):
    calib = tmp_path / "small.yaml"
    calib.write_text(SMALL)
    out = tmp_path / "traj.txt"
    main(["--dataset", "synthetic", "--frames", str(frames), "--calib",
          str(calib), "--out", str(out), *extra])
    captured = capsys.readouterr()
    return json.loads(captured.out.strip().splitlines()[-1]), out, captured


def test_cli_synthetic_run(tmp_path, capsys):
    metrics = tmp_path / "metrics.json"
    summary, out, _ = _run(cli.main, tmp_path, capsys, "--device", "cpu",
                           "--metrics-out", str(metrics))
    assert set(summary) == SUMMARY_KEYS
    assert summary["frames"] == 8 and summary["out"] == str(out)
    assert summary["tracking_ok_frac"] == 1.0 and summary["keyframes"] >= 1
    assert summary["ate_rmse_m"] < 0.02 and summary["loop_edges"] == 0
    assert len(open(out).readlines()) == 8
    ts, pos = trajectory.load_tum(str(out))
    np.testing.assert_allclose(ts, np.arange(8) * 0.1, atol=1e-6)
    assert pos.shape == (8, 3)
    doc = json.load(open(metrics))
    assert doc["summary"] == summary
    assert len(doc["tracking_ok"]) == 8 and len(doc["ba_diag"][0]) == 7
    assert sum(doc["kf_inserted"]) == summary["keyframes"]


def test_cli_progress_line_reads_no_device_value(tmp_path, capsys):
    """Every 50 frames the CLI prints from what the host already holds."""
    summary, _, captured = _run(cli.main, tmp_path, capsys, "--device",
                                "cpu", "--max-frames", "50", frames=52)
    assert summary["frames"] == 50
    assert "frame 50:" in captured.err and "tracking ok on 50" in captured.err


@pytest.mark.parametrize("flags", [
    ("--loop-closure",), ("--online-loop", "2"), ("--format", "kitti"),
    ("--scene", "clutter", "--perturb", "--seed", "3")])
def test_cli_options(tmp_path, capsys, flags):
    summary, out, captured = _run(cli.main, tmp_path, capsys, "--device",
                                  "cpu", *flags)
    assert summary["frames"] == 8 and summary["tracking_ok_frac"] == 1.0
    lines = open(out).readlines()
    assert len(lines) == 8
    if "kitti" in flags:
        assert all(len(line.split()) == 12 for line in lines)
    else:
        assert all(len(line.split()) == 8 for line in lines)
    if "--loop-closure" in flags:
        assert "loop closure: 0 edge(s) accepted" in captured.err


def test_cli_defaults_to_the_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(cli.main, tmp_path, capsys)


def test_cli_native_loader_never_falls_back(tmp_path, monkeypatch):
    """--native-loader without a loadable library is an error, not a run
    through the Python readers."""
    from stereo_svo_tpu_torch.io import native_loader
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_load", lambda *a, **k: None)
    base = tmp_path / "sequences" / "00"
    for d in ("image_0", "image_1"):
        (base / d).mkdir(parents=True)
        (base / d / "000000.png").write_bytes(b"")
    with pytest.raises(RuntimeError, match="native frame loader"):
        cli.main(["--dataset", "kitti", "--root", str(tmp_path),
                  "--native-loader", "--device", "cpu"])


def test_profiling_helpers(tmp_path):
    """``time_fn``: the median over ``iters`` calls after ``warmup``
    (host clock on the CPU); ``trace``: a Chrome trace of the block."""
    from stereo_svo_tpu_torch.utils import profiling

    calls = []
    x = torch.ones(64, 64)

    def fn(a):
        calls.append(1)
        return a @ a

    t = profiling.time_fn(fn, x, iters=5, warmup=2)
    assert len(calls) == 7 and 0.0 < t < 1.0
    with profiling.trace(str(tmp_path / "trace")) as logdir:
        fn(x)
    doc = json.load(open(os.path.join(logdir, "trace.json")))
    assert doc["traceEvents"]


def test_viz_dumps(tmp_path):
    pytest.importorskip("cv2")
    from stereo_svo_tpu_torch.utils import viz

    cfg = SvoConfig(
        camera=CameraConfig(fx=160.0, fy=160.0, cx=94.0, cy=60.0,
                            baseline=0.11, width=188, height=120),
        grid_rows=6, grid_cols=8, max_features=48, num_levels=3,
        align_levels=3, klt_levels=2, stereo_max_disp=32,
        kf_min_tracked=15, border_margin=8, max_keyframes=4)
    lefts, rights, gt = synthetic.make_sequence(cfg.camera, 3, kind="arc",
                                                device="cpu")
    svo = runner.StereoSvo(cfg, device="cpu")
    for l, r in zip(lefts, rights):
        svo.new_image(l, r)
    f = str(tmp_path / "overlay.png")
    vis = viz.draw_features(lefts[-1], svo.state, path=f)
    assert vis.shape == (120, 188, 3) and os.path.getsize(f) > 0
    t = str(tmp_path / "traj.png")
    canvas = viz.draw_trajectory(svo.trajectory(), gt=gt, path=t)
    assert canvas.shape == (600, 600, 3) and os.path.getsize(t) > 0
    assert (canvas != 255).any()


@pytest.mark.slow  # a whole JAX CLI run (compile and 24 frames) beside
                   # the quick cases that already cover the port's CLI
def test_cli_matches_the_reference_cli(tmp_path, capsys):
    """Same seed, same flags: the reference's CLI and the port's agree on
    the frame and keyframe counts and, within float32 drift over 24
    frames, on the accuracy."""
    from stereo_svo_tpu import cli as jcli
    ours, out, _ = _run(cli.main, tmp_path, capsys, "--device", "cpu",
                        frames=24)
    ref, jout, _ = _run(jcli.main, tmp_path, capsys, frames=24)
    assert set(ours) == set(ref)
    for key in ("frames", "keyframes", "tracking_ok_frac", "loop_edges"):
        assert ours[key] == ref[key], key
    # both well under the 0.02 m gate and within 1 mm of each other
    assert ours["ate_rmse_m"] < 0.02 and ref["ate_rmse_m"] < 0.02
    assert abs(ours["ate_rmse_m"] - ref["ate_rmse_m"]) < 1e-3
    assert abs(ours["mean_tracked"] - ref["mean_tracked"]) < 3.0
