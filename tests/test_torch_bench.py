"""The port's benchmark entry points, bench_torch.py and
bench_kernels_torch.py, on the CPU (``device="cpu"``) at the 376×240 rig of
tests/test_torch_hard_scenes.py (130 slots, 3 levels), against the
reference's bench.py and the JAX package:

- the gate function and ``_emit`` against bench.py's on a grid of (err,
  ok, gates), ``None``s included (bench.py imports only the standard
  library at its top);
- the measuring function (a run of the frames on a graphed step, its ATE,
  RPE, keyframes, tracking share and travel) against JAX's
  ``run_sequence_scan`` and ``eval/ate`` on the same numpy frames:
  keyframe and tracking flags equal, ATE within 2e-4 m (the
  short-horizon pose tolerance of tests/test_torch_hard_scenes.py);
- each path's payload keys: bench.py's own, printed by its ``main`` with
  its rendering and timing stubbed (so its keys come from its code), less
  the tunnel-only keys and plus the port's named additions;
- the runner's frame loops (``runner.run_frames``,
  ``run_frames_batched``): two runs on one step with a reset between them
  equal a fresh ``run_sequence_scan`` (``run_sequence_batched``, B=2) bit
  for bit;
- bench_kernels_torch's rows and accounting, all finite.
"""

import json

import jax
import numpy as np
import pytest
import torch

import bench
import bench_kernels_torch
import bench_torch
import chip_smoke
from stereo_svo_tpu.config import CameraConfig as JCam
from stereo_svo_tpu.config import SvoConfig as JCfg
from stereo_svo_tpu.engine import runner as jrunner
from stereo_svo_tpu.eval import ate as jate
from stereo_svo_tpu.io import synthetic as jsynth
from stereo_svo_tpu_torch.config import CameraConfig, SvoConfig
from stereo_svo_tpu_torch.engine import graphed, runner
from stereo_svo_tpu_torch.engine.state import FrameOut

# one intra-op thread: the tier-1 run's parallel workers already fill the
# cores
torch.set_num_threads(1)

POSE_ATOL = 2e-4
N_FRAMES = 16
DT = 0.12


def rig_cfg(**kw):
    return SvoConfig(camera=CameraConfig(**chip_smoke.HARD_CAM),
                     **dict(chip_smoke.HARD_CFG, **kw))


# ---- gates ----

@pytest.mark.parametrize("gates", [(None, None), (0.25, None), (None, 0.97),
                                   (0.01, 0.995)])
@pytest.mark.parametrize("ok", [None, 1.0, 0.99, 0.9899, 0.0])
@pytest.mark.parametrize("err", [None, 0.0, 0.0199, 0.02, 0.0201, 0.3])
def test_gates_are_the_reference_gates(err, ok, gates):
    assert bench_torch._check_gates(err, ok, *gates) == \
        bench._check_gates(err, ok, *gates)


@pytest.mark.parametrize("fails", [[], ["ate_rmse 0.0300 > 0.02"],
                                   ["ate_rmse 0.0300 > 0.02",
                                    "batched tracking_ok 0.5000 < 0.99"]])
def test_emit_is_the_reference_emit(fails, capsys):
    """The same line, the same stderr, and exit 1 on a failed gate."""
    outs = []
    for emit in (bench._emit, bench_torch._emit):
        code = 0
        try:
            emit({"metric": "m", "value": 1.0}, list(fails))
        except SystemExit as e:
            code = e.code
        captured = capsys.readouterr()
        outs.append((code, captured.out, captured.err))
    assert outs[0] == outs[1]
    assert outs[0][0] == (1 if fails else 0)


# ---- the measuring function against the JAX package ----

@pytest.fixture(scope="module")
def frames():
    """JAX's rendering of the planes scene on the arc (numpy)."""
    lefts, rights, gt = jsynth.make_sequence(
        JCam(**chip_smoke.HARD_CAM), N_FRAMES, dt=DT, seed=chip_smoke.SEED)
    return np.asarray(lefts), np.asarray(rights), np.asarray(gt)


def test_measure_follows_the_reference(frames):
    lefts, rights, gt = frames
    jcfg = JCfg(camera=JCam(**chip_smoke.HARD_CAM), **chip_smoke.HARD_CFG)
    _, jouts = jax.jit(lambda a, b: jrunner.run_sequence_scan(
        jcfg, a, b))(lefts, rights)
    jtraj = np.asarray(jouts.T_wc)
    jerr = jate.ate_rmse(jate.positions(jtraj), jate.positions(gt))

    step = graphed.make_graphed_step(rig_cfg(), "cpu")
    acc, timing, outs = bench_torch.measure(step, lefts, rights, gt, runs=2)
    kf = outs.kf_inserted.numpy()
    ok = outs.tracking_ok.numpy()
    np.testing.assert_array_equal(kf, np.asarray(jouts.kf_inserted))
    np.testing.assert_array_equal(ok, np.asarray(jouts.tracking_ok))
    assert kf[1:].any(), "no keyframe after the bootstrap"
    err = np.linalg.norm(outs.T_wc.numpy()[:, :, 3] - jtraj[:, :, 3], axis=1)
    assert err.max() < POSE_ATOL
    assert abs(acc["ate_rmse_m"] - jerr) < POSE_ATOL
    assert acc["keyframes"] == int(kf.sum())
    assert acc["tracking_ok_frac"] == float(ok.mean())
    travel = np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1))
    assert acc["gt_travel_m"] == pytest.approx(travel, rel=1e-6)
    jrpe = jate.rpe(jtraj, gt)
    assert abs(acc["rpe_t_m"] - jrpe[0]) < POSE_ATOL
    assert abs(acc["rpe_r_rad"] - jrpe[1]) < POSE_ATOL
    assert timing["n_timing_runs"] == 2
    assert np.isfinite(timing["fps"]) and timing["fps"] > 0
    assert timing["capture_s"] == 0.0 and timing["sync_debug_mode"] is None


def test_render_sequence_is_make_sequence():
    """bench_torch's renderer is make_sequence's frame loop (aa = 1)."""
    from stereo_svo_tpu_torch.io import synthetic
    cam = CameraConfig(**chip_smoke.HARD_CAM)
    ours = bench_torch.render_sequence(cam, 3, perturb=True, device="cpu")
    ref = synthetic.make_sequence(cam, 3, dt=bench_torch.DT, perturb=True,
                                  device="cpu")
    for a, b in zip(ours, ref):
        assert torch.equal(a, b)


# ---- payload keys against bench.py's ----

def _stub_trajectory(n):
    t = np.arange(n) * 0.1
    T = np.tile(np.eye(3, 4), (n, 1, 1))
    T[:, 0, 3], T[:, 2, 3] = 0.3 * np.sin(t), 0.25 * t
    return T


class _Outs:
    """A FrameOut stand-in: the ground truth as the estimate."""

    def __init__(self, lead):
        self.T_wc = np.broadcast_to(_stub_trajectory(lead[-1]),
                                    lead + (3, 4)).copy()
        self.kf_inserted = np.zeros(lead, bool)
        self.kf_inserted[..., 0] = True
        self.tracking_ok = np.ones(lead, bool)


def reference_payload(path, monkeypatch, capsys):
    """bench.py's main on ``path`` with its rendering, its timing and its
    CPU baseline stubbed: the JSON line it prints."""
    import jax.numpy as jnp
    from stereo_svo_tpu.engine import runner as jr

    def render(cam, n, *a, **k):
        z = np.zeros((n, 2, 2), np.float32)
        return z, z, _stub_trajectory(n)

    def timed_median(run, l, r, n, n_valid):
        t = 0.01 * n + 0.001
        return t, [t] * n_valid, 0, _Outs(tuple(l.shape[:-2]))

    class FakeSvo:
        def __init__(self, cfg):
            self.i = 0

        def new_image(self, left, right):
            self.i += 1
            out = _Outs((self.i,))
            return type("Out", (), {
                "T_wc": jnp.asarray(out.T_wc[-1]),
                "kf_inserted": jnp.asarray(self.i % 7 == 0)})

    monkeypatch.setattr(bench, "_render_sequence", render)
    monkeypatch.setattr(bench, "_timed_median", timed_median)
    monkeypatch.setattr(bench, "_timed_chained", lambda *a, **k: 1.0)
    monkeypatch.setattr(bench, "_dispatch_roundtrip_ms", lambda: 1.0)
    monkeypatch.setattr(bench, "_cpu_baseline", lambda: 1.0)
    monkeypatch.setattr(jr, "StereoSvo", FakeSvo)
    bench.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


PATH_ENV = {"default": {"BENCH_LATENCY": "1"}, "kitti": {"BENCH_GEOM":
                                                         "kitti"},
            "stress": {"BENCH_STRESS": "1"}, "cpu": {"BENCH_MODE": "cpu"}}


@pytest.mark.parametrize("path", list(PATH_ENV))
def test_payload_keys_are_the_reference_keys(path, monkeypatch, capsys):
    for knob in ("BENCH_LATENCY", "BENCH_GEOM", "BENCH_STRESS", "BENCH_MODE",
                 "BENCH_SKIP_BATCHED", "BENCH_ONLINE_LOOP", "BENCH_SCENE",
                 "BENCH_TRAJ", "BENCH_PERTURB", "BENCH_KF_EVERY"):
        monkeypatch.delenv(knob, raising=False)
    for knob, value in PATH_ENV[path].items():
        monkeypatch.setenv(knob, value)
    ref = reference_payload(path, monkeypatch, capsys)

    assert bench_torch.select_path() == path
    monkeypatch.setattr(bench_torch, "N_FRAMES", 12)
    monkeypatch.setattr(bench_torch, "N_CPU_FRAMES", 6)
    monkeypatch.setattr(bench_torch, "N_VALID", 1)
    monkeypatch.setattr(bench_torch, "_cpu_baseline", lambda: 1.0)
    # the KITTI and stress paths on the rig too: keys, not accuracy
    configs = {"default": rig_cfg(), "kitti": rig_cfg(epi_samples=16),
               "stress": rig_cfg(align_min_level=1)}
    ours, fails = bench_torch.path_payload(path, torch.device("cpu"), configs,
                                       batch=2)
    if path != "cpu":
        ours["accuracy_gate"] = "pass"
    added = set(bench_torch.ADDED[path])
    if path == "default":
        added |= set(bench_torch.ADDED["latency"])
    assert set(ours) == (set(ref) - set(bench_torch.TUNNEL_ONLY)) | added
    assert ours["metric"] == ref["metric"]
    assert ours["device"].startswith("cpu")
    if path == "default":
        assert ours["batched8_frames"] == 10 and not fails
        assert ours["latency_device_p50_ms"] is None       # CPU: no events
        assert ours["latency_p50_ms"] > 0
    if path == "kitti":
        assert ours["scene"] == "road" and ours["traj"] == "kitti"


# ---- the runner's frame loops on a step made once ----

def _equal(a: FrameOut, b: FrameOut):
    for name, x, y in zip(FrameOut._fields, a, b):
        assert torch.equal(x, y), name


def test_run_frames_after_a_reset_replays_a_fresh_run(frames):
    lefts, rights, _ = frames
    cfg = rig_cfg()
    fresh_state, fresh = runner.run_sequence_scan(cfg, lefts[:10],
                                                  rights[:10], device="cpu")
    step = graphed.make_graphed_step(cfg, "cpu")
    seen = []
    for _ in range(2):
        step.reset()
        state, outs = runner.run_frames(step, lefts[:10], rights[:10],
                                        after_frame=seen.append)
        _equal(outs, fresh)
        for x, y in zip(state, fresh_state):
            assert torch.equal(x, y) if isinstance(x, torch.Tensor) else \
                all(torch.equal(u, v) for u, v in zip(x, y))
    assert seen == list(range(10)) * 2


def test_run_frames_batched_after_a_reset_replays_a_fresh_run(frames):
    lefts, rights, _ = frames
    lefts = np.stack([lefts[:8], lefts[2:10]])
    rights = np.stack([rights[:8], rights[2:10]])
    cfg = rig_cfg()
    _, fresh = runner.run_sequence_batched(cfg, lefts, rights, device="cpu")
    bstep = graphed.make_graphed_batched_step(cfg, 2, "cpu")
    for _ in range(2):
        bstep.reset()
        _, outs = runner.run_frames_batched(bstep, lefts, rights)
        _equal(outs, fresh)
    assert tuple(outs.T_wc.shape) == (2, 8, 3, 4)


# ---- bench_kernels_torch ----

def test_stage_table_rows_and_accounting_are_finite():
    from stereo_svo_tpu_torch.io import synthetic
    cfg = rig_cfg()
    lefts, rights, _ = synthetic.make_sequence(cfg.camera, N_FRAMES, dt=DT,
                                               device="cpu")
    out = bench_kernels_torch.stage_table(cfg, lefts, rights, at=4,
                                          device="cpu", iters=2)
    # every row of bench_kernels.py and bench_amortized.py's per-frame
    # rows (no epipolar search under this configuration)
    want = [r for r in bench_kernels_torch.ROWS if r != "epi_search_ms"]
    assert [r for r in bench_kernels_torch.ROWS if r in out] == want
    for name in want:
        row = out[name]
        assert np.isfinite(row["eager_ms"]) and row["eager_ms"] > 0, name
        assert row["graphed_ms"] is None and row["kernel_nodes"] is None
    assert out["track_frame"] >= 4 and out["kf_frame"] >= 4
    acc = out["accounting"]
    assert set(acc) == {"rows", "per_op_sum_ms", "step_nonkf_ms",
                        "intra_frame_residual_ms", "kf_phase_ms", "kf_rate",
                        "model_frame_ms", "measured_frame_ms",
                        "unaccounted_ms", "kf_phase_share_of_frame"}
    assert acc["rows"] == "eager_ms"
    assert all(np.isfinite(v) for k, v in acc.items() if k != "rows")
    for key in ("step_nonkf_ms", "scan_frame_ms", "kf_rate"):
        assert np.isfinite(out[key]) and out[key] > 0, key


def test_bench_scripts_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    """No fallback to the CPU: on a machine without CUDA both scripts
    raise unless BENCH_MODE=cpu is asked for."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for knob in ("BENCH_MODE", "BENCH_STRESS", "BENCH_GEOM"):
        monkeypatch.delenv(knob, raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_torch.main()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_kernels_torch.main([])
