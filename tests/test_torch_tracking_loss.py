"""The paths a run takes only when tracking fails or the keyframe bank
wraps, against the JAX reference frame by frame: the rotated
relocalisation variants, anchoring at the relocalisation keyframe, velocity
halving and keyframe probation (mirrors of tests/test_engine.py's two
blackout tests), and a memory bank far smaller than the keyframe count
under both retention policies (mirror of tests/test_mem_retention.py's
end-to-end test).

Both packages see the same frames (the JAX renderer's) at 376×240, JAX on
the CPU and the port with ``device="cpu"``. The decisions — ``tracking_ok``
and the keyframe flag of every frame, the stamps the bank retains — must be
equal; poses agree within 2e-4 m, the short-horizon tolerance of
tests/test_torch_engine.py (measured on these runs: 4.2e-5 m at most over
the 30-frame arc, 2.9e-5 over the 48-frame loop; float32 differences of the
Gauss-Newton chains compound slowly while the decisions stay the same).
"""

import dataclasses

import numpy as np
import pytest
import torch

from stereo_svo_tpu.backend import loop_closure as jloop
from stereo_svo_tpu.config import CameraConfig as JCam
from stereo_svo_tpu.config import SvoConfig as JCfg
from stereo_svo_tpu.engine import runner as jrunner
from stereo_svo_tpu.io import synthetic as jsynth
from stereo_svo_tpu_torch.backend import loop_closure
from stereo_svo_tpu_torch.config import CameraConfig, SvoConfig
from stereo_svo_tpu_torch.engine import runner

# one intra-op thread: the tier-1 run's parallel workers already fill the
# cores, and oversubscribed torch threads slow every small op ~100×
torch.set_num_threads(1)

CAM_KW = dict(fx=240.0, fy=240.0, cx=188.0, cy=120.0, baseline=0.11,
              width=376, height=240)
CFG_KW = dict(grid_rows=10, grid_cols=13, max_features=130, num_levels=3,
              align_levels=3, klt_levels=3, stereo_max_disp=64,
              kf_min_tracked=40, border_margin=10)
BANK_KW = dict(grid_rows=8, grid_cols=10, max_features=80, num_levels=3,
               align_levels=3, klt_levels=3, stereo_max_disp=48,
               kf_min_tracked=25, border_margin=10, max_keyframes=3,
               mem_keyframes=6, kf_dist_ratio=0.02, loop_min_gap=10,
               loop_min_score=0.80)
POSE_ATOL = 2e-4

# (sequence kind, frames, dt, seed, blacked-out frames)
BLACKOUTS = {
    "arc": ("arc", 30, 0.12, 0, (6, 7)),
    "loop": ("loop", 48, 0.25, 1, (20, 21, 22)),
}


def _run_both(jcfg, cfg, lefts, rights, black=()):
    """Feed the same frames (zeros on the blacked-out ones) to the JAX
    runner and the port's; both runners and their per-frame metrics."""
    jsvo = jrunner.StereoSvo(jcfg)
    svo = runner.StereoSvo(cfg, device="cpu")
    zeros = np.zeros_like(lefts[0])
    for i, (l, r) in enumerate(zip(lefts, rights)):
        if i in black:
            l, r = zeros, zeros
        jsvo.new_image(l, r)
        svo.new_image(l, r)
    return jsvo, svo


@pytest.fixture(scope="module", params=list(BLACKOUTS))
def blackout(request):
    kind, n, dt, seed, black = BLACKOUTS[request.param]
    jcfg = JCfg(camera=JCam(**CAM_KW), **CFG_KW)
    cfg = SvoConfig(camera=CameraConfig(**CAM_KW), **CFG_KW)
    lefts, rights, gt = jsynth.make_sequence(jcfg.camera, n, dt=dt,
                                             kind=kind, seed=seed)
    jsvo, svo = _run_both(jcfg, cfg, lefts, rights, black)
    return dict(name=request.param, black=black, gt=gt, jsvo=jsvo, svo=svo,
                jm=jsvo.metrics(), m=svo.metrics(),
                jtraj=np.asarray(jsvo.trajectory()), traj=svo.trajectory())


def test_blackout_is_flagged_and_recovered_as_in_the_reference(blackout):
    """``tracking_ok`` false exactly on the blacked-out frames, true on
    the next real frame, and equal to the JAX run on every frame."""
    ok, jok = blackout["m"]["tracking_ok"], np.asarray(
        blackout["jm"]["tracking_ok"])
    np.testing.assert_array_equal(ok, jok)
    expected = np.ones(len(ok), bool)
    expected[list(blackout["black"])] = False
    np.testing.assert_array_equal(ok, expected)


def test_blackout_keyframes_as_in_the_reference(blackout):
    """The same keyframe decision on every frame: none on a failed frame
    nor during the probation after it."""
    kf = blackout["m"]["kf_inserted"]
    np.testing.assert_array_equal(kf, np.asarray(
        blackout["jm"]["kf_inserted"]))
    assert not kf[list(blackout["black"])].any()
    assert kf.sum() >= 2


def test_blackout_poses_follow_the_reference(blackout):
    traj, jtraj = blackout["traj"], blackout["jtraj"]
    assert np.isfinite(traj).all(), "poses must never go non-finite"
    err = np.linalg.norm(traj[:, :, 3] - jtraj[:, :, 3], axis=1)
    assert err.max() < POSE_ATOL, (err.max(), int(err.argmax()))
    np.testing.assert_allclose(traj, jtraj, atol=POSE_ATOL)
    for name in ("n_tracked", "n_landmarks", "n_seeds"):
        diff = np.abs(blackout["m"][name].astype(int)
                      - np.asarray(blackout["jm"][name]).astype(int))
        assert diff.max() <= 2, (name, diff.max())


def test_blackout_keeps_the_map_and_recovers_accurately(blackout):
    """tests/test_engine.py's own requirements, on the port: the failed
    frames do not destroy the map, and after recovery the run is locked to
    the same map (tail error under 0.1 m against the ground truth)."""
    svo, jsvo, gt = blackout["svo"], blackout["jsvo"], blackout["gt"]
    np.testing.assert_array_equal(svo.state.status.numpy() > 0,
                                  np.asarray(jsvo.state.status) > 0)
    if blackout["name"] == "loop":
        tail = np.linalg.norm(blackout["traj"][30:, :, 3] - gt[30:, :, 3],
                              axis=1)
        jtail = np.linalg.norm(blackout["jtraj"][30:, :, 3]
                               - gt[30:, :, 3], axis=1)
        assert tail.max() < 0.1, tail.max()
        assert abs(tail.mean() - jtail.mean()) < POSE_ATOL
    assert int(svo.state.n_loop_closures) == 0


def _bank_run(policy, online):
    kw = dict(BANK_KW, mem_retention=policy, online_loop_every=online)
    jcfg = JCfg(camera=JCam(**CAM_KW), **kw)
    cfg = SvoConfig(camera=CameraConfig(**CAM_KW), **kw)
    lefts, rights, gt = jsynth.make_sequence(jcfg.camera, 30, dt=0.2,
                                             kind="loop", seed=1)
    jsvo, svo = _run_both(jcfg, cfg, lefts, rights)
    return jcfg, cfg, jsvo, svo


def _check_bank(policy, online):
    jcfg, cfg, jsvo, svo = _bank_run(policy, online)
    st, jst = svo.state, jsvo.state
    m, jm = svo.metrics(), jsvo.metrics()
    np.testing.assert_array_equal(m["tracking_ok"],
                                  np.asarray(jm["tracking_ok"]))
    np.testing.assert_array_equal(m["kf_inserted"],
                                  np.asarray(jm["kf_inserted"]))
    assert int(st.mem_next) == int(jst.mem_next) > cfg.mem_keyframes
    np.testing.assert_array_equal(st.mem_valid.numpy(),
                                  np.asarray(jst.mem_valid))
    np.testing.assert_array_equal(st.mem_stamp.numpy(),
                                  np.asarray(jst.mem_stamp))
    stamps = st.mem_stamp.numpy()[st.mem_valid.numpy()]
    if policy == "coverage":
        assert stamps.min() == 0           # the map origin is never evicted
    else:
        assert stamps.min() > 0            # a FIFO ring forgets the start
    assert int(st.n_loop_closures) == int(jst.n_loop_closures)
    traj, jtraj = svo.trajectory(), np.asarray(jsvo.trajectory())
    np.testing.assert_allclose(traj, jtraj, atol=POSE_ATOL)
    # the retained bank still supports offline loop closing, as the
    # reference's: the same edge count and the refined poses
    ref_traj, _, ref_edges = jloop.refine_trajectory(jcfg, jst, jtraj)
    new_traj, _, n_edges = loop_closure.refine_trajectory(cfg, st, traj)
    assert n_edges == int(ref_edges)
    assert np.isfinite(new_traj).all()
    np.testing.assert_allclose(new_traj, np.asarray(ref_traj),
                               atol=POSE_ATOL)


@pytest.mark.parametrize("policy", ["coverage", "fifo"])
def test_wrapped_bank_retains_the_reference_stamps(policy):
    _check_bank(policy, online=0)


@pytest.mark.slow  # two more JAX compiles (~20 s each) for the same bank
@pytest.mark.parametrize("policy", ["coverage", "fifo"])
def test_wrapped_bank_under_the_online_loop(policy):
    _check_bank(policy, online=1)
