"""The port over a long horizon whose keyframe bank wraps many times,
against the JAX package: mirror of tests/test_mem_retention.py:78
(``test_long_horizon_multi_loop_closure_at_scale``).

The reference test's rig (:99-107): 376×240, an 8-slot bank, a 3-keyframe
window, ``kf_dist_ratio=0.04``; 500 frames at t = 0.2·i on the ``loop``
trajectory of the ``planes`` scene, JAX's frames for both packages. JAX
runs its jitted ``run_sequence_scan`` on the CPU, the port its
``run_sequence_scan`` with ``device="cpu"``. After the run the reference's
drift event (``chip_smoke.drift_event``: D = exp([0.05, 0.02, -0.04, 0.004,
-0.006, 0.003]) on the trajectory from frame 300 and on the bank slots
stamped from 300) is applied to each package's own result, then each
package's ``refine_trajectory``.

Held: the reference test's own checks on the port's run, and parity with
the JAX run — the bank (``mem_next``, ``mem_valid``, ``mem_stamp``), the
tracking and keyframe flags of every frame and the edge count equal, the
tail errors before and after the refinement within 5 mm
(``chip_smoke.LOOP_TOL_M``), poses within 2e-4 m. Several minutes on the
CPU (the port's 500 frames ~75 s, JAX's compile, run and refinement ~65
s), so ``slow``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from stereo_svo_tpu.backend import loop_closure as jloop
from stereo_svo_tpu.config import CameraConfig as JCam
from stereo_svo_tpu.config import SvoConfig as JCfg
from stereo_svo_tpu.engine import runner as jrunner
from stereo_svo_tpu.geometry import se3 as jse3
from stereo_svo_tpu.io import synthetic as jsynth
from stereo_svo_tpu_torch.backend import loop_closure
from stereo_svo_tpu_torch.config import CameraConfig, SvoConfig
from stereo_svo_tpu_torch.engine import runner
from stereo_svo_tpu_torch.geometry import se3

pytestmark = pytest.mark.slow

# one intra-op thread: the tier-1 run's parallel workers already fill the
# cores, and oversubscribed torch threads slow every small op ~100×
torch.set_num_threads(1)

N, AT = chip_smoke.LONG_FRAMES, chip_smoke.LONG_DRIFT_AT
POSE_ATOL = 2e-4


def _refined(cfg, state, traj, D, replace, refine):
    """The drift event on a package's own result, then its
    refine_trajectory: (trajectory after the event, refined, edges)."""
    traj_p, mem_p, sel = chip_smoke.drift_event(
        traj, np.asarray(state.mem_valid), np.asarray(state.mem_stamp),
        np.asarray(state.mem_T_wk), D, AT)
    valid = np.asarray(state.mem_valid)
    assert sel.any() and (~sel & valid).any()
    refined, _, n_edges = refine(cfg, replace(state, mem_p), traj_p)
    return traj_p, np.asarray(refined), int(n_edges)


@pytest.fixture(scope="module")
def runs():
    jcfg = JCfg(camera=JCam(**chip_smoke.HARD_CAM), **chip_smoke.LONG_CFG)
    cfg = SvoConfig(camera=CameraConfig(**chip_smoke.HARD_CAM),
                    **chip_smoke.LONG_CFG)
    lefts, rights, gt = jsynth.make_sequence(
        jcfg.camera, N, dt=chip_smoke.LONG_DT, kind="loop",
        seed=chip_smoke.SEED)
    jstate, jouts = jax.jit(
        lambda l, r: jrunner.run_sequence_scan(jcfg, l, r))(
            jnp.asarray(lefts), jnp.asarray(rights))
    state, outs = runner.run_sequence_scan(cfg, lefts, rights, device="cpu")
    drift = chip_smoke.LONG_DRIFT
    jD = np.asarray(jse3.exp(jnp.asarray(drift, jnp.float32)))
    D = se3.exp(torch.tensor(drift, dtype=torch.float32)).numpy()
    jtraj = np.asarray(jouts.T_wc)
    traj = outs.T_wc.numpy()
    jres = _refined(jcfg, jstate, jtraj, jD,
                    lambda s, m: s._replace(mem_T_wk=jnp.asarray(m)),
                    jloop.refine_trajectory)
    res = _refined(cfg, state, traj, D,
                   lambda s, m: s._replace(mem_T_wk=torch.as_tensor(m)),
                   loop_closure.refine_trajectory)
    return dict(gt=np.asarray(gt), cfg=cfg, state=state, outs=outs,
                traj=traj, res=res, jstate=jstate, jouts=jouts, jtraj=jtraj,
                jres=jres)


def _tails(res, gt):
    traj_p, refined, _ = res
    return (chip_smoke.tail_err(traj_p, gt, N - AT),
            chip_smoke.tail_err(refined, gt, N - AT))


def test_the_reference_checks_hold_on_the_port(runs):
    """tests/test_mem_retention.py:78's own requirements."""
    gates, cfg, gt = chip_smoke.LONG_GATES, runs["cfg"], runs["gt"]
    ok = runs["outs"].tracking_ok.numpy()
    assert ok.mean() > gates["tracking_ok"], np.nonzero(~ok)[0][:10]
    wraps = int(runs["state"].mem_next) / cfg.mem_keyframes
    assert wraps >= gates["min_wraps"], wraps
    traj = runs["traj"]
    organic = np.linalg.norm(traj[:, :, 3] - gt[:, :, 3], axis=1).max()
    assert organic < gates["organic_m"], organic
    _, refined, n_edges = runs["res"]
    assert n_edges >= 1, "no loop edge accepted after the bank wrapped"
    before, after = _tails(runs["res"], gt)
    assert after < gates["tail_ratio"] * before, (before, after)
    assert np.isfinite(refined).all()


def test_the_bank_and_decisions_equal_the_reference(runs):
    state, jstate = runs["state"], runs["jstate"]
    assert int(state.mem_next) == int(jstate.mem_next)
    for name in ("mem_valid", "mem_stamp"):
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)
    for name in ("tracking_ok", "kf_inserted"):
        got = getattr(runs["outs"], name).numpy()
        want = np.asarray(getattr(runs["jouts"], name))
        first = np.nonzero(got != want)[0][:1]
        assert not first.size, f"{name} parts from the reference at frame " \
                               f"{first[0]}"


def test_poses_follow_the_reference(runs):
    err = np.linalg.norm(runs["traj"][:, :, 3] - runs["jtraj"][:, :, 3],
                         axis=1)
    assert np.isfinite(runs["traj"]).all()
    assert err.max() < POSE_ATOL, (err.max(), int(err.argmax()))


def test_the_refinement_follows_the_reference(runs):
    gt = runs["gt"]
    assert runs["res"][2] == runs["jres"][2]
    for got, want in zip(_tails(runs["res"], gt), _tails(runs["jres"], gt)):
        assert abs(got - want) <= chip_smoke.LOOP_TOL_M, (got, want)
