"""The JAX CPU reference values that chip_smoke.py's phases 7, 7b and 9
hold the port to on the card (``PHASE7_REF``, ``PHASE7B_REF``,
``PHASE9_REF``), recomputed: the JAX package over the same 60-frame
out-and-back sequence at 752×480 with the same drift injected before frame
30, then ``refine_trajectory``; and ``SvoConfig(kf_dist_ratio=0.05)`` over that
sequence's first 48 frames with three of them blacked out.
About four minutes of JAX on the CPU, so ``slow``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from stereo_svo_tpu.backend import loop_closure as jlc
from stereo_svo_tpu.config import CameraConfig, SvoConfig
from stereo_svo_tpu.engine import runner as jrunner
from stereo_svo_tpu.eval import ate
from stereo_svo_tpu.geometry import se3 as jse3
from stereo_svo_tpu.io import synthetic as jsynth
from test_online_loop import _inject_world_offset

pytestmark = pytest.mark.slow


def _reference(cfg):
    lefts, rights, gt = jsynth.make_sequence(
        cfg.camera, chip_smoke.LOOP_FRAMES, dt=chip_smoke.LOOP_DT,
        kind="loop", seed=chip_smoke.SEED)
    gt = np.asarray(gt)
    D = jse3.exp(jnp.asarray(chip_smoke.LOOP_DRIFT, jnp.float32))
    svo = jrunner.StereoSvo(cfg)
    for i in range(chip_smoke.LOOP_FRAMES):
        if i == chip_smoke.LOOP_INJECT_AT:
            svo.state = _inject_world_offset(svo.state, D)
        svo.new_image(lefts[i], rights[i])
    traj = svo.trajectory()
    _, _, n_edges = jlc.refine_trajectory(cfg, svo.state, traj)
    return dict(
        kf_frames=np.nonzero(np.asarray(svo.metrics()["kf_inserted"]))[0]
        .tolist(),
        n_loop_closures=int(svo.state.n_loop_closures),
        offline_edges=int(n_edges),
        tail_err_m=chip_smoke.tail_err(traj, gt),
        ate_m=ate.ate_rmse(ate.positions(traj), ate.positions(gt)))


def _check(got, want):
    for key, value in want.items():
        if isinstance(value, float):
            assert got[key] == pytest.approx(value, rel=1e-5), key
        else:
            assert got[key] == value, key


def test_phase7_reference():
    cfg = SvoConfig(online_loop_every=1, **chip_smoke.LOOP_KNOBS)
    _check(_reference(cfg), chip_smoke.PHASE7_REF)


def test_phase7b_reference():
    rig = dict(camera=CameraConfig(**chip_smoke.RIG_7B), max_keyframes=3,
               mem_keyframes=12, **chip_smoke.LOOP_KNOBS)
    on = _reference(SvoConfig(online_loop_every=1, **rig))
    off = _reference(SvoConfig(online_loop_every=0, **rig))
    want = dict(chip_smoke.PHASE7B_REF)
    assert off["n_loop_closures"] == 0
    assert off["tail_err_m"] == pytest.approx(
        want.pop("control_tail_err_m"), rel=1e-5)
    _check(on, want)


def test_phase9_reference():
    """Tracking loss and relocalisation: which frames fail, the keyframe
    frames, and the errors after recovery."""
    cfg = SvoConfig(**chip_smoke.BLACKOUT_KNOBS)
    n = chip_smoke.BLACKOUT_FRAMES
    lefts, rights, gt = jsynth.make_sequence(
        cfg.camera, n, dt=chip_smoke.LOOP_DT, kind="loop",
        seed=chip_smoke.SEED)
    gt = np.asarray(gt)
    black = np.zeros_like(lefts[0])
    svo = jrunner.StereoSvo(cfg)
    for i in range(n):
        if i in chip_smoke.BLACKOUT:
            svo.new_image(black, black)
        else:
            svo.new_image(lefts[i], rights[i])
    traj, metrics = svo.trajectory(), svo.metrics()
    assert np.isfinite(traj).all()
    got = dict(
        kf_frames=np.nonzero(np.asarray(metrics["kf_inserted"]))[0].tolist(),
        lost_frames=np.nonzero(~np.asarray(metrics["tracking_ok"]))[0]
        .tolist(),
        tail_err_m=chip_smoke.tail_err(traj, gt),
        ate_m=ate.ate_rmse(ate.positions(traj), ate.positions(gt)))
    print("PHASE9_REF =", got)
    _check(got, chip_smoke.PHASE9_REF)
