"""The JAX CPU reference values that chip_smoke.py's phases 7, 7b, 9, 13
and 14 hold the port to on the card (``PHASE7_REF``, ``PHASE7B_REF``,
``PHASE9_REF``, ``PHASE13_REF``, ``PHASE14_REF``), recomputed: the JAX
package over the same 60-frame out-and-back sequence at 752×480 with the
same drift injected before frame 30, then ``refine_trajectory``;
``SvoConfig(kf_dist_ratio=0.05)`` over that sequence's first 48 frames with
three of them blacked out; the five hard scenes of
tests/test_synthetic_hard.py at its rig and under ``SvoConfig()``; and the
500-frame wrapped-bank run of tests/test_mem_retention.py:78 with its drift
event and ``refine_trajectory``. Each on JAX's frames. Minutes of JAX on
the CPU, so ``slow``.
"""

import jax
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


def _hard_reference(cfg):
    """Each scene of chip_smoke.HARD_SCENES through the JAX package on its
    own frames, every run on one jitted step."""
    first = jrunner.StereoSvo(cfg)
    got = {}
    for name, kw in chip_smoke.HARD_SCENES.items():
        lefts, rights, gt = jsynth.make_sequence(
            cfg.camera, chip_smoke.HARD_FRAMES, dt=chip_smoke.HARD_DT,
            seed=chip_smoke.SEED, **kw)
        svo = jrunner.StereoSvo(cfg)
        svo._step = first._step
        for left, right in zip(lefts, rights):
            svo.new_image(left, right)
        traj, metrics = svo.trajectory(), svo.metrics()
        got[name] = dict(
            kf_frames=np.nonzero(np.asarray(metrics["kf_inserted"]))[0]
            .tolist(),
            tracking_ok=float(np.mean(metrics["tracking_ok"])),
            ate_m=ate.ate_rmse(ate.positions(traj),
                               ate.positions(np.asarray(gt))))
    return got


def test_phase13_reference():
    rig = SvoConfig(camera=CameraConfig(**chip_smoke.HARD_CAM),
                    **chip_smoke.HARD_CFG)
    got = {"rig": _hard_reference(rig), "full": _hard_reference(SvoConfig())}
    print("PHASE13_REF =", got)
    want = chip_smoke.PHASE13_REF
    assert set(got) == set(want)
    for key, runs in got.items():
        assert set(runs) == set(want[key]), key
        for name, run in runs.items():
            # phase 13 gates every run on the card: the reference meets them
            assert run["ate_m"] < chip_smoke.HARD_ATE_GATES[name], (key, name)
            assert run["tracking_ok"] >= chip_smoke.HARD_TRACK_GATE
            _check(run, want[key][name])


def test_phase14_reference():
    cfg = SvoConfig(camera=CameraConfig(**chip_smoke.HARD_CAM),
                    **chip_smoke.LONG_CFG)
    n, at = chip_smoke.LONG_FRAMES, chip_smoke.LONG_DRIFT_AT
    lefts, rights, gt = jsynth.make_sequence(
        cfg.camera, n, dt=chip_smoke.LONG_DT, kind="loop",
        seed=chip_smoke.SEED)
    gt = np.asarray(gt)
    state, outs = jax.jit(lambda l, r: jrunner.run_sequence_scan(cfg, l, r))(
        jnp.asarray(lefts), jnp.asarray(rights))
    traj = np.asarray(outs.T_wc)
    D = np.asarray(jse3.exp(jnp.asarray(chip_smoke.LONG_DRIFT, jnp.float32)))
    traj_p, mem_p, _ = chip_smoke.drift_event(
        traj, np.asarray(state.mem_valid), np.asarray(state.mem_stamp),
        np.asarray(state.mem_T_wk), D, at)
    refined, _, n_edges = jlc.refine_trajectory(
        cfg, state._replace(mem_T_wk=jnp.asarray(mem_p)), traj_p)
    got = dict(
        tracking_ok=float(np.mean(outs.tracking_ok)),
        keyframes=int(np.sum(outs.kf_inserted)),
        wraps=int(state.mem_next) / cfg.mem_keyframes,
        organic_m=float(np.linalg.norm(traj[:, :, 3] - gt[:, :, 3],
                                       axis=1).max()),
        offline_edges=int(n_edges),
        tail_before_m=chip_smoke.tail_err(traj_p, gt, n - at),
        tail_after_m=chip_smoke.tail_err(np.asarray(refined), gt, n - at))
    print("PHASE14_REF =", got)
    assert set(got) == set(chip_smoke.PHASE14_REF)
    _check(got, chip_smoke.PHASE14_REF)
