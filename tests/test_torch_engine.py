"""The port's engine against the JAX reference: renderer, keyframe
insertion on a JAX-captured state, one-frame steps from JAX states, and the
slice as a whole on the same synthetic sequence.

Configuration: the small camera of tests/test_engine.py with the shipped
defaults, window BA included (it runs at frame 13, the first keyframe after
the bootstrap). End-to-end parity is judged by gates and short-horizon pose
error, not bitwise trajectories: sub-LSB differences grow chaotically over a
run (ROADMAP W7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_svo_tpu.config import CameraConfig as JCam
from stereo_svo_tpu.config import SvoConfig as JCfg
from stereo_svo_tpu.engine import step as jstep
from stereo_svo_tpu.frontend import keyframe as jkeyframe
from stereo_svo_tpu.geometry import se3 as jse3
from stereo_svo_tpu.io import synthetic as jsynth
from stereo_svo_tpu.ops import pyramid as jpyramid
from stereo_svo_tpu_torch.config import CameraConfig, SvoConfig
from stereo_svo_tpu_torch.engine import runner, state as state_mod, step
from stereo_svo_tpu_torch.eval import ate
from stereo_svo_tpu_torch.frontend import keyframe
from stereo_svo_tpu_torch.io import synthetic

# one intra-op thread: the tier-1 run's parallel workers already fill the
# cores, and oversubscribed torch threads slow every small op ~100×
torch.set_num_threads(1)

CAM_KW = dict(fx=240.0, fy=240.0, cx=188.0, cy=120.0, baseline=0.11,
              width=376, height=240)
CFG_KW = dict(grid_rows=10, grid_cols=13, max_features=130, num_levels=3,
              align_levels=3, klt_levels=3, stereo_max_disp=64,
              kf_min_tracked=40, border_margin=10)
JCFG = JCfg(camera=JCam(**CAM_KW), **CFG_KW)
CFG = SvoConfig(camera=CameraConfig(**CAM_KW), **CFG_KW)
N_FRAMES = 16     # frame 13 is the first keyframe after the bootstrap
DT = 0.12


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def reference_run():
    """The JAX step over the sequence: frames, GT, every state and output."""
    lefts, rights, gt = jsynth.make_sequence(JCFG.camera, N_FRAMES, dt=DT,
                                             kind="arc")
    jitted = jax.jit(jstep.make_step(JCFG))
    st = jstep.init_state(JCFG)
    states, outs = [_np(st)], []
    for l, r in zip(lefts, rights):
        st, out = jitted(st, jnp.asarray(l), jnp.asarray(r))
        states.append(_np(st))
        outs.append(_np(out))
    return dict(lefts=lefts, rights=rights, gt=gt, states=states, outs=outs)


def test_renderer_matches_reference():
    cam = CFG.camera
    for t in (0.0, 0.84):
        T = synthetic.trajectory_pose(torch.tensor(t), "arc")
        jT = jsynth.trajectory_pose(jnp.asarray(t, jnp.float32), "arc")
        np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-6)
        left, right = synthetic.render_stereo(
            cam, T, synthetic.default_scene(0, device="cpu"))
        jl, jr = jsynth.render_stereo(JCFG.camera, jT,
                                      jsynth.default_scene(0))
        # 24 float32 sines of texture phases up to ~100 rad: the two sine
        # implementations round differently by ~1e-5 rad, i.e. ~1e-3 of an
        # intensity level; texture seams (plane edges) match exactly
        for o, r in ((left, jl), (right, jr)):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-2)
            assert np.mean(np.abs(o.numpy() - np.asarray(r))) < 2e-3


def test_make_sequence_shapes_and_poses():
    lefts, rights, poses = synthetic.make_sequence(CFG.camera, 3, dt=DT,
                                                   device="cpu")
    assert lefts.shape == rights.shape == (3, 240, 376)
    assert poses.shape == (3, 3, 4)
    assert torch.all(torch.isfinite(lefts))
    assert 0.0 <= float(lefts.min()) and float(lefts.max()) <= 255.0
    gt = np.stack([np.asarray(jsynth.trajectory_pose(
        jnp.asarray(i * DT, jnp.float32))) for i in range(3)])
    np.testing.assert_allclose(poses.numpy(), gt, atol=1e-6)


def _pyramid(img):
    return tuple(tuple(np.asarray(a) for a in lv) for lv in
                 jpyramid.build_with_gradients(jnp.asarray(img),
                                               JCFG.num_levels))


def test_keyframe_insert_on_reference_state(reference_run):
    """Slot assignment on a mid-sequence JAX state must be exact."""
    k = 13
    st_np = reference_run["states"][k]
    pyr = _pyramid(reference_run["lefts"][k])
    img_r = reference_run["rights"][k]
    T_cw = np.asarray(jse3.inverse(jnp.asarray(reference_run["outs"][k].T_wc)))
    ref = _np(jax.jit(jkeyframe.insert, static_argnums=0)(
        JCFG, jax.tree.map(jnp.asarray, st_np),
        *(tuple(map(jnp.asarray, lv)) for lv in pyr), jnp.asarray(img_r),
        jnp.asarray(T_cw)))
    ours = keyframe.insert(
        CFG, state_mod.state_from_numpy(st_np, device="cpu"),
        *(tuple(torch.from_numpy(np.array(a)) for a in lv) for lv in pyr),
        torch.from_numpy(np.array(img_r)), torch.from_numpy(np.array(T_cw)))
    ours = state_mod.state_to_numpy(ours)
    new = ref.status != st_np.status
    assert new.sum() > 10, "the insertion should fill freed slots"
    for name in ("status", "kf_id", "feat_level", "feat_corner", "last_kf",
                 "kf_valid", "kf_mem", "mem_valid", "mem_stamp", "mem_next",
                 "kf_stamp", "obs_mask", "mem_mask"):
        np.testing.assert_array_equal(ours[name], np.asarray(getattr(ref,
                                                                     name)),
                                      err_msg=name)
    for name in ("feat_uv", "kf_uv"):
        np.testing.assert_array_equal(ours[name], getattr(ref, name),
                                      err_msg=name)
    # stereo depths: parabola peaks of float32 ZNCC scores
    for name in ("mu", "sigma2", "z_range", "feat_dir", "kf_desc",
                 "obs_disp"):
        np.testing.assert_allclose(ours[name], getattr(ref, name), rtol=2e-4,
                                   atol=2e-5, err_msg=name)
    # the consistency gate compares float32 disparities against a window
    agree = ours["obs_dmask"] == ref.obs_dmask
    assert agree.mean() > 0.995
    np.testing.assert_allclose(ours["klt_tmpl"]["patches"],
                               ref.klt_tmpl.patches, atol=1e-3)
    np.testing.assert_array_equal(ours["klt_tmpl"]["mask"],
                                  ref.klt_tmpl.mask)


@pytest.mark.parametrize("k", [6, 13])
def test_one_frame_from_reference_state(reference_run, k):
    """Hand the JAX state after frame k-1 to the port's step; frame k must
    agree (k=13 runs the keyframe phase)."""
    st = state_mod.state_from_numpy(reference_run["states"][k], device="cpu")
    new_st, out, flags = step.make_step(CFG)(
        st, torch.from_numpy(np.array(reference_run["lefts"][k])),
        torch.from_numpy(np.array(reference_run["rights"][k])))
    ref_out = reference_run["outs"][k]
    ref_st = reference_run["states"][k + 1]
    assert flags.booted and flags.tracking_ok == bool(ref_out.tracking_ok)
    assert bool(out.kf_inserted) == bool(ref_out.kf_inserted) == (k == 13)
    # one frame of alignment + refinement from identical inputs: the pose
    # agrees to float32 rounding of the Gauss-Newton chain
    np.testing.assert_allclose(out.T_wc.numpy(), ref_out.T_wc, atol=5e-5)
    assert abs(int(out.n_tracked) - int(ref_out.n_tracked)) <= 2
    status = new_st.status.numpy()
    assert np.mean(status == ref_st.status) > 0.97
    same = (status == ref_st.status) & (status > 0)
    np.testing.assert_allclose(new_st.feat_uv.numpy()[same],
                               ref_st.feat_uv[same], atol=5e-3)
    np.testing.assert_allclose(new_st.mu.numpy()[same], ref_st.mu[same],
                               rtol=1e-3)


def test_one_frame_with_the_smaller_knobs(reference_run):
    """The knobs the slice ports besides the defaults, from the JAX state
    before frame 13: depth-whitened refinement rows, stereo template
    depths, the keyframe cadence (frame 13 is off-cadence at kf_every=2,
    so the insertion the default config makes there is suppressed) and
    the FIFO memory bank."""
    knobs = dict(refine_whiten_depth=True, align_tmpl_stereo=True,
                 kf_every=2, mem_retention="fifo")
    jcfg = JCfg(camera=JCam(**CAM_KW), **CFG_KW, **knobs)
    cfg = SvoConfig(camera=CameraConfig(**CAM_KW), **CFG_KW, **knobs)
    k = 13
    l, r = reference_run["lefts"][k], reference_run["rights"][k]
    ref_st, ref_out = jax.jit(jstep.make_step(jcfg))(
        jax.tree.map(jnp.asarray, reference_run["states"][k]),
        jnp.asarray(l), jnp.asarray(r))
    new_st, out, _ = step.make_step(cfg)(
        state_mod.state_from_numpy(reference_run["states"][k], device="cpu"),
        torch.from_numpy(np.array(l)), torch.from_numpy(np.array(r)))
    assert not bool(ref_out.kf_inserted) and not bool(out.kf_inserted)
    np.testing.assert_allclose(out.T_wc.numpy(), np.asarray(ref_out.T_wc),
                               atol=5e-5)
    # the template depths now come from this frame's stereo disparities
    np.testing.assert_array_equal(new_st.tmpl.mask.numpy(),
                                  np.asarray(ref_st.tmpl.mask))
    np.testing.assert_allclose(new_st.tmpl.p_ref.numpy(),
                               np.asarray(ref_st.tmpl.p_ref), rtol=1e-3,
                               atol=1e-4)


def test_slice_end_to_end_against_reference(reference_run):
    """The port's StereoSvo and the JAX step on the same frames."""
    svo = runner.StereoSvo(CFG, device="cpu")
    for l, r in zip(reference_run["lefts"], reference_run["rights"]):
        svo.new_image(l, r)
    traj, metrics = svo.trajectory(), svo.metrics()
    ref_traj = np.stack([o.T_wc for o in reference_run["outs"]])
    ref_kf = np.array([bool(o.kf_inserted) for o in reference_run["outs"]])
    assert metrics["tracking_ok"].all()
    np.testing.assert_array_equal(metrics["kf_inserted"], ref_kf)
    assert ref_kf.sum() >= 2
    # short-horizon pose agreement: float32 differences compound slowly
    pos_err = np.linalg.norm(traj[:, :, 3] - ref_traj[:, :, 3], axis=-1)
    assert pos_err[:8].max() < 2e-4, pos_err
    assert pos_err.max() < 2e-3, pos_err
    err = ate.ate_rmse(ate.positions(traj), ate.positions(reference_run["gt"]))
    assert err < 0.02, f"ATE {err:.5f} m"
    assert metrics["n_tracked"][1:].min() > 30


def test_runner_rejects_unported_knobs_and_missing_cuda():
    import dataclasses

    from stereo_svo_tpu_torch.config import kitti_config, stress_config
    with pytest.raises(NotImplementedError):
        runner.StereoSvo(dataclasses.replace(CFG, online_loop_every=4),
                         device="cpu")
    # every configuration the config module ships builds unchanged
    for cfg in (SvoConfig(), kitti_config(), stress_config(),
                SvoConfig(klt_affine_warp=True), SvoConfig(dtype="bfloat16")):
        step.make_step(cfg)
    for kw in (dict(mem_retention="fifo"), dict(epi_samples=16),
               dict(klt_affine_warp=True), dict(dtype="bfloat16")):
        runner.StereoSvo(dataclasses.replace(CFG, **kw), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            runner.StereoSvo(CFG, device="cuda")


def test_entry_points_default_to_the_card():
    """With no device named, the entry points run on the card: without
    one they raise (no fallback to the CPU); with one, the state lives
    there."""
    if not torch.cuda.is_available():
        frames = np.zeros((1, 240, 376), np.float32)
        with pytest.raises(RuntimeError):
            runner.StereoSvo(SvoConfig())
        with pytest.raises(RuntimeError):
            runner.run_sequence(CFG, frames, frames)
        with pytest.raises(RuntimeError):
            state_mod.init_state(CFG)
        with pytest.raises(RuntimeError):
            synthetic.make_sequence(CFG.camera, 1)
        return
    svo = runner.StereoSvo(SvoConfig())
    assert svo.state.T_cw.device.type == "cuda"
    lefts, rights, _ = synthetic.make_sequence(CFG.camera, 2, dt=DT)
    assert lefts.device.type == "cuda"
    traj, metrics = runner.run_sequence(CFG, lefts, rights)
    assert traj.shape == (2, 3, 4) and metrics["tracking_ok"].all()


def test_bfloat16_knob_gives_the_float32_result(reference_run):
    """``dtype`` only picks the reference's TPU-only MXU sampler dtype; the
    gather sampler ignores it, so the port's result is the float32 one, bit
    for bit (frame 13 runs the keyframe phase and BA)."""
    import dataclasses
    st = reference_run["states"][13]
    l, r = (torch.from_numpy(np.array(reference_run[k][13]))
            for k in ("lefts", "rights"))
    outs = [step.make_step(dataclasses.replace(CFG, dtype=dt))(
        state_mod.state_from_numpy(st, device="cpu"), l, r)
        for dt in ("float32", "bfloat16")]
    (st32, out32, _), (st16, out16, _) = outs
    assert bool(out32.kf_inserted)
    for a, b in zip(out32, out16):
        assert torch.equal(a, b)
    for a, b in zip(st32, st16):
        assert all(torch.equal(x, y) for x, y in zip(
            a if isinstance(a, tuple) else (a,),
            b if isinstance(b, tuple) else (b,)))


@pytest.fixture(scope="module")
def jax_window_ba():
    return jax.jit(lambda s: jstep.run_window_ba(JCFG, s))


def _inserted_state(reference_run, k=13):
    """The JAX state after frame k's keyframe insertion, before its BA."""
    st_np = reference_run["states"][k]
    pyr = _pyramid(reference_run["lefts"][k])
    T_cw = np.asarray(jse3.inverse(jnp.asarray(reference_run["outs"][k].T_wc)))
    return _np(jax.jit(jkeyframe.insert, static_argnums=0)(
        JCFG, jax.tree.map(jnp.asarray, st_np),
        *(tuple(map(jnp.asarray, lv)) for lv in pyr),
        jnp.asarray(reference_run["rights"][k]), jnp.asarray(T_cw)))


def test_run_window_ba_on_reference_state(reference_run, jax_window_ba):
    """Window BA on the JAX state right after frame 13's keyframe
    insertion, field by field."""
    st_np = _inserted_state(reference_run)
    ref = _np(jax_window_ba(jax.tree.map(jnp.asarray, st_np)))
    ours = state_mod.state_to_numpy(
        step.run_window_ba(CFG, state_mod.state_from_numpy(st_np,
                                                           device="cpu")))
    assert ref.ba_diag[5] == 1.0 and ours["ba_diag"][5] == 1.0, "accepted"
    assert ours["ba_diag"][6] == ref.ba_diag[6] > 100        # n_obs
    # five float32 Gauss-Newton steps whose einsums contract in another
    # order than XLA's: poses agree to ~1e-6 m, costs to 1e-4 relative
    np.testing.assert_allclose(ours["kf_T_wk"], ref.kf_T_wk, atol=2e-5)
    np.testing.assert_allclose(ours["mem_T_wk"], ref.mem_T_wk, atol=2e-5)
    np.testing.assert_allclose(ours["ba_diag"][3:5], ref.ba_diag[3:5],
                               rtol=1e-4)
    np.testing.assert_allclose(ours["ba_diag"][:3], ref.ba_diag[:3],
                               atol=2e-5)
    np.testing.assert_allclose(ours["mu"], ref.mu, rtol=1e-4, atol=1e-6)
    moved = np.abs(ref.mu - st_np.mu) > 0
    assert moved.sum() > 10, "BA refined the landmarks"
    for name in ("status", "kf_valid", "obs_mask", "mem_stamp"):
        np.testing.assert_array_equal(ours[name], getattr(ref, name))


def test_window_ba_guard_rejects_corrupted_observations(reference_run,
                                                        jax_window_ba):
    """Garbage observations must not move the keyframes (the divergence
    guard), in the port as in the reference."""
    st_np = _inserted_state(reference_run)
    rng = np.random.default_rng(0)
    bad = st_np._replace(obs_uv=rng.uniform(
        0, CFG.camera.width, st_np.obs_uv.shape).astype(np.float32))
    ref = _np(jax_window_ba(jax.tree.map(jnp.asarray, bad)))
    ours = state_mod.state_to_numpy(
        step.run_window_ba(CFG, state_mod.state_from_numpy(bad,
                                                           device="cpu")))
    # both solvers propose a metres-long jump and the trust region
    # (ba_trust_t = 0.1 m) rejects it
    assert ours["ba_diag"][5] == ref.ba_diag[5] == 0.0
    assert ours["ba_diag"][0] > 1.0 and ref.ba_diag[0] > 1.0
    np.testing.assert_allclose(ours["kf_T_wk"], st_np.kf_T_wk, atol=1e-5)
    np.testing.assert_allclose(ref.kf_T_wk, st_np.kf_T_wk, atol=1e-5)


def test_window_ba_trust_clamp_on_reference_state(reference_run):
    """``ba_trust_clamp``: the corrupted-observation proposal is applied as
    a partial step scaled to the trust radius of the newest keyframe (the
    reference's rule, ROADMAP W8), in the port as in the reference."""
    import dataclasses
    jcfg = dataclasses.replace(JCFG, ba_trust_clamp=True)
    cfg = dataclasses.replace(CFG, ba_trust_clamp=True)
    st_np = _inserted_state(reference_run)
    rng = np.random.default_rng(0)
    bad = st_np._replace(obs_uv=rng.uniform(
        0, CFG.camera.width, st_np.obs_uv.shape).astype(np.float32))
    ref = _np(jax.jit(lambda s: jstep.run_window_ba(jcfg, s))(
        jax.tree.map(jnp.asarray, bad)))
    ours = state_mod.state_to_numpy(
        step.run_window_ba(cfg, state_mod.state_from_numpy(bad,
                                                           device="cpu")))
    assert ours["ba_diag"][5] == ref.ba_diag[5] == 1.0   # cost dropped
    # the newest keyframe's metres-long proposal shrinks to ~the trust
    # radius (the twist is scaled, so the move is not exactly 0.1 m)
    k = int(st_np.last_kf)
    for T in (ours["kf_T_wk"], ref.kf_T_wk):
        moved = np.linalg.norm(T[k, :, 3] - st_np.kf_T_wk[k, :, 3])
        assert 0.05 < moved < 0.2, moved
    # the proposals themselves differ by ~1e-3 relative (a metres-long
    # Gauss-Newton step on garbage), and so do the clamped steps
    np.testing.assert_allclose(ours["kf_T_wk"], ref.kf_T_wk, atol=2e-3)
