"""The port's engine against the JAX reference: renderer, keyframe
insertion on a JAX-captured state, one-frame steps from JAX states, and the
slice as a whole on the same synthetic sequence.

Configuration: the small camera of tests/test_engine.py with use_ba=False
(window BA is not ported yet). End-to-end parity is judged by gates and
short-horizon pose error, not bitwise trajectories: sub-LSB differences
grow chaotically over a run (ROADMAP W7).
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

CAM_KW = dict(fx=240.0, fy=240.0, cx=188.0, cy=120.0, baseline=0.11,
              width=376, height=240)
CFG_KW = dict(grid_rows=10, grid_cols=13, max_features=130, num_levels=3,
              align_levels=3, klt_levels=3, stereo_max_disp=64,
              kf_min_tracked=40, border_margin=10, use_ba=False)
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
            cam, T, synthetic.default_scene(0))
        jl, jr = jsynth.render_stereo(JCFG.camera, jT,
                                      jsynth.default_scene(0))
        # 24 float32 sines of texture phases up to ~100 rad: the two sine
        # implementations round differently by ~1e-5 rad, i.e. ~1e-3 of an
        # intensity level; texture seams (plane edges) match exactly
        for o, r in ((left, jl), (right, jr)):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-2)
            assert np.mean(np.abs(o.numpy() - np.asarray(r))) < 2e-3


def test_make_sequence_shapes_and_poses():
    lefts, rights, poses = synthetic.make_sequence(CFG.camera, 3, dt=DT)
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
        CFG, state_mod.state_from_numpy(st_np),
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
    st = state_mod.state_from_numpy(reference_run["states"][k])
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
        state_mod.state_from_numpy(reference_run["states"][k]),
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
    svo = runner.StereoSvo(CFG)
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
    for kw in (dict(use_ba=True), dict(online_loop_every=4),
               dict(epi_samples=16), dict(klt_affine_warp=True),
               dict(dtype="bfloat16")):
        with pytest.raises(NotImplementedError):
            runner.StereoSvo(dataclasses.replace(CFG, **kw))
    runner.StereoSvo(dataclasses.replace(CFG, mem_retention="fifo"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            runner.StereoSvo(CFG, device="cuda")
