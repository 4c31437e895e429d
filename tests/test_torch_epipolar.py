"""The port's epipolar search (``ops/depth_filter.epipolar_search``) and the
KITTI-geometry path that turns it on, against the JAX reference.

* the search itself on tests/test_epipolar.py's two-view setup;
* a short road/kitti run at half KITTI resolution (620×188, the wide
  0.537 m baseline) with ``kitti_config()``'s settings — epipolar search,
  window BA and the driving-scale trust region — through the JAX step and
  the port's runner on the same frames, and one frame from a JAX state on
  which the search recovers seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_svo_tpu.config import CameraConfig as JCam
from stereo_svo_tpu.config import SvoConfig as JCfg
from stereo_svo_tpu.config import kitti_config as jkitti_config
from stereo_svo_tpu.engine import step as jstep
from stereo_svo_tpu.geometry import se3 as jse3
from stereo_svo_tpu.io import synthetic as jsynth
from stereo_svo_tpu.ops import depth_filter as jdf
from stereo_svo_tpu.ops import interp as jinterp
from stereo_svo_tpu.ops import pyramid as jpyramid
from stereo_svo_tpu_torch.config import CameraConfig, SvoConfig, kitti_config
from stereo_svo_tpu_torch.engine import runner, state as state_mod, step
from stereo_svo_tpu_torch.eval import ate
from stereo_svo_tpu_torch.ops import depth_filter

# one intra-op thread: the tier-1 run's parallel workers already fill the
# cores, and oversubscribed torch threads slow every small op ~100×
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


# ---- the search: tests/test_epipolar.py's setup ----------------------------

EPI_CAM = dict(fx=200.0, fy=200.0, cx=128.0, cy=96.0, baseline=0.11,
               width=256, height=192)
EPI_CFG = dict(num_levels=3, align_levels=3, klt_levels=3, epi_samples=16)


def test_epipolar_search_matches_reference():
    jcam = JCam(**EPI_CAM)
    jcfg = JCfg(camera=jcam, **EPI_CFG)
    cfg = SvoConfig(camera=CameraConfig(**EPI_CAM), **EPI_CFG)
    scene = jsynth.default_scene(0)
    T_wr = jsynth.trajectory_pose(jnp.asarray(0.0, jnp.float32))
    T_wc = jse3.compose(T_wr, jse3.make(jnp.eye(3),
                                        jnp.asarray([0.12, 0.02, 0.1])))
    img_r = jsynth.render_view(jcam, T_wr, scene)
    img_c = jsynth.render_view(jcam, T_wc, scene)
    T_cr = jse3.compose(jse3.inverse(T_wc), T_wr)
    us, vs = np.linspace(42, 256 - 42, 8), np.linspace(42, 192 - 42, 6)
    uv = np.stack(np.meshgrid(us, vs), -1).reshape(-1, 2).astype(np.float32)
    N = uv.shape[0]
    z_gt = np.asarray(jsynth.gt_depth(jcam, T_wr, jnp.asarray(uv), scene))
    mu = (1.0 / z_gt * 1.15).astype(np.float32)
    sigma2 = ((0.12 * mu) ** 2).astype(np.float32)
    lv = 1
    pyr_r = jpyramid.build_with_gradients(img_r, 3)[0]
    tmpl = np.asarray(jinterp.sample_patch(pyr_r[lv], jnp.asarray(uv) * 0.5,
                                           8, method="gather"))
    img = np.asarray(jpyramid.build_with_gradients(img_c, 3)[0][lv])
    T_ck = np.broadcast_to(np.asarray(T_cr), (N, 3, 4)).copy()
    active = np.ones(N, bool)
    active[::7] = False
    args = (T_ck, uv, mu, sigma2, tmpl, img, active)
    uv_o, ok_o, s_o = depth_filter.epipolar_search(
        cfg.camera, cfg, *map(_t, args), level=lv)
    uv_r, ok_r, s_r = jdf.epipolar_search(jcam, jcfg, *map(jnp.asarray, args),
                                          level=lv)
    ok_o, ok_r = ok_o.numpy(), np.asarray(ok_r)
    # ZNCC scores are float32 dot products of normalised 64-vectors
    np.testing.assert_allclose(s_o.numpy(), np.asarray(s_r), atol=2e-5)
    np.testing.assert_array_equal(ok_o, ok_r)
    assert 10 <= ok_o.sum() < active.sum()
    assert not ok_o[~active].any()
    # the parabola peak moves by ~1e-3 px for a score change of ~1e-6
    np.testing.assert_allclose(uv_o.numpy()[ok_o], np.asarray(uv_r)[ok_o],
                               atol=2e-3)


# ---- KITTI geometry at half resolution --------------------------------------

HALF_CAM = dict(fx=359.428, fy=359.428, cx=303.5964, cy=92.60785,
                baseline=0.5371657, width=620, height=188)
N_FRAMES, DT = 8, 0.08


def _kitti_half(cfg_mod, cam_cls):
    """kitti_config() at half resolution: the disparity range halves with
    the image; everything else as shipped (epipolar search, BA)."""
    return dataclasses.replace(cfg_mod(), camera=cam_cls(**HALF_CAM),
                               stereo_max_disp=64)


JCFG = _kitti_half(jkitti_config, JCam)
CFG = _kitti_half(kitti_config, CameraConfig)


@pytest.fixture(scope="module")
def road_run():
    """The JAX step over a road/kitti sequence: frames, GT, states, outs."""
    lefts, rights, gt = jsynth.make_sequence(JCFG.camera, N_FRAMES, dt=DT,
                                             kind="kitti", scene_kind="road")
    jitted = jax.jit(jstep.make_step(JCFG))
    st = jstep.init_state(JCFG)
    states, outs = [_np(st)], []
    for left, right in zip(lefts, rights):
        st, out = jitted(st, jnp.asarray(left), jnp.asarray(right))
        states.append(_np(st))
        outs.append(_np(out))
    return dict(lefts=lefts, rights=rights, gt=gt, states=states, outs=outs)


def test_kitti_road_run_against_reference(road_run):
    assert CFG.epi_samples == 16 and CFG.use_ba
    traj, metrics = runner.run_sequence(CFG, road_run["lefts"],
                                        road_run["rights"], device="cpu")
    ref_traj = np.stack([o.T_wc for o in road_run["outs"]])
    ref_epi = np.array([int(o.n_epi_recovered) for o in road_run["outs"]])
    assert metrics["tracking_ok"].all()
    np.testing.assert_array_equal(
        metrics["kf_inserted"], [bool(o.kf_inserted) for o in road_run["outs"]])
    # the epipolar path runs in both (recoveries on the same frames, give
    # or take a seed on a ZNCC threshold)
    assert ref_epi.sum() > 0 and metrics["n_epi_recovered"].sum() > 0
    assert np.abs(metrics["n_epi_recovered"] - ref_epi).max() <= 2
    # one frame from a JAX state agrees to ~1e-6 m (next test), but far
    # seeds make the driving-scale run more chaotic than the EuRoC one
    # (W7): a pose differs by ~2 mm at frame 4, against 12 cm of travel
    # per frame and ~2-8 mm of error against the ground truth
    pos_err = np.linalg.norm(traj[:, :, 3] - ref_traj[:, :, 3], axis=-1)
    assert pos_err[:4].max() < 1e-5, pos_err
    assert pos_err.max() < 5e-3, pos_err
    err = ate.ate_rmse(ate.positions(traj), ate.positions(road_run["gt"]))
    ref_err = ate.ate_rmse(ate.positions(ref_traj),
                           ate.positions(road_run["gt"]))
    assert err < 0.05 and abs(err - ref_err) < 5e-3, (err, ref_err)


def test_one_frame_epipolar_from_reference_state(road_run):
    """From the JAX state before the first frame whose search recovers
    seeds, the port's step recovers the same seeds and updates them alike."""
    epi = [int(o.n_epi_recovered) for o in road_run["outs"]]
    k = next(i for i, n in enumerate(epi) if n > 0)
    st = state_mod.state_from_numpy(road_run["states"][k], device="cpu")
    new_st, out, _ = step.make_step(CFG)(
        st, _t(road_run["lefts"][k]), _t(road_run["rights"][k]))
    ref_out, ref_st = road_run["outs"][k], road_run["states"][k + 1]
    assert int(out.n_epi_recovered) == epi[k]
    np.testing.assert_allclose(out.T_wc.numpy(), ref_out.T_wc, atol=5e-5)
    status = new_st.status.numpy()
    assert np.mean(status == ref_st.status) > 0.97
    same = (status == ref_st.status) & (status > 0)
    # a far seed's motion triangulation has almost no parallax, so its
    # update amplifies the ~1e-7 pose difference: judge each inverse depth
    # against its own posterior σ as well (2% of σ)
    dmu = np.abs(new_st.mu.numpy() - ref_st.mu)[same]
    tol = 1e-3 * ref_st.mu[same] + 0.02 * np.sqrt(ref_st.sigma2[same])
    assert (dmu <= tol).all(), (dmu / tol).max()
    np.testing.assert_array_equal(new_st.n_upd.numpy()[same],
                                  ref_st.n_upd[same])
