"""The port's affine-warped KLT templates (``ops/klt.make_template``'s
oversized patches, ``warp_template_level``, ``track(A_inv=)``) against the
JAX reference on tests/test_affine_klt.py's setup, and one frame of the
engine with ``klt_affine_warp=True`` from a short JAX run (its template
state has other shapes, so it needs its own run).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_svo_tpu.config import CameraConfig as JCam
from stereo_svo_tpu.config import SvoConfig as JCfg
from stereo_svo_tpu.engine import step as jstep
from stereo_svo_tpu.geometry import camera as jcamera
from stereo_svo_tpu.geometry import se3 as jse3
from stereo_svo_tpu.io import synthetic as jsynth
from stereo_svo_tpu.ops import klt as jklt
from stereo_svo_tpu.ops import pyramid as jpyramid
from stereo_svo_tpu.ops import solve as jsolve
from stereo_svo_tpu_torch.config import CameraConfig, SvoConfig
from stereo_svo_tpu_torch.engine import runner, state as state_mod, step
from stereo_svo_tpu_torch.ops import klt

# one intra-op thread: the tier-1 run's parallel workers already fill the
# cores, and oversubscribed torch threads slow every small op ~100×
torch.set_num_threads(1)

KLT_CAM = dict(fx=200.0, fy=200.0, cx=128.0, cy=96.0, baseline=0.11,
               width=256, height=192)
KLT_CFG = dict(num_levels=3, align_levels=3, klt_levels=2, klt_max_iters=12,
               klt_affine_warp=True)
JKCFG = JCfg(camera=JCam(**KLT_CAM), **KLT_CFG)
KCFG = SvoConfig(camera=CameraConfig(**KLT_CAM), **KLT_CFG)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _pyr(img):
    return tuple(tuple(np.asarray(a) for a in lv)
                 for lv in jpyramid.build_with_gradients(img, 3))


@pytest.fixture(scope="module")
def scale_change():
    """A reference view and a view 1.4 m closer (~1.5× scale change), a
    feature grid with exact depths, its affine warps and true positions."""
    jcam = JKCFG.camera
    scene = jsynth.default_scene(0)
    T_wr = jsynth.trajectory_pose(jnp.asarray(0.0, jnp.float32))
    T_wc = jse3.compose(T_wr, jse3.make(jnp.eye(3),
                                        jnp.asarray([0.05, 0.0, 1.4])))
    us, vs = np.linspace(10, 246, 12), np.linspace(10, 182, 9)
    uv = np.stack(np.meshgrid(us, vs), -1).reshape(-1, 2).astype(np.float32)
    z = jsynth.gt_depth(jcam, T_wr, jnp.asarray(uv), scene)
    T_cr = jse3.compose(jse3.inverse(T_wc), T_wr)
    A = jcamera.affine_warp_matrix(jcam, jnp.asarray(uv), z, T_cr)
    A_inv = np.array(jsolve.inv2x2(A))
    A_inv[::9] *= 4.0           # strongly shrinking: leaves the stored grid
    uv_gt, front = jcamera.project(jcam, jse3.transform(
        T_cr, jcamera.backproject(jcam, jnp.asarray(uv), z)))
    vis = np.asarray(front & jcamera.in_bounds(jcam, uv_gt, margin=20))
    rng = np.random.default_rng(1)
    uv_init = (np.asarray(uv_gt)
               + rng.uniform(-1.5, 1.5, uv.shape)).astype(np.float32)
    return dict(ref=_pyr(jsynth.render_view(jcam, T_wr, scene)),
                cur=_pyr(jsynth.render_view(jcam, T_wc, scene)), uv=uv,
                A_inv=A_inv, uv_gt=np.asarray(uv_gt), vis=vis,
                uv_init=uv_init)


def _templates(d):
    levels, gxs, gys = d["ref"]
    mask = np.ones(d["uv"].shape[0], bool)
    ours = klt.make_template(tuple(map(_t, levels)), tuple(map(_t, gxs)),
                             tuple(map(_t, gys)), KCFG, _t(d["uv"]),
                             _t(mask))
    ref = jklt.make_template(tuple(map(jnp.asarray, levels)),
                             tuple(map(jnp.asarray, gxs)),
                             tuple(map(jnp.asarray, gys)), JKCFG,
                             jnp.asarray(d["uv"]), jnp.asarray(mask))
    return ours, ref


def test_make_template_big_patches(scale_change):
    ours, ref = _templates(scale_change)
    assert ours.big.shape == (2, 108, 256)      # (levels, N, (2·8)²)
    for name in ("patches", "big"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-4,
                                   err_msg=name)
    big_ok = ours.big_ok.numpy()
    np.testing.assert_array_equal(big_ok, np.asarray(ref.big_ok))
    assert 0 < big_ok.sum() < big_ok.size       # the grid reaches the border


def test_warp_template_level(scale_change):
    _, ref_tmpl = _templates(scale_change)
    A_inv = scale_change["A_inv"]
    for lv in range(2):
        big = np.asarray(ref_tmpl.big[lv])
        ours = klt.warp_template_level(_t(big), _t(A_inv), 8)
        ref = jklt.warp_template_level(jnp.asarray(big), jnp.asarray(A_inv),
                                       8)
        contained = ours[3].numpy()
        np.testing.assert_array_equal(contained, np.asarray(ref[3]))
        assert 0 < contained.sum() < contained.size
        # bilinear taps inside each feature's own 16×16 patch; gradients
        # through A⁻¹ (entries up to ~2), Hessian inverses of ~1e-5
        for o, r, atol, name in zip(ours[:3], ref[:3], (1e-3, 1e-3, 1e-8),
                                    ("val", "J", "hinv")):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4,
                                       atol=atol, err_msg=name)


def test_track_with_affine_warp(scale_change):
    d = scale_change
    _, ref_tmpl = _templates(d)
    tmpl = klt.KltTemplate(*(_t(np.asarray(a)) for a in ref_tmpl))
    levels = d["cur"][0]
    u, ok, _, n_warped = klt.track(tuple(map(_t, levels)), tmpl, KCFG,
                                   _t(d["uv_init"]), A_inv=_t(d["A_inv"]))
    ju, jok, _ = jklt.track(tuple(map(jnp.asarray, levels)), ref_tmpl, JKCFG,
                            jnp.asarray(d["uv_init"]),
                            A_inv=jnp.asarray(d["A_inv"]))
    # the warped-template count follows the reference's fallback rule
    want = sum(int(np.sum(np.asarray(
        jklt.warp_template_level(ref_tmpl.big[lv], jnp.asarray(d["A_inv"]),
                                 8)[3] & ref_tmpl.big_ok[lv] & ref_tmpl.mask)))
               for lv in range(2))
    assert 0 < int(n_warped) == want < 2 * d["uv"].shape[0]
    ok, jok = ok.numpy(), np.asarray(jok)
    # the convergence gate can flip for a step on its threshold
    assert (ok == jok).mean() >= 0.97
    both = ok & jok
    np.testing.assert_allclose(u.numpy()[both], np.asarray(ju)[both],
                               atol=2e-3)
    sel = both & d["vis"]
    assert sel.sum() >= 10
    err = np.linalg.norm(u.numpy()[sel] - d["uv_gt"][sel], axis=1)
    assert np.median(err) < 0.5          # tests/test_affine_klt.py's gate


# ---- one engine frame with klt_affine_warp ----------------------------------

CAM_KW = dict(fx=240.0, fy=240.0, cx=188.0, cy=120.0, baseline=0.11,
              width=376, height=240)
CFG_KW = dict(grid_rows=10, grid_cols=13, max_features=130, num_levels=3,
              align_levels=3, klt_levels=3, stereo_max_disp=64,
              kf_min_tracked=40, border_margin=10, klt_affine_warp=True)
JCFG = JCfg(camera=JCam(**CAM_KW), **CFG_KW)
CFG = SvoConfig(camera=CameraConfig(**CAM_KW), **CFG_KW)


@pytest.fixture(scope="module")
def affine_run():
    lefts, rights, _ = jsynth.make_sequence(JCFG.camera, 8, dt=0.12,
                                            kind="arc")
    jitted = jax.jit(jstep.make_step(JCFG))
    st = jstep.init_state(JCFG)
    states, outs = [_np(st)], []
    for left, right in zip(lefts, rights):
        st, out = jitted(st, jnp.asarray(left), jnp.asarray(right))
        states.append(_np(st))
        outs.append(_np(out))
    return dict(lefts=lefts, rights=rights, states=states, outs=outs)


def test_one_frame_with_affine_warp_from_reference_state(affine_run):
    k = 7
    st_np = affine_run["states"][k]
    assert st_np.klt_tmpl.big.shape == (3, 130, 256)
    assert st_np.klt_tmpl.big_ok.any()
    new_st, out, _ = step.make_step(CFG)(
        state_mod.state_from_numpy(st_np, device="cpu"),
        _t(affine_run["lefts"][k]),
        _t(affine_run["rights"][k]))
    ref_out, ref_st = affine_run["outs"][k], affine_run["states"][k + 1]
    np.testing.assert_allclose(out.T_wc.numpy(), ref_out.T_wc, atol=5e-5)
    assert abs(int(out.n_tracked) - int(ref_out.n_tracked)) <= 2
    status = new_st.status.numpy()
    assert np.mean(status == ref_st.status) > 0.97
    same = (status == ref_st.status) & (status > 0)
    np.testing.assert_allclose(new_st.feat_uv.numpy()[same],
                               ref_st.feat_uv[same], atol=5e-3)


def test_affine_run_tracks_like_reference(affine_run):
    """The port's runner with warped templates over the same 8 frames."""
    traj, metrics = runner.run_sequence(CFG, affine_run["lefts"],
                                        affine_run["rights"], device="cpu")
    ref_traj = np.stack([o.T_wc for o in affine_run["outs"]])
    assert metrics["tracking_ok"].all()
    pos_err = np.linalg.norm(traj[:, :, 3] - ref_traj[:, :, 3], axis=-1)
    assert pos_err.max() < 2e-4, pos_err
    assert metrics["n_warped"][0] == 0 and metrics["n_warped"][1:].min() > 0
    # the same config without the warp differs: the warp really ran
    plain, plain_metrics = runner.run_sequence(dataclasses.replace(
        CFG, klt_affine_warp=False), affine_run["lefts"][:4],
        affine_run["rights"][:4], device="cpu")
    assert np.abs(plain[1:4] - traj[1:4]).max() > 1e-7
    assert not plain_metrics["n_warped"].any()
