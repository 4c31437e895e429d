"""Parity of the port's per-frame operators with the JAX reference on
frames rendered by the JAX renderer at small size (376×240).

Both sides get the same numpy inputs (the JAX pyramid, features and
poses), so each test isolates one operator. JAX runs on the CPU through
tests/conftest.py. Each tolerance states its reason.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_svo_tpu.backend import loop_closure as jloop
from stereo_svo_tpu.config import CameraConfig as JCam
from stereo_svo_tpu.config import SvoConfig as JCfg
from stereo_svo_tpu.frontend import detector as jdetector
from stereo_svo_tpu.frontend import keyframe as jkeyframe
from stereo_svo_tpu.frontend import pose_refine as jrefine
from stereo_svo_tpu.geometry import camera as jcamera
from stereo_svo_tpu.geometry import se3 as jse3
from stereo_svo_tpu.io import synthetic as jsynth
from stereo_svo_tpu.ops import align as jalign
from stereo_svo_tpu.ops import depth_filter as jdf
from stereo_svo_tpu.ops import fast as jfast
from stereo_svo_tpu.ops import interp as jinterp
from stereo_svo_tpu.ops import klt as jklt
from stereo_svo_tpu.ops import pyramid as jpyramid
from stereo_svo_tpu.ops import stereo_match as jstereo
from stereo_svo_tpu_torch.backend import loop_closure
from stereo_svo_tpu_torch.config import CameraConfig, SvoConfig
from stereo_svo_tpu_torch.frontend import detector, keyframe, pose_refine
from stereo_svo_tpu_torch.ops import align, depth_filter, fast, interp, klt
from stereo_svo_tpu_torch.ops import stereo_match

CAM_KW = dict(fx=240.0, fy=240.0, cx=188.0, cy=120.0, baseline=0.11,
              width=376, height=240)
CFG_KW = dict(grid_rows=10, grid_cols=13, max_features=130, num_levels=3,
              align_levels=3, klt_levels=3, stereo_max_disp=64,
              kf_min_tracked=40, border_margin=10, use_ba=False)
JCFG = JCfg(camera=JCam(**CAM_KW), **CFG_KW)
CFG = SvoConfig(camera=CameraConfig(**CAM_KW), **CFG_KW)
CAM, JC = CFG.camera, JCFG.camera


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(x):
    return tuple(np.asarray(a) for a in x)


@pytest.fixture(scope="module")
def frames():
    """Three arc frames, the JAX pyramids, and stereo-seeded features."""
    lefts, rights, gt = jsynth.make_sequence(JC, 3, dt=0.12, kind="arc")
    pyrs = [tuple(_np_tree(p) for p in jpyramid.build_with_gradients(
        jnp.asarray(l), JCFG.num_levels)) for l in lefts]
    det = jdetector.detect(tuple(map(jnp.asarray, pyrs[0][0])),
                           jnp.asarray(pyrs[0][1][0]),
                           jnp.asarray(pyrs[0][2][0]), JCFG)
    disp, _, ok = jstereo.match(jnp.asarray(lefts[0]), jnp.asarray(rights[0]),
                                det.uv, JCFG.stereo_max_disp,
                                JCFG.stereo_patch)
    valid = np.asarray(det.valid & ok)
    z = np.where(valid, JCFG.camera.fx * JCFG.camera.baseline
                 / np.maximum(np.asarray(disp), 1e-3), 1.0).astype(np.float32)
    # T_c1c0 from ground truth: T_wc1⁻¹ ∘ T_wc0
    T10 = np.asarray(jse3.compose(jse3.inverse(jnp.asarray(gt[1])),
                                  jnp.asarray(gt[0])))
    return dict(lefts=lefts, rights=rights, gt=gt, pyrs=pyrs,
                uv=np.asarray(det.uv), z=z, valid=valid,
                det=_np_tree(det), T10=T10)


def test_fast_and_edgelet_maps(frames):
    img = frames["pyrs"][0][0][0]
    np.testing.assert_array_equal(
        fast.corner_score(_t(img)).numpy(),
        np.asarray(jfast.corner_score(jnp.asarray(img))))
    gx, gy = frames["pyrs"][0][1][0], frames["pyrs"][0][2][0]
    np.testing.assert_allclose(
        fast.edgelet_score(_t(gx), _t(gy)).numpy(),
        np.asarray(jfast.edgelet_score(jnp.asarray(gx), jnp.asarray(gy))),
        rtol=1e-6)
    for o, r in zip(fast.edgelet_direction(_t(gx), _t(gy)),
                    jfast.edgelet_direction(jnp.asarray(gx), jnp.asarray(gy))):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)


def test_detector_detect(frames):
    levels, gxs, gys = frames["pyrs"][0]
    free = np.random.default_rng(0).uniform(size=130) > 0.3
    ours = detector.detect(tuple(map(_t, levels)), _t(gxs[0]), _t(gys[0]),
                           CFG, _t(free))
    ref = jdetector.detect(tuple(map(jnp.asarray, levels)),
                           jnp.asarray(gxs[0]), jnp.asarray(gys[0]), JCFG,
                           jnp.asarray(free))
    for name in ("uv", "is_corner", "level", "valid"):
        np.testing.assert_array_equal(
            getattr(ours, name).numpy(),
            np.asarray(getattr(ref, name)).astype(
                getattr(ours, name).numpy().dtype), err_msg=name)
    np.testing.assert_allclose(ours.score.numpy(), np.asarray(ref.score),
                               rtol=1e-6)
    np.testing.assert_allclose(ours.grad_dir.numpy(),
                               np.asarray(ref.grad_dir), rtol=1e-6,
                               atol=1e-7)


def test_stereo_match_and_refine(frames):
    left, right = frames["lefts"][0], frames["rights"][0]
    uv = frames["uv"]
    d, s, ok = stereo_match.match(_t(left), _t(right), _t(uv), 64, 8)
    jd, js, jok = jstereo.match(jnp.asarray(left), jnp.asarray(right),
                                jnp.asarray(uv), 64, 8)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.sum() > 60
    # ZNCC scores are float32 dot products of normalised 64-vectors;
    # a score difference of ~1e-6 moves the parabola peak by less than 1e-3
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(d.numpy()[ok.numpy()],
                               np.asarray(jd)[ok.numpy()], atol=2e-3)

    pred = np.where(ok.numpy(), d.numpy(), 20.0) + np.random.default_rng(
        1).uniform(-3, 3, uv.shape[0]).astype(np.float32)
    r = stereo_match.refine_disparity(_t(left), _t(right), _t(uv),
                                      _t(pred), 10, 8)
    jr = jstereo.refine_disparity(jnp.asarray(left), jnp.asarray(right),
                                  jnp.asarray(uv), jnp.asarray(pred), 10, 8)
    np.testing.assert_array_equal(r[2].numpy(), np.asarray(jr[2]))
    m = r[2].numpy()
    np.testing.assert_allclose(r[0].numpy()[m], np.asarray(jr[0])[m],
                               atol=2e-3)
    np.testing.assert_allclose(r[1].numpy(), np.asarray(jr[1]), atol=1e-5)


def _align_template(frames):
    levels, gxs, gys = frames["pyrs"][0]
    mask = frames["valid"]
    ours = align.make_template(tuple(map(_t, levels)), tuple(map(_t, gxs)),
                               tuple(map(_t, gys)), CAM, CFG,
                               _t(frames["uv"]), _t(frames["z"]), _t(mask))
    ref = jalign.make_template(tuple(map(jnp.asarray, levels)),
                               tuple(map(jnp.asarray, gxs)),
                               tuple(map(jnp.asarray, gys)), JC, JCFG,
                               jnp.asarray(frames["uv"]),
                               jnp.asarray(frames["z"]), jnp.asarray(mask))
    return ours, ref


def test_align_make_template(frames):
    ours, ref = _align_template(frames)
    for name, atol in (("p_ref", 1e-5), ("patches", 1e-4), ("jac", 2e-2)):
        # the Jacobians are image gradients (up to ~100) times projection
        # derivatives (up to ~240/z): float32 products of that size
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=atol, err_msg=name)
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))


def test_align(frames):
    _, ref_tmpl = _align_template(frames)
    tmpl = align.Template(*(_t(np.asarray(a)) for a in ref_tmpl))
    T_init = np.asarray(jse3.identity())
    levels = frames["pyrs"][1][0]
    T, stats = align.align(tuple(map(_t, levels)), tmpl, CAM, CFG, _t(T_init))
    jT, jstats = jalign.align(tuple(map(jnp.asarray, levels)), ref_tmpl, JC,
                              JCFG, jnp.asarray(T_init))
    # 15 Gauss-Newton passes from one frame to the next: float32 rounding
    # in the 6x6 solves moves the pose by well under a micrometre/µrad
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=2e-5)
    np.testing.assert_allclose(float(stats["align_cost"]),
                               float(jstats["align_cost"]), rtol=1e-3)
    np.testing.assert_allclose(float(stats["align_inlier_frac"]),
                               float(jstats["align_inlier_frac"]), atol=1e-3)
    # and the alignment recovers the true motion
    np.testing.assert_allclose(T.numpy(), frames["T10"], atol=5e-3)


def test_klt_template_and_track(frames):
    levels0, gxs0, gys0 = frames["pyrs"][0]
    uv, mask = frames["uv"], frames["valid"]
    ours = klt.make_template(tuple(map(_t, levels0)), tuple(map(_t, gxs0)),
                             tuple(map(_t, gys0)), CFG, _t(uv), _t(mask))
    ref = jklt.make_template(tuple(map(jnp.asarray, levels0)),
                             tuple(map(jnp.asarray, gxs0)),
                             tuple(map(jnp.asarray, gys0)), JCFG,
                             jnp.asarray(uv), jnp.asarray(mask))
    for name in klt.KltTemplate._fields:
        np.testing.assert_allclose(
            getattr(ours, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=1e-5, atol=1e-4 if name != "hinv" else 1e-7, err_msg=name)

    # track in frame 1 from the ground-truth prediction, offset by noise
    rng = np.random.default_rng(2)
    X0 = np.asarray(jcamera.backproject(JC, jnp.asarray(uv),
                                        jnp.asarray(frames["z"])))
    uv1 = np.asarray(jcamera.project(JC, jse3.transform(
        jnp.asarray(frames["T10"]), jnp.asarray(X0)))[0])
    uv_init = (uv1 + rng.normal(0, 1.0, uv1.shape)).astype(np.float32)
    corner = np.asarray(frames["det"][2])
    gdir = np.asarray(frames["det"][4])
    levels1 = frames["pyrs"][1][0]
    tmpl = klt.KltTemplate(*(_t(np.asarray(a)) for a in ref))
    u, ok, res, _ = klt.track(tuple(map(_t, levels1)), tmpl, CFG, _t(uv_init),
                              edge_dir=_t(gdir), is_edgelet=_t(~corner))
    ju, jok, jres = jklt.track(tuple(map(jnp.asarray, levels1)), ref, JCFG,
                               jnp.asarray(uv_init),
                               edge_dir=jnp.asarray(gdir),
                               is_edgelet=jnp.asarray(~corner))
    # the convergence gate |Δ|² < eps² can flip for a feature whose last
    # step sits on the threshold; all others agree exactly
    agree = ok.numpy() == np.asarray(jok)
    assert agree.mean() >= 0.97
    assert ok.numpy().sum() > 60
    both = ok.numpy() & np.asarray(jok)
    np.testing.assert_allclose(u.numpy()[both], np.asarray(ju)[both],
                               atol=2e-3)
    np.testing.assert_allclose(res.numpy()[both], np.asarray(jres)[both],
                               rtol=1e-3, atol=1e-3)


def test_pose_refine(frames):
    rng = np.random.default_rng(3)
    uv, z, mask = frames["uv"], frames["z"], frames["valid"]
    X = np.asarray(jcamera.backproject(JC, jnp.asarray(uv), jnp.asarray(z)))
    T_true = frames["T10"]
    uv_obs = np.asarray(jcamera.project(JC, jse3.transform(
        jnp.asarray(T_true), jnp.asarray(X)))[0])
    uv_obs = uv_obs + rng.normal(0, 0.3, uv_obs.shape)
    uv_obs[:5] += 15.0                                  # gross outliers
    uv_obs = uv_obs.astype(np.float32)
    T0 = np.asarray(jse3.retract(jnp.asarray(T_true), jnp.asarray(
        [0.01, -0.01, 0.02, 0.003, -0.002, 0.001], jnp.float32)))
    sigma = np.exp2(rng.integers(0, 2, uv.shape[0])).astype(np.float32)
    disp = (JC.fx * JC.baseline / np.maximum(
        np.asarray(jse3.transform(jnp.asarray(T_true),
                                  jnp.asarray(X)))[:, 2], 0.2)
            + rng.normal(0, 0.2, uv.shape[0])).astype(np.float32)
    dmask = mask & (rng.uniform(size=uv.shape[0]) > 0.2)
    T_prior = np.asarray(jse3.identity())
    kw = dict(obs_sigma=sigma, T_prior=T_prior, disp_obs=disp,
              disp_mask=dmask)
    T, inl, st = pose_refine.refine(CAM, CFG, _t(T0), _t(X), _t(uv_obs),
                                    _t(mask), **{k: _t(v)
                                                 for k, v in kw.items()})
    jT, jinl, jst = jrefine.refine(JC, JCFG, jnp.asarray(T0), jnp.asarray(X),
                                   jnp.asarray(uv_obs), jnp.asarray(mask),
                                   **{k: jnp.asarray(v)
                                      for k, v in kw.items()})
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-5)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    assert int(st["refine_inliers"]) == int(jst["refine_inliers"])
    np.testing.assert_allclose(float(st["refine_rms_px"]),
                               float(jst["refine_rms_px"]), rtol=1e-4)


def _seed_arrays(rng, n=256):
    mu = rng.uniform(0.1, 1.0, n).astype(np.float32)
    sigma2 = rng.uniform(1e-5, 1e-2, n).astype(np.float32)
    a = rng.uniform(1, 20, n).astype(np.float32)
    b = rng.uniform(1, 20, n).astype(np.float32)
    z_range = rng.uniform(0.5, 4.0, n).astype(np.float32)
    active = rng.uniform(size=n) > 0.2
    return mu, sigma2, a, b, z_range, active


def _check_update(ours, ref, rtol=2e-4):
    np.testing.assert_array_equal(ours.updated.numpy(),
                                  np.asarray(ref.updated))
    for name in ("mu", "sigma2", "a", "b"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=1e-7, err_msg=name)


def test_depth_filter_update_family():
    rng = np.random.default_rng(4)
    mu, sigma2, a, b, zr, active = _seed_arrays(rng)
    x = (mu + rng.normal(0, 0.05, mu.shape)).astype(np.float32)
    tau2 = rng.uniform(1e-6, 1e-3, mu.shape).astype(np.float32)
    ours = depth_filter.update(*map(_t, (mu, sigma2, a, b, x, tau2, zr,
                                         active)))
    ref = jdf.update(*map(jnp.asarray, (mu, sigma2, a, b, x, tau2, zr,
                                        active)))
    _check_update(ours, ref)

    z0 = rng.uniform(0.2, 30.0, 64).astype(np.float32)
    lvl = np.exp2(rng.integers(0, 3, 64)).astype(np.float32)
    for o, r in zip(depth_filter.seed_from_stereo(CAM, CFG, _t(z0), _t(lvl)),
                    jdf.seed_from_stereo(JC, JCFG, jnp.asarray(z0),
                                         jnp.asarray(lvl))):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6)
    n_upd = rng.integers(0, 80, mu.shape).astype(np.int32)
    np.testing.assert_array_equal(
        depth_filter.converged(CFG, _t(mu), _t(sigma2)).numpy(),
        np.asarray(jdf.converged(JCFG, jnp.asarray(mu), jnp.asarray(sigma2))))
    np.testing.assert_array_equal(
        depth_filter.diverged(CFG, _t(a), _t(b), _t(n_upd)).numpy(),
        np.asarray(jdf.diverged(JCFG, jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(n_upd))))


def test_depth_filter_observations(frames):
    """Motion triangulation and stereo observation updates on real
    correspondences (frame 0 anchors, frame 1 observations)."""
    rng = np.random.default_rng(5)
    uv, z, valid = frames["uv"], frames["z"], frames["valid"]
    n = uv.shape[0]
    X0 = np.asarray(jcamera.backproject(JC, jnp.asarray(uv), jnp.asarray(z)))
    T_ck = np.broadcast_to(frames["T10"], (n, 3, 4)).astype(np.float32)
    uv1 = np.asarray(jcamera.project(JC, jse3.transform(
        jnp.asarray(T_ck), jnp.asarray(X0)))[0])
    uv1 = (uv1 + rng.normal(0, 0.3, uv1.shape)).astype(np.float32)
    mu = (1.0 / z * rng.uniform(0.9, 1.1, n)).astype(np.float32)
    _, sigma2, a, b, zr, _ = _seed_arrays(rng, n)
    px = np.exp2(rng.integers(0, 2, n)).astype(np.float32)
    args = (T_ck, uv, uv1, mu, sigma2, a, b, zr, valid)
    ours = depth_filter.observe_and_update(CAM, CFG, *map(_t, args),
                                           px_scale=_t(px))
    ref = jdf.observe_and_update(JC, JCFG, *map(jnp.asarray, args),
                                 px_scale=jnp.asarray(px))
    assert ours.updated.numpy().sum() > 30
    # triangulated depths from float32 2x2 solves: ~1e-4 relative
    _check_update(ours, ref, rtol=1e-3)

    tau = depth_filter.compute_tau(_t(T_ck), _t(X0 / np.linalg.norm(
        X0, axis=-1, keepdims=True)), _t(np.linalg.norm(X0, axis=-1)), 0.004)
    jtau = jdf.compute_tau(jnp.asarray(T_ck), jnp.asarray(X0 / np.linalg.norm(
        X0, axis=-1, keepdims=True)), jnp.asarray(np.linalg.norm(X0, axis=-1)),
        0.004)
    np.testing.assert_allclose(tau.numpy(), np.asarray(jtau), rtol=2e-3,
                               atol=1e-6)

    disp = (JC.fx * JC.baseline / np.maximum(np.asarray(jse3.transform(
        jnp.asarray(T_ck), jnp.asarray(X0)))[:, 2], 0.1)
            + rng.normal(0, 0.2, n)).astype(np.float32)
    dok = valid & (rng.uniform(size=n) > 0.1)
    T_kc = np.asarray(jse3.inverse(jnp.asarray(T_ck)))
    args = (T_kc, uv1, disp, dok, mu, sigma2, a, b, zr, valid)
    ours = depth_filter.stereo_observe_and_update(CAM, CFG, *map(_t, args),
                                                  px_scale=_t(px))
    ref = jdf.stereo_observe_and_update(JC, JCFG, *map(jnp.asarray, args),
                                        px_scale=jnp.asarray(px))
    assert ours.updated.numpy().sum() > 30
    _check_update(ours, ref, rtol=1e-4)


@pytest.mark.parametrize("rot_gate", [False, True])
def test_relocalize(frames, rot_gate):
    coarse = [p[0][-1] for p in frames["pyrs"]]
    bank = np.zeros((6, 48), np.float32)
    for i, c in enumerate(coarse):
        bank[i] = np.asarray(jloop.descriptor(jnp.asarray(c), 6, 8))
    valid = np.array([True, True, False, False, False, True])
    bank[5] = np.random.default_rng(6).normal(0, 1, 48)
    bank[5] /= np.linalg.norm(bank[5])
    query = np.asarray(jloop._rotate_image(jnp.asarray(coarse[1]), 0.12))
    for img in (coarse[1], query):
        slot, score = loop_closure.relocalize(
            _t(bank), _t(valid), _t(img), 6, 8, n_rot=2, rot_step=0.15,
            rot_gate=rot_gate)
        jslot, jscore = jloop.relocalize(
            jnp.asarray(bank), jnp.asarray(valid), jnp.asarray(img), 6, 8,
            n_rot=2, rot_step=0.15, rot_gate=jnp.asarray(rot_gate))
        assert int(slot) == int(jslot)
        np.testing.assert_allclose(float(score), float(jscore), atol=1e-5)
    np.testing.assert_allclose(
        loop_closure.rotated_descriptors(_t(coarse[0]), 6, 8,
                                         [-0.3, 0.15]).numpy(),
        np.asarray(jloop.rotated_descriptors(jnp.asarray(coarse[0]), 6, 8,
                                             [-0.3, 0.15])), atol=2e-5)
    np.testing.assert_allclose(
        loop_closure.shifted_descriptors(_t(coarse[2]), 6, 8).numpy(),
        np.asarray(jloop.shifted_descriptors(jnp.asarray(coarse[2]), 6, 8)),
        atol=2e-5)


def test_interp_gather_functions():
    """The gather-path samplers, at points inside, on and beyond the
    border (the reference clamps each tap)."""
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, (40, 60)).astype(np.float32)
    uv = np.stack([rng.uniform(-3, 63, (16, 5)), rng.uniform(-3, 43, (16, 5))],
                  -1).astype(np.float32)
    np.testing.assert_allclose(
        interp.bilinear(_t(img), _t(uv)).numpy(),
        np.asarray(jinterp.bilinear(jnp.asarray(img), jnp.asarray(uv))),
        atol=1e-4)
    for o, r in zip(interp.bilinear_with_grad(_t(img), _t(uv)),
                    jinterp.bilinear_with_grad(jnp.asarray(img),
                                               jnp.asarray(uv))):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-3)
    for o, r in zip(interp.sample_patch_with_grad(_t(img), _t(uv[:, 0]), 4),
                    jinterp.sample_patch_with_grad(jnp.asarray(img),
                                                   jnp.asarray(uv[:, 0]), 4)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-3)
    rows = np.arange(3, dtype=np.float32) - 1.0
    cols = np.arange(7, dtype=np.float32) - 3.5
    np.testing.assert_allclose(
        interp.sample_rect(_t(img), _t(uv[:, 0]), _t(rows), _t(cols)).numpy(),
        np.asarray(jinterp.sample_rect(jnp.asarray(img), jnp.asarray(uv[:, 0]),
                                       jnp.asarray(rows), jnp.asarray(cols),
                                       method="gather")), atol=1e-4)
    for P in (4, 8):
        np.testing.assert_array_equal(interp.patch_coords(P).numpy(),
                                      np.asarray(jinterp.patch_coords(P)))


def test_keyframe_cell_index_and_memory_slot():
    rng = np.random.default_rng(8)
    uv = np.stack([rng.uniform(-5, 380, 64), rng.uniform(-5, 245, 64)],
                  -1).astype(np.float32)
    np.testing.assert_array_equal(
        keyframe.cell_index(CFG, _t(uv)).numpy(),
        np.asarray(jkeyframe.cell_index(JCFG, jnp.asarray(uv))))
    M = 12
    stamps = rng.permutation(100)[:M].astype(np.int32)
    for n_valid, n_prot in ((M, 3), (M, M - 1), (7, 2)):
        valid = np.zeros(M, bool)
        valid[rng.permutation(M)[:n_valid]] = True
        prot = np.zeros(M, bool)
        prot[rng.permutation(M)[:n_prot]] = True
        args = (valid, stamps, prot)
        assert int(keyframe.mem_coverage_slot(*map(_t, args))) == int(
            jkeyframe.mem_coverage_slot(*map(jnp.asarray, args)))
