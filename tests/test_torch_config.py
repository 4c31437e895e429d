"""The port keeps its own copies of the reference's host modules
``config.py`` and ``eval/ate.py``: held equal to the reference here, so no
knob and no metric can drift between the two packages."""

import dataclasses

import numpy as np
import pytest

from stereo_svo_tpu import config as jconfig
from stereo_svo_tpu.eval import ate as jate
from stereo_svo_tpu_torch import config
from stereo_svo_tpu_torch.eval import ate


def _fields(cls):
    return [(f.name, f.type, f.default,
             f.default_factory().__class__.__name__
             if f.default_factory is not dataclasses.MISSING else None)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("what", [
    "CameraConfig", "SvoConfig", "SvoConfig()", "euroc_config()",
    "kitti_config()", "stress_config()", "docstrings"])
def test_config_copy_matches_reference(what):
    if what in ("CameraConfig", "SvoConfig"):
        ours, ref = getattr(config, what), getattr(jconfig, what)
        assert _fields(ours) == _fields(ref)
        assert ours.__doc__ == ref.__doc__
        assert ours.__dataclass_params__.frozen
        return
    if what == "docstrings":
        for name in ("euroc_config", "kitti_config", "stress_config"):
            assert getattr(config, name).__doc__ == \
                getattr(jconfig, name).__doc__
        for prop in ("thumb_level", "klt_big_patch"):
            assert getattr(config.SvoConfig, prop).__doc__ == \
                getattr(jconfig.SvoConfig, prop).__doc__
        return
    name = what[:-2]
    ours = getattr(config, name)() if name != "SvoConfig" else \
        config.SvoConfig()
    ref = getattr(jconfig, name)() if name != "SvoConfig" else \
        jconfig.SvoConfig()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for prop in ("thumb_level", "thumb_shape", "desc_dim", "klt_big_patch"):
        assert getattr(ours, prop) == getattr(ref, prop)
    assert ours.camera.shape == ref.camera.shape


def test_config_post_init_rules_match_reference():
    for mod in (config, jconfig):
        with pytest.raises(ValueError):
            mod.SvoConfig(epi_samples=4, epi_level=3, klt_levels=3)
        with pytest.raises(AssertionError):
            mod.SvoConfig(align_levels=5)


def _trajectories(seed, n=40):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.normal(0, 0.1, (n, 3)), 0)
    w = np.cumsum(rng.normal(0, 0.02, (n, 3)), 0)
    T = np.zeros((n, 3, 4))
    for i in range(n):
        th = np.linalg.norm(w[i])
        k = w[i] / max(th, 1e-12)
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        T[i, :, :3] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        T[i, :, 3] = t[i]
    noisy = T.copy()
    noisy[:, :, 3] += rng.normal(0, 0.02, (n, 3))
    noisy[:, :, :3] = T[:, :, :3] @ np.linalg.qr(
        np.eye(3) + rng.normal(0, 1e-3, (3, 3)))[0]
    return noisy, T


@pytest.mark.parametrize("seed", [0, 1])
def test_ate_copy_matches_reference(seed):
    est, gt = _trajectories(seed)
    pe, pg = ate.positions(est), ate.positions(gt)
    np.testing.assert_array_equal(pe, jate.positions(est))
    for with_scale in (False, True):
        for a, b in zip(ate.align_umeyama(pe, pg, with_scale),
                        jate.align_umeyama(pe, pg, with_scale)):
            np.testing.assert_array_equal(a, b)
        assert ate.ate_rmse(pe, pg, with_scale=with_scale) == \
            jate.ate_rmse(pe, pg, with_scale=with_scale)
    assert ate.ate_rmse(pe, pg, align=False) == \
        jate.ate_rmse(pe, pg, align=False)
    for delta in (1, 5):
        assert ate.rpe(est, gt, delta) == jate.rpe(est, gt, delta)
