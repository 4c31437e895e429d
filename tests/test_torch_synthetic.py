"""The port's synthetic renderer (``io/synthetic.py``) against the JAX
reference: every scene, anti-aliasing, every trajectory kind, exact depth,
the deterministic part of the photometric perturbation, and the sequence
options (dynamic scene, motion blur, perturbation).

Tolerance of the renders: as tests/test_torch_engine.py's
``test_renderer_matches_reference`` — 24 float32 sines of phases up to
~100 rad round differently by ~1e-5 rad in the two implementations. On a
sphere the depth is a root of a quadratic, −b − √disc, whose cancellation
leaves a few ulp of relative error in the texture coordinates: a handful
of sphere pixels then differ by up to ~0.1 of an intensity level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_svo_tpu.config import CameraConfig as JCam
from stereo_svo_tpu.io import synthetic as jsynth
from stereo_svo_tpu_torch.config import CameraConfig
from stereo_svo_tpu_torch.io import synthetic

# one intra-op thread: the tier-1 run's parallel workers already fill the
# cores, and oversubscribed torch threads slow every small op ~100×
torch.set_num_threads(1)

CAM_KW = dict(fx=240.0, fy=240.0, cx=188.0, cy=120.0, baseline=0.11,
              width=376, height=240)
CAM, JC = CameraConfig(**CAM_KW), JCam(**CAM_KW)
# a KITTI-shaped camera at a fifth of KITTI's size (1241×376 → 248×75)
ROAD_KW = dict(fx=143.77, fy=143.77, cx=121.44, cy=37.04, baseline=0.537,
               width=248, height=75)
KINDS = ("arc", "loop", "kitti", "spin", "loop_far", "still")


def _assert_render_close(ours, ref, spheres=False):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=0.25 if spheres else 2e-2)
    assert np.mean(np.abs(ours - ref)) < 2e-3


@pytest.mark.parametrize("scene_kind,traj,t,aa", [
    ("road", "kitti", 1.6, 1), ("road", "kitti", 1.6, 2),
    ("road_long", "kitti", 4.0, 1), ("clutter", "arc", 0.84, 1),
    ("clutter", "spin", 2.0, 1)])
def test_scene_renders_match_reference(scene_kind, traj, t, aa):
    kw = ROAD_KW if scene_kind.startswith("road") else CAM_KW
    T = synthetic.trajectory_pose(torch.tensor(t), traj)
    jT = jsynth.trajectory_pose(jnp.asarray(t, jnp.float32), traj)
    ours = synthetic.render_stereo(CameraConfig(**kw), T,
                                   synthetic.get_scene(scene_kind, 3,
                                                       device="cpu"), aa=aa)
    ref = jsynth.render_stereo(JCam(**kw), jT,
                               jsynth.get_scene(scene_kind, 3), aa=aa)
    for o, r in zip(ours, ref):
        _assert_render_close(o, r, spheres=scene_kind == "clutter")


def test_dynamic_scene_moves_and_matches_reference():
    T = synthetic.trajectory_pose(torch.tensor(0.5), "arc")
    jT = jsynth.trajectory_pose(jnp.asarray(0.5, jnp.float32), "arc")
    imgs = []
    for t in (0.0, 6.0):
        ours = synthetic.render_view(
            CAM, T, synthetic.dynamic_scene(0, t, device="cpu"))
        _assert_render_close(ours, jsynth.render_view(
            JC, jT, jsynth.dynamic_scene(0, t)), spheres=True)
        imgs.append(ours.numpy())
    # the mover sphere crossed part of the view, the rest is static
    moved = np.abs(imgs[0] - imgs[1]) > 1.0
    assert 0.01 < moved.mean() < 0.5


@pytest.mark.parametrize("kind", KINDS)
def test_trajectory_kinds_match_reference(kind):
    ts = np.asarray([0.0, 0.37, 2.5, 11.0], np.float32)
    ours = synthetic.trajectory_pose(torch.from_numpy(ts), kind)
    ref = np.stack([np.asarray(jsynth.trajectory_pose(jnp.asarray(t), kind))
                    for t in ts])
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-6)
    with pytest.raises(ValueError):
        synthetic.trajectory_pose(torch.tensor(0.0), "circle")


def test_gt_depth_matches_reference():
    rng = np.random.default_rng(0)
    uv = np.stack([rng.uniform(0, 376, 500), rng.uniform(0, 240, 500)],
                  -1).astype(np.float32)
    for kind, t in (("clutter", 1.0), ("road", 0.3), ("planes", 0.0)):
        T = synthetic.trajectory_pose(torch.tensor(t), "arc")
        jT = jsynth.trajectory_pose(jnp.asarray(t, jnp.float32), "arc")
        z = synthetic.gt_depth(CAM, T, torch.from_numpy(uv),
                               synthetic.get_scene(kind, 1, device="cpu")).numpy()
        jz = np.asarray(jsynth.gt_depth(JC, jT, jnp.asarray(uv),
                                        jsynth.get_scene(kind, 1)))
        # sphere depths: the quadratic's cancellation (module docstring)
        np.testing.assert_allclose(z, jz, rtol=1e-5)
        assert np.isfinite(z).all() and (z > 0.1).all()


def test_perturb_stereo_deterministic_part():
    """With the gain, bias and noise jitters at 0 the perturbation is the
    vignette and the clip to [0, 255]: both implementations agree."""
    rng = np.random.default_rng(1)
    left, right = (rng.uniform(-20.0, 300.0, (48, 64)).astype(np.float32)
                   for _ in range(2))
    kw = dict(gain_jitter=0.0, bias_jitter=0.0, noise_sigma=0.0)
    ours = synthetic.perturb_stereo(torch.from_numpy(left),
                                    torch.from_numpy(right),
                                    torch.Generator().manual_seed(0), **kw)
    ref = jsynth.perturb_stereo(jnp.asarray(left), jnp.asarray(right),
                                jax.random.PRNGKey(0), **kw)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4)
    assert float(ours[0].min()) == 0.0 and float(ours[0].max()) == 255.0


def test_make_sequence_options():
    """Motion blur against the reference; the dynamic scene per frame (the
    scene itself is checked against the reference above); perturbation by
    its statistics (the random draws differ by design)."""
    kw = dict(fx=80.0, fy=80.0, cx=48.0, cy=32.0, baseline=0.11, width=96,
              height=64)
    cam = CameraConfig(**kw)
    args = dict(n_frames=2, dt=0.25, kind="arc", seed=2, device="cpu")
    ours = synthetic.make_sequence(cam, **args, motion_blur=0.5)
    ref = jsynth.make_sequence(JCam(**kw), n_frames=2, dt=0.25, kind="arc",
                               seed=2, motion_blur=0.5)
    for o, r in zip(ours[:2], ref[:2]):
        _assert_render_close(o, r)
    np.testing.assert_allclose(ours[2].numpy(), ref[2], atol=2e-6)

    dyn = synthetic.make_sequence(cam, **args, scene_kind="dynamic")
    for i in range(2):
        view = synthetic.render_stereo(cam, dyn[2][i], synthetic.dynamic_scene(
            2, torch.tensor(i * 0.25), device="cpu"))
        assert torch.equal(dyn[0][i], view[0])
        assert torch.equal(dyn[1][i], view[1])

    clean = synthetic.make_sequence(cam, **args)
    noisy = synthetic.make_sequence(cam, **args, perturb=True)
    again = synthetic.make_sequence(cam, **args, perturb=True)
    assert torch.equal(noisy[0], again[0])           # seeded generator
    assert float(noisy[0].min()) >= 0.0 and float(noisy[0].max()) <= 255.0
    diff = (noisy[0] - clean[0]).numpy()
    assert 1.0 < diff.std() < 40.0
    assert not torch.equal(noisy[0][0], noisy[0][1])
