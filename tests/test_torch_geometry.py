"""Parity of the port's geometry and small solvers with the JAX reference.

Inputs are made with numpy from a fixed seed and fed to both sides; JAX
runs on the CPU (tests/conftest.py). Tolerances are float32 rounding of a
few chained operations unless stated otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_svo_tpu.config import CameraConfig as JCam
from stereo_svo_tpu.geometry import camera as jcam
from stereo_svo_tpu.geometry import se3 as jse3
from stereo_svo_tpu.geometry import triangulate as jtri
from stereo_svo_tpu.ops import solve as jsolve
from stereo_svo_tpu_torch.config import CameraConfig
from stereo_svo_tpu_torch.geometry import camera, se3, triangulate
from stereo_svo_tpu_torch.ops import solve

RNG = np.random.default_rng(7)
CAM_KW = dict(fx=240.0, fy=241.5, cx=188.0, cy=120.0, baseline=0.11,
              width=376, height=240)


def _twists(n, rot_scale=0.5):
    xi = RNG.normal(0, 0.3, (n, 6)).astype(np.float32)
    xi[:, 3:] *= rot_scale
    xi[0] = 0.0                          # θ = 0 exactly
    xi[1, 3:] = [1e-5, -2e-5, 1e-5]      # Taylor branch
    return xi


def _poses(n):
    return np.asarray(jse3.exp(jnp.asarray(_twists(n))))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("fn", ["exp", "exp_so3", "hat", "_V"])
def test_se3_exp_family(fn):
    xi = _twists(64)
    arg = xi if fn == "exp" else xi[:, 3:]
    ours = getattr(se3, fn)(_t(arg)).numpy()
    ref = np.asarray(getattr(jse3, fn)(jnp.asarray(arg)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


def test_se3_log_roundtrip_and_parity():
    T = _poses(64)
    ours = se3.log(_t(T)).numpy()
    ref = np.asarray(jse3.log(jnp.asarray(T)))
    # the 3x3 inverse of V goes through LAPACK on one side and torch's LU
    # on the other: a few ulp more than plain arithmetic
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=2e-6)
    np.testing.assert_allclose(se3.exp(_t(ours)).numpy(), T, atol=2e-5)


@pytest.mark.parametrize("fn", ["compose", "distance"])
def test_se3_binary(fn):
    A, B = _poses(32), _poses(32)[::-1].copy()
    ours = getattr(se3, fn)(_t(A), _t(B))
    ref = getattr(jse3, fn)(jnp.asarray(A), jnp.asarray(B))
    if fn == "distance":
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4,
                                       atol=2e-6)
    else:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-6)


@pytest.mark.parametrize("fn", ["inverse", "adjoint", "rotation",
                                "translation"])
def test_se3_unary(fn):
    T = _poses(32)
    np.testing.assert_allclose(getattr(se3, fn)(_t(T)).numpy(),
                               np.asarray(getattr(jse3, fn)(jnp.asarray(T))),
                               atol=2e-6)


def test_se3_transform_retract_identity():
    T = _poses(16)
    x = RNG.normal(0, 3, (16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        se3.transform(_t(T), _t(x)).numpy(),
        np.asarray(jse3.transform(jnp.asarray(T), jnp.asarray(x))),
        rtol=1e-6, atol=5e-6)
    # one pose against many points (broadcast), as the engine uses it
    np.testing.assert_allclose(
        se3.transform(_t(T[3]), _t(x)).numpy(),
        np.asarray(jse3.transform(jnp.asarray(T[3]), jnp.asarray(x))),
        rtol=1e-6, atol=5e-6)
    xi = _twists(16)
    np.testing.assert_allclose(
        se3.retract(_t(T), _t(xi)).numpy(),
        np.asarray(jse3.retract(jnp.asarray(T), jnp.asarray(xi))), atol=5e-6)
    np.testing.assert_array_equal(se3.identity().numpy(),
                                  np.asarray(jse3.identity()))


def _points(n):
    x = RNG.uniform(-2, 2, (n, 3)).astype(np.float32)
    x[:, 2] = RNG.uniform(0.5, 8.0, n)
    x[0, 2] = -1.0                       # behind the camera
    return x


@pytest.mark.parametrize("level", [0, 2])
def test_camera_projection_and_jacobians(level):
    cam, jc = CameraConfig(**CAM_KW), JCam(**CAM_KW)
    x = _points(64)
    uv, ok = camera.project(cam, _t(x), level)
    juv, jok = jcam.project(jc, jnp.asarray(x), level)
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    for fn in ("proj_jacobian", "proj_pose_jacobian"):
        np.testing.assert_allclose(
            getattr(camera, fn)(cam, _t(x), level).numpy(),
            np.asarray(getattr(jcam, fn)(jc, jnp.asarray(x), level)),
            rtol=1e-5, atol=1e-4)
    z = x[:, 2].copy()
    np.testing.assert_allclose(
        camera.backproject(cam, uv, _t(z), level).numpy(),
        np.asarray(jcam.backproject(jc, juv, jnp.asarray(z), level)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        camera.in_bounds(cam, uv, level, margin=3.0).numpy(),
        np.asarray(jcam.in_bounds(jc, juv, level, margin=3.0)))


def test_camera_disparity_depth():
    cam, jc = CameraConfig(**CAM_KW), JCam(**CAM_KW)
    d = RNG.uniform(0.0, 60.0, 32).astype(np.float32)
    for fn in ("disparity_to_depth", "depth_to_disparity"):
        np.testing.assert_allclose(
            getattr(camera, fn)(cam, _t(d)).numpy(),
            np.asarray(getattr(jcam, fn)(jc, jnp.asarray(d))), rtol=1e-6)


def test_triangulate():
    cam, jc = CameraConfig(**CAM_KW), JCam(**CAM_KW)
    uv = RNG.uniform(0, 300, (32, 2)).astype(np.float32)
    d = RNG.uniform(0.0, 40.0, 32).astype(np.float32)
    p, ok = triangulate.stereo_point(cam, _t(uv), _t(d))
    jp, jok = jtri.stereo_point(jc, jnp.asarray(uv), jnp.asarray(d))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))

    # real two-view correspondences (0.3 m baselines) with pixel-level noise
    xi = RNG.normal(0, 0.05, (32, 6)).astype(np.float32)
    xi[:, 0] += 0.3
    T = np.asarray(jse3.exp(jnp.asarray(xi)))
    X = _points(32)
    X[:, 2] = np.abs(X[:, 2]) + 1.0
    x_cur = np.einsum("nij,nj->ni", T[:, :, :3], X) + T[:, :, 3]
    f_ref = (X / X[:, 2:]).astype(np.float32)
    f_cur = (x_cur / x_cur[:, 2:]
             + RNG.normal(0, 2e-3, (32, 3)) * [1, 1, 0]).astype(np.float32)
    z, ok = triangulate.two_view_depth(_t(T), _t(f_ref), _t(f_cur))
    jz, jok = jtri.two_view_depth(jnp.asarray(T), jnp.asarray(f_ref),
                                  jnp.asarray(f_cur))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=5e-5)


def test_solve_inv2x2_and_chol():
    A = RNG.normal(0, 1, (16, 2, 2)).astype(np.float32)
    A[0] = 0.0                           # singular: the eps guard
    np.testing.assert_allclose(solve.inv2x2(_t(A)).numpy(),
                               np.asarray(jsolve.inv2x2(jnp.asarray(A))),
                               rtol=1e-5)
    M = RNG.normal(0, 1, (7, 6, 6)).astype(np.float32)
    S = M @ M.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)
    S[6] = -np.eye(6)                    # not PD: floored pivot, no raise
    b = RNG.normal(0, 1, (7, 6)).astype(np.float32)
    ours = solve.chol_solve_small(_t(S), _t(b)).numpy()
    ref = np.asarray(jsolve.chol_solve_small(jnp.asarray(S), jnp.asarray(b)))
    np.testing.assert_allclose(ours[:6], ref[:6], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.isfinite(ours), np.isfinite(ref))
    x64 = np.linalg.solve(S[:6].astype(np.float64),
                          b[:6, :, None].astype(np.float64))[..., 0]
    np.testing.assert_allclose(ours[:6], x64, rtol=1e-3, atol=1e-4)


def test_camera_affine_warp_matrix():
    cam, jc = CameraConfig(**CAM_KW), JCam(**CAM_KW)
    uv = RNG.uniform(20, 350, (32, 2)).astype(np.float32)
    z = RNG.uniform(1.0, 10.0, 32).astype(np.float32)
    T = _poses(32)
    np.testing.assert_allclose(
        camera.affine_warp_matrix(cam, _t(uv), _t(z), _t(T)).numpy(),
        np.asarray(jcam.affine_warp_matrix(jc, jnp.asarray(uv),
                                           jnp.asarray(z), jnp.asarray(T))),
        rtol=1e-4, atol=1e-5)
