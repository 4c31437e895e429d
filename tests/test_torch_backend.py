"""The port's window BA (``backend/ba.py``) and its solvers
(``ops/solve.inv3x3``, ``cg_solve``) against the JAX reference, on the
multi-view stereo problem of tests/test_backend.py (K=5 keyframes, N=64
landmarks). Window BA inside the engine (``run_window_ba``) is tested in
tests/test_torch_engine.py, on that file's reference run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_svo_tpu.backend import ba as jba
from stereo_svo_tpu.geometry import se3 as jse3
from stereo_svo_tpu.ops import solve as jsolve
from stereo_svo_tpu_torch.backend import ba
from stereo_svo_tpu_torch.config import CameraConfig, SvoConfig
from stereo_svo_tpu_torch.ops import solve
from test_backend import CAM as JCAM
from test_backend import CFG as JCFG
from test_backend import _make_problem

# one intra-op thread: the tier-1 run's parallel workers already fill the
# cores, and oversubscribed torch threads slow every small op ~100×
torch.set_num_threads(1)

CAM = CameraConfig(**dataclasses.asdict(JCAM))
CFG = SvoConfig(camera=CAM, ba_iters=JCFG.ba_iters,
                max_keyframes=JCFG.max_keyframes)
PROBLEMS = {"clean": dict(seed=5), "noisy": dict(px_noise=0.4, drop=0.25,
                                                 seed=6)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, rel, err_msg=""):
    """|ours − ref| ≤ rel · max|ref| elementwise (float32 sums of many
    terms in another order: the error scales with the output's size)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30),
                               err_msg=err_msg)


@pytest.fixture(scope="module", params=list(PROBLEMS))
def problem(request):
    """Numpy BA inputs: T_kw, X, obs_uv, obs_ur, w_rows, obs_sig, plus the
    bundle_adjust inputs (kf_T_wk, obs_mask, disp)."""
    T_wk, X, obs, mask, _, _, disp = _make_problem(**PROBLEMS[request.param])
    K, N = mask.shape
    mask = np.asarray(mask)
    w_rows = np.asarray(jba.obs_weights(jnp.ones(K, bool), jnp.ones(N, bool),
                                        jnp.asarray(mask), jnp.asarray(mask)))
    sig = np.exp2(np.random.default_rng(1).integers(0, 2, (K, N))).astype(
        np.float32)
    return dict(name=request.param, kf_T_wk=np.asarray(T_wk),
                T_kw=np.asarray(jse3.inverse(T_wk)),
                X=np.asarray(X), obs_uv=np.asarray(obs), mask=mask,
                disp=np.asarray(disp),
                obs_ur=np.asarray(obs)[..., 0] - np.asarray(disp),
                w_rows=w_rows, sig=sig)


def test_inv3x3_and_cg_solve():
    rng = np.random.default_rng(0)
    A = rng.normal(0, 1, (64, 3, 3)).astype(np.float32)
    A[:4] = 0.0                                   # singular: eps-guarded det
    np.testing.assert_allclose(solve.inv3x3(_t(A)).numpy(),
                               np.asarray(jsolve.inv3x3(jnp.asarray(A))),
                               rtol=1e-5, atol=1e-5)
    M = rng.normal(0, 1, (6, 30, 30)).astype(np.float32)
    S = (M @ M.transpose(0, 2, 1) + 0.5 * np.eye(30)).astype(np.float32)
    b = rng.normal(0, 1, (6, 30)).astype(np.float32)
    x = solve.cg_solve(_t(S), _t(b), iters=40).numpy()
    jx = np.asarray(jsolve.cg_solve(jnp.asarray(S), jnp.asarray(b), iters=40))
    # 40 float32 CG iterations in another summation order
    np.testing.assert_allclose(x, jx, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.einsum("nij,nj->ni", S, x), b, atol=2e-3)


def test_linearize_and_schur_reduce(problem):
    p = problem
    args = [p[k] for k in ("T_kw", "X", "obs_uv", "obs_ur", "w_rows", "sig")]
    ours = ba._linearize(CAM, CFG, *map(_t, args))
    ref = jba._linearize(JCAM, JCFG, *map(jnp.asarray, args))
    for o, r, name in zip(ours, ref, ("Hpp", "Hll", "Hpl", "gp", "gl",
                                      "cost")):
        # products of Jacobians up to fx/z ≈ 150 summed over 64 landmarks
        _close(o.numpy(), r, 2e-5, name)
    fixed = np.array([1, 0, 0, 0, 0], np.float32)
    ours = ba._schur_reduce(*ours[:5], 1e-3, _t(fixed))
    ref = jba._schur_reduce(*ref[:5], 1e-3, jnp.asarray(fixed))
    for o, r, name in zip(ours, ref, ("S", "rhs", "Hll_inv", "W")):
        # Hll_inv inverts 3×3 landmark blocks whose depth direction is
        # weakly observed (condition numbers ~1e4): input differences of
        # ~1e-7 grow by that factor, in W = Hpl·Hll_inv too; the reduced
        # system S = Σ W·Hplᵀ projects that direction out again
        _close(o.numpy(), r, 1e-3 if name in ("Hll_inv", "W") else 5e-5,
               name)
    S = ours[0].numpy()
    np.testing.assert_array_equal(S[:6, 6:], 0.0)   # exact gauge rows
    np.testing.assert_array_equal(S[:6, :6], np.eye(6))


@pytest.mark.parametrize("solver", ["direct", "cg"])
def test_ba_iteration(problem, solver):
    p = problem
    fixed = np.array([1, 0, 0, 0, 0], np.float32)
    args = [p[k] for k in ("T_kw", "X", "obs_uv", "obs_ur", "w_rows")]
    T, X, cost = ba.ba_iteration(CAM, CFG, *map(_t, args), _t(fixed),
                                 obs_sig=_t(p["sig"]), solver=solver)
    jT, jX, jcost = jba.ba_iteration(JCAM, JCFG, *map(jnp.asarray, args),
                                     jnp.asarray(fixed),
                                     obs_sig=jnp.asarray(p["sig"]),
                                     solver=solver)
    # one Gauss-Newton step from a float32 30×30 reduced system: poses
    # agree to ~1e-6; landmarks move along their weakly observed depth
    # direction (2 cm there is ~0.01 px of residual at 5 m, test_backend)
    # and agree to ~1e-4 m
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-5)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), atol=2e-4)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-5)
    np.testing.assert_array_equal(T.numpy()[0], p["T_kw"][0])   # the gauge


def test_bundle_adjust(problem):
    p = problem
    K, N = p["mask"].shape
    args = (p["kf_T_wk"], np.ones(K, bool), p["X"], np.ones(N, bool),
            p["obs_uv"], p["mask"], p["disp"], p["mask"])
    T, X, stats = ba.bundle_adjust(CAM, CFG, *map(_t, args),
                                   obs_sig=_t(p["sig"]))
    jT, jX, jstats = jax.jit(lambda *a: jba.bundle_adjust(
        JCAM, JCFG, *a[:-1], obs_sig=a[-1]))(
            *map(jnp.asarray, args), jnp.asarray(p["sig"]))
    # six Gauss-Newton steps from identical inputs (landmarks: as above)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=2e-5)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), atol=5e-4)
    c0 = float(jstats.cost_initial)
    np.testing.assert_allclose(float(stats.cost_initial), c0, rtol=1e-5)
    # the clean problem converges to a cost of ~1e-8: judged against c0
    np.testing.assert_allclose(float(stats.cost_final),
                               float(jstats.cost_final), atol=1e-6 * c0)
    assert int(stats.n_obs) == int(jstats.n_obs)
    assert float(stats.cost_final) < 0.5 * float(stats.cost_initial)


def test_bundle_adjust_freezes_observationless_gauge_keyframe():
    """tests/test_backend.py's gauge case: the oldest keyframe lost every
    observation, so it is frozen and the gauge moves to keyframe 1."""
    T_wk, X, obs, mask, _, _, disp = _make_problem(seed=11)
    K, N = mask.shape
    mask = np.asarray(mask).copy()
    mask[0] = False
    stamp = np.arange(K, dtype=np.int32)
    args = (np.asarray(T_wk), np.ones(K, bool), np.asarray(X),
            np.ones(N, bool), np.asarray(obs), mask, np.asarray(disp), mask)
    T, X_out, stats = ba.bundle_adjust(CAM, CFG, *map(_t, args),
                                       kf_stamp=_t(stamp))
    jT, jX, jstats = jax.jit(lambda *a: jba.bundle_adjust(
        JCAM, JCFG, *a[:-1], kf_stamp=a[-1]))(*map(jnp.asarray, args),
                                              jnp.asarray(stamp))
    for k in (0, 1):      # frozen and gauge: where they started (up to
        for out in (T.numpy(), np.asarray(jT)):   # a double inversion)
            np.testing.assert_allclose(out[k], args[0][k], atol=1e-6)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=2e-5)
    np.testing.assert_allclose(X_out.numpy(), np.asarray(jX), atol=5e-4)
    np.testing.assert_allclose(float(stats.cost_final),
                               float(jstats.cost_final),
                               atol=1e-6 * float(jstats.cost_initial))
    assert float(stats.cost_final) < float(stats.cost_initial)


def test_indefinite_reduced_system_gives_the_zero_step(problem):
    """A reduced camera system that is not positive definite: the
    reference's Cholesky returns NaNs and the finite-step guard zeroes the
    step; the port must do the same, without raising."""
    rng = np.random.default_rng(2)
    M = rng.normal(0, 1, (12, 12)).astype(np.float32)
    S = (M + M.T).astype(np.float32)                  # indefinite
    rhs = rng.normal(0, 1, 12).astype(np.float32)
    y = ba._jacobi_cholesky_solve(_t(S), _t(rhs)).numpy()
    d = 1.0 / jnp.sqrt(jnp.maximum(jnp.diagonal(jnp.asarray(S)), 1e-12))
    S_hat = jnp.asarray(S) * d[:, None] * d[None, :]
    jy = np.asarray(jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(S_hat), jnp.asarray(rhs) * d))
    assert np.isnan(y).all() and np.isnan(jy).all()

    # a negative damping makes the whole step's system indefinite
    p = problem
    fixed = np.array([1, 0, 0, 0, 0], np.float32)
    args = [p[k] for k in ("T_kw", "X", "obs_uv", "obs_ur", "w_rows")]
    T, X, _ = ba.ba_iteration(CAM, CFG, *map(_t, args), _t(fixed), lam=-1e6)
    jT, jX, _ = jba.ba_iteration(JCAM, JCFG, *map(jnp.asarray, args),
                                 jnp.asarray(fixed), lam=-1e6)
    for ours, ref, start in ((T, jT, p["T_kw"]), (X, jX, p["X"])):
        np.testing.assert_array_equal(np.asarray(ref), start)
        np.testing.assert_array_equal(ours.numpy(), start)

