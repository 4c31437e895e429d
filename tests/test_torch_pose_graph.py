"""The port's pose graph (``backend/pose_graph.py``) against the JAX
reference: chain graphs (slot order and stamp order, the ring case of
tests/test_loop_closure.py), residuals, the forward-mode Jacobian, and
Gauss-Newton on a seeded 12-slot graph with loop edges, invalid slots and
the gauge given as a 0-dim tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_svo_tpu.backend import pose_graph as jpg
from stereo_svo_tpu.geometry import se3 as jse3
from stereo_svo_tpu_torch.backend import pose_graph as pg

# one intra-op thread: the tier-1 run's parallel workers already fill the
# cores, and oversubscribed torch threads slow every small op ~100×
torch.set_num_threads(1)

K = 12
INVALID = [4, 9]
FIXED = 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _poses(rng, n, scale=0.3):
    return np.stack([np.asarray(jse3.exp(jnp.asarray(x))) for x in
                     rng.normal(0, scale, (n, 6)).astype(np.float32)])


@pytest.fixture(scope="module")
def problem():
    """12 poses (slots 4 and 9 invalid), stamps in a shuffled slot order,
    the stamp chain plus 5 loop edges whose measurements carry noise."""
    rng = np.random.default_rng(0)
    T = _poses(rng, K)
    valid = np.ones(K, bool)
    valid[INVALID] = False
    stamp = (rng.permutation(K) * 5).astype(np.int32)
    chain = jpg.chain_graph_stamped(jnp.asarray(T), jnp.asarray(valid),
                                    jnp.asarray(stamp))
    ij = rng.integers(0, K, (5, 2)).astype(np.int32)
    noise = _poses(rng, 5, scale=0.05)
    Z = np.stack([np.asarray(jse3.compose(jse3.compose(
        jse3.inverse(jnp.asarray(T[a])), jnp.asarray(T[b])),
        jnp.asarray(n))) for (a, b), n in zip(ij, noise)])
    edges = np.concatenate([np.asarray(chain.edges_ij), ij])
    Zs = np.concatenate([np.asarray(chain.Z), Z])
    w = np.concatenate([np.asarray(chain.weight),
                        np.array([1, 1, 0.5, 2, 0], np.float32)])
    return dict(T=T, valid=valid, stamp=stamp, edges=edges, Z=Zs, w=w)


def _graphs(p):
    return (jpg.PoseGraph(*map(jnp.asarray, (p["edges"], p["Z"], p["w"]))),
            pg.PoseGraph(*map(_t, (p["edges"], p["Z"], p["w"]))))


def test_chain_graph_matches_reference():
    rng = np.random.default_rng(1)
    T = _poses(rng, 6)
    valid = np.array([True, True, False, True, True, True])
    ref = jpg.chain_graph(jnp.asarray(T), jnp.asarray(valid))
    ours = pg.chain_graph(_t(T), _t(valid))
    np.testing.assert_array_equal(ours.edges_ij.numpy(), ref.edges_ij)
    np.testing.assert_array_equal(ours.weight.numpy(), ref.weight)
    np.testing.assert_allclose(ours.Z.numpy(), np.asarray(ref.Z), atol=1e-6)


def test_chain_graph_stamped_ring_case():
    """tests/test_loop_closure.py:226-239: slot order is not stamp order;
    the active edges follow the stamps, in both packages."""
    T = np.stack([np.asarray(jse3.exp(jnp.asarray([float(i), 0, 0, 0, 0, 0])))
                  for i in range(4)])
    valid = np.array([True, True, True, False])
    stamp = np.array([50, 10, 30, 0], np.int32)
    ref = jpg.chain_graph_stamped(jnp.asarray(T), jnp.asarray(valid),
                                  jnp.asarray(stamp))
    ours = pg.chain_graph_stamped(_t(T), _t(valid), _t(stamp))
    active = [tuple(e) for e, w in zip(ours.edges_ij.tolist(),
                                       ours.weight.tolist()) if w > 0]
    assert active == [(1, 2), (2, 0)]
    assert ours.edges_ij.dtype == torch.int32
    np.testing.assert_array_equal(ours.edges_ij.numpy(), ref.edges_ij)
    np.testing.assert_array_equal(ours.weight.numpy(), ref.weight)
    np.testing.assert_allclose(ours.Z.numpy(), np.asarray(ref.Z), atol=1e-6)


def test_chain_graph_stamped_matches_reference(problem):
    """Shuffled stamps with invalid slots: the same order (a stable sort,
    invalid slots last) and the same measurements."""
    p = problem
    ref = jpg.chain_graph_stamped(*map(jnp.asarray, (p["T"], p["valid"],
                                                     p["stamp"])))
    ours = pg.chain_graph_stamped(*map(_t, (p["T"], p["valid"],
                                            p["stamp"])))
    np.testing.assert_array_equal(ours.edges_ij.numpy(), ref.edges_ij)
    np.testing.assert_array_equal(ours.weight.numpy(), ref.weight)
    assert ours.weight.sum() == K - len(INVALID) - 1
    np.testing.assert_allclose(ours.Z.numpy(), np.asarray(ref.Z), atol=2e-6)


def test_residual_matches_reference(problem):
    jg, g = _graphs(problem)
    ref = jpg._residual(jnp.asarray(problem["T"]), jg)
    ours = pg._residual(_t(problem["T"]), g)
    # log of noisy relative poses: float32, a few ulps of the rotation
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-6)


def test_jacobian_matches_jax_jacfwd(problem):
    """torch.func.jacfwd of the weighted residual at ξ = 0 equals
    jax.jacfwd of the reference's (pose_graph.py:86-94), within 1e-4."""
    jg, g = _graphs(problem)
    T = problem["T"]

    def jres(xi):
        Tp = jax.vmap(lambda d, t: jse3.compose(jse3.exp(d), t))(
            xi.reshape(K, 6), jnp.asarray(T))
        return (jpg._residual(Tp, jg)
                * jnp.sqrt(jg.weight)[:, None]).reshape(-1)

    ref = np.asarray(jax.jacfwd(jres)(jnp.zeros(6 * K, jnp.float32)))
    J, r = pg._linearize(_t(T), g)
    assert J.shape == (6 * len(problem["w"]), 6 * K)
    assert torch.all(torch.isfinite(J))
    np.testing.assert_allclose(J.numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(r.numpy(), np.asarray(jres(jnp.zeros(
        6 * K, jnp.float32))), atol=2e-6)


@pytest.mark.parametrize("fixed_tensor", [False, True])
def test_optimize_matches_reference(problem, fixed_tensor):
    """Ten Gauss-Newton steps: invalid and pinned slots unchanged, poses
    within 2e-5 and the cost within 1e-5 relative of the reference (the
    1e12 pin in float32 leaves the solve to LU pivoting that differs
    between LAPACK and XLA); the gauge as an int or a 0-dim tensor."""
    jg, g = _graphs(problem)
    T, valid = problem["T"], problem["valid"]
    T_ref, c_ref = jpg.optimize(jnp.asarray(T), jnp.asarray(valid), jg,
                                n_iters=10, fixed=FIXED)
    fixed = torch.tensor(FIXED) if fixed_tensor else FIXED
    T_opt, cost = pg.optimize(_t(T), _t(valid), g, n_iters=10, fixed=fixed)
    pinned = INVALID + [FIXED]
    np.testing.assert_array_equal(T_opt.numpy()[pinned], T[pinned])
    np.testing.assert_allclose(T_opt.numpy(), np.asarray(T_ref), atol=2e-5)
    assert float(cost) == pytest.approx(float(c_ref), rel=1e-5)
    moved = np.abs(T_opt.numpy() - T).max()
    assert moved > 1e-2, "the loop edges moved the free poses"
    c0 = float(torch.sum(pg._residual(_t(T), g) ** 2 * g.weight[:, None]))
    assert float(cost) < c0
