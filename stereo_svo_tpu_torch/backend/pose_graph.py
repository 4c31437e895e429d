"""Pose-graph optimisation over keyframe chains, Gauss-Newton — port of
``stereo_svo_tpu/backend/pose_graph.py``.

Edges carry measured relative poses (odometry and loop closures); the
solver refines absolute keyframe poses T_wk minimising

    Σ_e w_e || log( Z_e⁻¹ ∘ T_{i(e)}⁻¹ ∘ T_{j(e)} ) ||²

over a fixed-capacity edge list (weight 0 = inactive). As in the reference,
the (6E, 6K) Jacobian is the forward-mode derivative of the weighted
residual at ξ = 0 (``torch.func.jacfwd``), and the gauge slot and invalid
slots are pinned with 1e12 on the diagonal. The solve is
``torch.linalg.solve_ex``, which checks nothing and so never syncs the host:
the online loop calls this inside a keyframe frame.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..geometry import se3

_PIN = 1e12


class PoseGraph(NamedTuple):
    edges_ij: torch.Tensor   # (E,2) int32 — indices (i, j) into the poses
    Z: torch.Tensor          # (E,3,4) measured T_i←j (j in i's frame)
    weight: torch.Tensor     # (E,) edge weights (0 = inactive)


def _relative(Ti: torch.Tensor, Tj: torch.Tensor) -> torch.Tensor:
    return se3.compose(se3.inverse(Ti), Tj)


def chain_graph(T_wk: torch.Tensor, valid: torch.Tensor) -> PoseGraph:
    """Odometry chain edges (k, k+1) from the current pose estimates."""
    K = T_wk.shape[0]
    i = torch.arange(K - 1, dtype=torch.int32, device=T_wk.device)
    w = (valid[:-1] & valid[1:]).to(torch.float32)
    return PoseGraph(edges_ij=torch.stack([i, i + 1], -1),
                     Z=_relative(T_wk[:-1], T_wk[1:]), weight=w)


def chain_graph_stamped(T_wk: torch.Tensor, valid: torch.Tensor,
                        stamp: torch.Tensor) -> PoseGraph:
    """Odometry chain edges between temporally consecutive keyframes (slot
    order is not temporal order once the ring reuses a slot): K-1 edges,
    the invalid tail masked."""
    K = T_wk.shape[0]
    big = torch.full_like(stamp, torch.iinfo(torch.int32).max)
    order = torch.argsort(torch.where(valid, stamp, big), stable=True)
    i, j = order[:-1], order[1:]
    n = valid.sum()
    w = (torch.arange(K - 1, device=T_wk.device) < n - 1).to(torch.float32)
    return PoseGraph(edges_ij=torch.stack([i, j], -1).to(torch.int32),
                     Z=_relative(T_wk[i], T_wk[j]), weight=w)


def _residual(T_wk: torch.Tensor, graph: PoseGraph) -> torch.Tensor:
    """(E,6) residuals of all edges."""
    e = graph.edges_ij.long()
    rel = _relative(T_wk[e[:, 0]], T_wk[e[:, 1]])
    return se3.log(se3.compose(se3.inverse(graph.Z), rel))


def _weighted_residual(xi_flat: torch.Tensor, T_wk: torch.Tensor,
                       graph: PoseGraph) -> torch.Tensor:
    """(6E,) residuals, each edge's scaled by √weight, at the poses
    exp(ξ_k) ∘ T_k (ξ: (6K,) left perturbations)."""
    T_pert = se3.compose(se3.exp(xi_flat.reshape(-1, 6)), T_wk)
    return (_residual(T_pert, graph)
            * torch.sqrt(graph.weight)[:, None]).reshape(-1)


def _linearize(T_wk: torch.Tensor, graph: PoseGraph):
    """(J (6E, 6K), r (6E,)) of the weighted residual at ξ = 0."""
    zero = torch.zeros(6 * T_wk.shape[0], dtype=T_wk.dtype,
                       device=T_wk.device)
    J = torch.func.jacfwd(_weighted_residual)(zero, T_wk, graph)
    return J, _weighted_residual(zero, T_wk, graph)


def optimize(T_wk: torch.Tensor, valid: torch.Tensor, graph: PoseGraph,
             n_iters: int = 10, fixed=0, lam: float = 1e-6
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton over absolute poses; pose ``fixed`` (an int or a 0-dim
    device tensor) pins the gauge. Returns (T_wk optimised, final cost)."""
    K = T_wk.shape[0]
    dtype, dev = T_wk.dtype, T_wk.device
    pin = (torch.arange(K, device=dev) == fixed) | ~valid
    damp = (lam * torch.eye(6 * K, dtype=dtype, device=dev)
            + torch.diag(pin.to(dtype).repeat_interleave(6) * _PIN))
    T = T_wk
    for _ in range(n_iters):
        J, r = _linearize(T, graph)
        dx = torch.linalg.solve_ex(J.T @ J + damp, J.T @ r).result
        T = se3.compose(se3.exp(-dx.reshape(K, 6)), T)
    final = torch.sum(_residual(T, graph) ** 2 * graph.weight[:, None])
    return T, final
