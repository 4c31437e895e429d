"""Keyframe-window stereo bundle adjustment: batched Schur-complement
Gauss-Newton — port of ``stereo_svo_tpu/backend/ba.py``.

All (K,N) observation blocks are built at once as dense masked tensors
(absent observations are exact zeros); the 3×3 landmark blocks are
eliminated in closed form and the reduced camera system (6K×6K, 60×60 at
K=10) is solved densely. Every contraction is a float32 einsum (TF32 stays
off, see the package ``__init__``); a three-operand einsum of the reference
is written as the weighted Jacobian times the Jacobian.

The reference's ``lax.scan`` over ``ba_iters`` is a Python loop. Nothing
here reads the device from the host: a failed Cholesky factorisation turns
into the NaN step the reference's ``cho_factor`` gives, which the
finite-step guard then zeroes.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import CameraConfig, SvoConfig
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..ops import solve as solve_ops


class BAStats(NamedTuple):
    cost_initial: torch.Tensor
    cost_final: torch.Tensor
    n_obs: torch.Tensor


def _linearize(cam: CameraConfig, cfg: SvoConfig, T_kw: torch.Tensor,
               X: torch.Tensor, obs_uv: torch.Tensor, obs_ur: torch.Tensor,
               w_rows: torch.Tensor, obs_sig: torch.Tensor | None = None):
    """Residuals and weighted normal-equation blocks for all (K,N) pairs.

    Each observation has up to three rows: left (u, v) and the right
    camera's u. T_kw: (K,3,4) world→KF; X: (N,3); obs_uv: (K,N,2);
    obs_ur: (K,N); w_rows: (K,N,3) row weights; obs_sig: optional (K,N)
    pixel noise that whitens the residuals.
    Returns (Hpp (K,6,6), Hll (N,3,3), Hpl (K,N,6,3), gp (K,6), gl (N,3),
    cost).
    """
    x_c = se3.transform(T_kw[:, None], X[None])            # (K,N,3)
    uv, front = cam_mod.project(cam, x_c)
    # near-plane gate: a sub-25 cm row floods the reduced system
    front = front & (x_c[..., 2] > 0.25)
    z = torch.clamp(x_c[..., 2], min=1e-3)
    u_r = cam.fx * (x_c[..., 0] - cam.baseline) / z + cam.cx
    r = torch.cat([uv - obs_uv, (u_r - obs_ur)[..., None]], -1)  # (K,N,3)

    sig = torch.ones_like(r[..., 0]) if obs_sig is None else obs_sig
    rn = torch.sqrt(torch.sum(r * r * (w_rows > 0), -1) + 1e-12) / sig
    huber = torch.where(rn <= cfg.ba_huber_px, torch.ones_like(rn),
                        cfg.ba_huber_px / torch.clamp(rn, min=1e-6))
    w = w_rows * (huber * front / (sig * sig))[..., None]  # (K,N,3)

    # Jacobians w.r.t. the camera-frame point: left rows + right-u row
    Jproj = cam_mod.proj_jacobian(cam, x_c)                # (K,N,2,3)
    iz = 1.0 / z
    Jr3 = torch.stack([cam.fx * iz, torch.zeros_like(iz),
                       -cam.fx * (x_c[..., 0] - cam.baseline) * iz * iz], -1)
    Jc = torch.cat([Jproj, Jr3[..., None, :]], -2)         # (K,N,3,3)
    # pose columns: d x_c / d(v, w) = [I | -hat(x_c)]
    J_w = -torch.einsum("knri,knij->knrj", Jc, se3.hat(x_c))
    Jp = torch.cat([Jc, J_w], -1)                          # (K,N,3,6)
    Jl = torch.einsum("knri,kij->knrj", Jc, se3.rotation(T_kw))  # (K,N,3,3)

    Jp_w = Jp * w[..., None]
    Jl_w = Jl * w[..., None]
    Hpp = torch.einsum("knri,knrj->kij", Jp_w, Jp)
    Hll = torch.einsum("knri,knrj->nij", Jl_w, Jl)
    Hpl = torch.einsum("knri,knrj->knij", Jp_w, Jl)
    gp = torch.einsum("knri,knr->ki", Jp_w, r)
    gl = torch.einsum("knri,knr->ni", Jl_w, r)
    cost = torch.sum(w * r * r)
    return Hpp, Hll, Hpl, gp, gl, cost


def _add_diag_blocks(S: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """S.at[arange(K), arange(K)].add(blocks) for S (K,K,6,6), blocks
    (K,6,6); off-diagonal blocks are left untouched."""
    K = S.shape[0]
    on_diag = torch.eye(K, dtype=torch.bool, device=S.device)[:, :, None,
                                                                None]
    return torch.where(on_diag, S + blocks[:, None], S)


def _schur_reduce(Hpp, Hll, Hpl, gp, gl, lam, fixed_mask, reduce_fn=None):
    """Eliminate landmarks; return (S (6K,6K), rhs (6K,), Hll_inv, W).

    ``reduce_fn`` sums the pose-side blocks over landmark shards (identity
    on one device; an all-reduce in a distributed solver). Landmark-side
    blocks stay shard-local.
    """
    K = Hpp.shape[0]
    if reduce_fn is None:
        reduce_fn = lambda x: x  # noqa: E731
    I3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    # damped, mask-safe landmark blocks (dead landmarks → identity)
    Hll_d = Hll + (lam + 1e-6) * I3
    deg = torch.diagonal(Hll, dim1=-2, dim2=-1).sum(-1)    # trace
    Hll_d = torch.where((deg > 1e-8)[:, None, None], Hll_d, I3)
    Hll_inv = solve_ops.inv3x3(Hll_d)                      # (N,3,3)

    # S_{k,k'} = δ·Hpp_k − Σ_j Hpl_kj Hll_j⁻¹ Hpl_k'jᵀ
    W = torch.einsum("knij,njl->knil", Hpl, Hll_inv)       # (K,N,6,3)
    S_off = torch.einsum("knil,mnjl->kmij", W, Hpl)        # (K,K,6,6)
    rhs_l = torch.einsum("knil,nl->ki", W, gl)             # (K,6)

    Hpp = reduce_fn(Hpp)
    gp = reduce_fn(gp)
    S_off = reduce_fn(S_off)
    rhs_l = reduce_fn(rhs_l)

    I6 = torch.eye(6, dtype=Hpp.dtype, device=Hpp.device)
    S = _add_diag_blocks(-S_off, Hpp + lam * I6)
    rhs = -(gp - rhs_l)                                    # (K,6)

    # gauge fixing by exact elimination: the fixed poses' rows, columns
    # and rhs are zeroed and their diagonal set to the identity
    free = 1.0 - fixed_mask
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S = _add_diag_blocks(S, fixed_mask[:, None, None] * I6)
    rhs = rhs * free[:, None]
    return (S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K), rhs.reshape(6 * K),
            Hll_inv, W)


def _jacobi_cholesky_solve(S: torch.Tensor, rhs: torch.Tensor
                           ) -> torch.Tensor:
    """Solve S x = rhs by a Jacobi-scaled Cholesky factorisation of the
    upper triangle (the reference's ``cho_factor``, lower=False). A matrix
    that is not positive definite gives an all-NaN solution, as the
    reference's factorisation does, with no host sync."""
    d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-12))
    S_hat = S * d[:, None] * d[None, :]
    with solve_ops.batched_linalg(S_hat):
        U, info = torch.linalg.cholesky_ex(S_hat, upper=True)
    y = solve_ops.cholesky_solve_upper(U, (rhs * d)[:, None])[:, 0]
    y = torch.where(info == 0, y, torch.full_like(y, float("nan")))
    return y * d


def ba_iteration(cam: CameraConfig, cfg: SvoConfig, T_kw: torch.Tensor,
                 X: torch.Tensor, obs_uv: torch.Tensor, obs_ur: torch.Tensor,
                 w_rows: torch.Tensor, fixed_mask: torch.Tensor,
                 lam: float = 1e-3, reduce_fn=None,
                 obs_sig: torch.Tensor | None = None,
                 solver: str = "direct"):
    """One damped Gauss-Newton step. Returns (T_kw', X', cost_before).

    solver: "direct" (a dense Cholesky of the reduced camera system) or
    "cg" (40 Jacobi-preconditioned CG iterations).
    """
    K = T_kw.shape[0]
    Hpp, Hll, Hpl, gp, gl, cost = _linearize(
        cam, cfg, T_kw, X, obs_uv, obs_ur, w_rows, obs_sig)
    S, rhs, Hll_inv, W = _schur_reduce(Hpp, Hll, Hpl, gp, gl, lam,
                                       fixed_mask, reduce_fn)
    if solver == "direct":
        dp = _jacobi_cholesky_solve(S, rhs).reshape(K, 6)
    else:
        dp = solve_ops.cg_solve(S, rhs, iters=40).reshape(K, 6)
    # back-substitute landmarks: δl = -Hll⁻¹ (gl + Hlpᵀ·δp)
    Hlp_dp = torch.einsum("knij,ki->nj", Hpl, dp)          # (N,3)
    dl = -torch.einsum("nij,nj->ni", Hll_inv, gl + Hlp_dp)
    dl = torch.clamp(dl, -1.0, 1.0)
    dp = dp * (1.0 - fixed_mask)[:, None]
    # finite-step guard: a non-finite solve costs this iteration only;
    # poses as a whole, landmarks per row
    dp = torch.where(torch.all(torch.isfinite(dp)), dp, torch.zeros_like(dp))
    dl = torch.where(torch.all(torch.isfinite(dl), -1, keepdim=True), dl,
                     torch.zeros_like(dl))
    return se3.compose(se3.exp(dp), T_kw), X + dl, cost


def obs_weights(kf_valid: torch.Tensor, X_mask: torch.Tensor,
                obs_mask: torch.Tensor, obs_dmask: torch.Tensor
                ) -> torch.Tensor:
    """(K,N,3) per-row weights: rows 0-1 = left (u,v), row 2 = stereo u_r."""
    base = obs_mask & kf_valid[:, None] & X_mask[None]
    w_lr = base.to(torch.float32)
    w_st = (base & obs_dmask).to(torch.float32)
    return torch.stack([w_lr, w_lr, w_st], -1)


def bundle_adjust(cam: CameraConfig, cfg: SvoConfig,
                  kf_T_wk: torch.Tensor, kf_valid: torch.Tensor,
                  X: torch.Tensor, X_mask: torch.Tensor,
                  obs_uv: torch.Tensor, obs_mask: torch.Tensor,
                  obs_disp: torch.Tensor | None = None,
                  obs_dmask: torch.Tensor | None = None,
                  obs_sig: torch.Tensor | None = None,
                  kf_stamp: torch.Tensor | None = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor, BAStats]:
    """Window BA over the keyframe ring and the landmark set.

    obs_disp: (K,N) measured disparities (right u = obs_uv[...,0] − disp);
    without them the solve is monocular. Gauge: the oldest constrained
    keyframe (by ``kf_stamp`` when given) is held fixed, and keyframes with
    fewer than 4 live observations are frozen.
    Returns (kf_T_wk', X', BAStats).
    """
    K = kf_T_wk.shape[0]
    T_kw = se3.inverse(kf_T_wk)
    if obs_disp is None:
        obs_disp = torch.zeros_like(obs_uv[..., 0])
        obs_dmask = torch.zeros_like(obs_mask)
    obs_ur = obs_uv[..., 0] - obs_disp
    w_rows = obs_weights(kf_valid, X_mask, obs_mask, obs_dmask)

    n_obs_k = torch.sum(w_rows[..., 0] > 0, 1)             # (K,)
    constrained = kf_valid & (n_obs_k >= 4)
    if kf_stamp is not None:
        first_valid = torch.argmin(torch.where(
            constrained, kf_stamp, torch.full_like(kf_stamp, 2 ** 30)))
    else:
        first_valid = torch.argmax(constrained.to(torch.int32))
    fixed_mask = (torch.arange(K, device=kf_T_wk.device)
                  == first_valid).to(torch.float32)
    fixed_mask = torch.clamp(
        fixed_mask + (1.0 - constrained.to(torch.float32)), 0.0, 1.0)

    cost_initial = None
    for _ in range(cfg.ba_iters):
        T_kw, X, cost = ba_iteration(cam, cfg, T_kw, X, obs_uv, obs_ur,
                                     w_rows, fixed_mask, obs_sig=obs_sig)
        if cost_initial is None:
            cost_initial = cost
    *_, cost_final = _linearize(cam, cfg, T_kw, X, obs_uv, obs_ur, w_rows,
                                obs_sig)
    stats = BAStats(cost_initial=cost_initial, cost_final=cost_final,
                    n_obs=torch.sum(w_rows[..., 0] > 0))
    return se3.inverse(T_kw), X, stats


__all__ = ["BAStats", "ba_iteration", "bundle_adjust", "obs_weights"]
