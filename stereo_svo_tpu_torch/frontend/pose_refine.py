"""Motion-only pose refinement: Gauss-Newton on reprojection (and stereo
disparity) residuals with a motion prior — port of
``stereo_svo_tpu/frontend/pose_refine.py``.

On CUDA :func:`refine` is one launch of ``refine_pose_kernel``
(``ops/kernels/refine_kernel.refine_pose``; under ``vmap``, one for the
batch); its plain version, :func:`refine_plain`, is the chain of PyTorch
ops that the CPU runs."""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import CameraConfig, SvoConfig
from ..geometry import camera, se3
from ..ops import solve
from ..ops.kernels import _build, refine_kernel


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, -1))


def refine(cam: CameraConfig, cfg: SvoConfig, T_cw: torch.Tensor,
           X_world: torch.Tensor, uv_obs: torch.Tensor,
           mask: torch.Tensor, obs_sigma: torch.Tensor | None = None,
           T_prior: torch.Tensor | None = None,
           disp_obs: torch.Tensor | None = None,
           disp_mask: torch.Tensor | None = None,
           obs_sigma_d: torch.Tensor | None = None
           ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Refine T_cw so projected landmarks match observed positions.

    Residual rows are whitened by ``obs_sigma`` (px); ``T_prior`` adds the
    Gaussian motion prior (cfg.refine_prior_*_sig); ``disp_obs`` with
    ``disp_mask`` adds a disparity row per feature (gated by
    cfg.refine_stereo_weight). Returns (T_cw, inlier_mask, stats). On
    CUDA one ``refine_pose_kernel`` launch; on the CPU
    :func:`refine_plain`.
    """
    args = (T_cw, X_world, uv_obs, mask)
    optional = dict(obs_sigma=obs_sigma, T_prior=T_prior, disp_obs=disp_obs,
                    disp_mask=disp_mask, obs_sigma_d=obs_sigma_d)
    if _build.plain(*args, *optional.values()):
        return refine_plain(cam, cfg, *args, **optional)
    return refine_kernel.refine_pose(cam, cfg, *args, **optional)


def refine_plain(cam: CameraConfig, cfg: SvoConfig, T_cw: torch.Tensor,
                 X_world: torch.Tensor, uv_obs: torch.Tensor,
                 mask: torch.Tensor, obs_sigma: torch.Tensor | None = None,
                 T_prior: torch.Tensor | None = None,
                 disp_obs: torch.Tensor | None = None,
                 disp_mask: torch.Tensor | None = None,
                 obs_sigma_d: torch.Tensor | None = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """:func:`refine` as a chain of PyTorch ops (the reference's
    arithmetic); under ``torch.func.vmap`` each op takes the batch."""
    dev = T_cw.device
    sig = torch.ones(X_world.shape[0], device=dev) if obs_sigma is None \
        else obs_sigma
    inv_s2 = 1.0 / (sig * sig)
    sig_d = sig if obs_sigma_d is None else obs_sigma_d
    inv_s2_d = 1.0 / (sig_d * sig_d)
    use_prior = T_prior is not None and cfg.refine_prior_t_sig > 0.0
    use_disp = (disp_obs is not None and disp_mask is not None
                and cfg.refine_stereo_weight > 0.0)
    k = cfg.refine_huber_px
    eye6 = torch.eye(6, device=dev)
    if use_prior:
        # filled on the device: a host list would cost a blocking copy
        lam = torch.cat([
            torch.full((3,), 1.0 / cfg.refine_prior_t_sig ** 2, device=dev),
            torch.full((3,), 1.0 / max(cfg.refine_prior_r_sig, 1e-6) ** 2,
                       device=dev)])
        T_prior_inv = se3.inverse(T_prior)
    fxB = cam.fx * cam.baseline

    def huber(rn):
        return torch.where(rn <= k, torch.ones_like(rn),
                           k / torch.clamp(rn, min=1e-6))

    def residual(T):
        x_c = se3.transform(T, X_world)
        uv_p, front = camera.project(cam, x_c)
        r = uv_p - uv_obs
        w = huber(_norm(r) / sig) * inv_s2 * (mask & front)
        if use_disp:
            r_d = fxB / torch.clamp(x_c[..., 2], min=0.2) - disp_obs
            w_d = (huber(torch.abs(r_d) / sig_d) * inv_s2_d
                   * cfg.refine_stereo_weight * (mask & front & disp_mask))
        else:
            r_d = w_d = None
        return x_c, r, w, r_d, w_d

    def disp_jacobian(x_c):
        """d(fx·B/z)/dξ = −fx·B/z² · [0,0,1,y,−x,0]."""
        z = torch.clamp(x_c[..., 2], min=0.2)
        s = -fxB / (z * z)
        zero = torch.zeros_like(z)
        return s[:, None] * torch.stack(
            [zero, zero, torch.ones_like(z), x_c[..., 1], -x_c[..., 0], zero],
            -1)

    # chunked IRLS, as the reference: exact GN step per refresh, frozen-
    # Jacobian quasi-Newton matvec steps in between
    T = T_cw
    chunks = max(1, min(cfg.refine_irls_chunks, cfg.refine_max_iters))
    inner = max(cfg.refine_max_iters // chunks - 1, 0)
    for _ in range(chunks):
        x_c, r, w, r_d, w_d = residual(T)
        J = camera.proj_pose_jacobian(cam, x_c)             # (N,2,6)
        H = torch.einsum("nri,n,nrj->ij", J, w, J)
        g = torch.einsum("nri,n,nr->i", J, w, r)
        if use_disp:
            Jd = disp_jacobian(x_c)
            H = H + torch.einsum("ni,n,nj->ij", Jd, w_d, Jd)
            g = g + torch.einsum("ni,n,n->i", Jd, w_d, r_d)
        if use_prior:
            xi = se3.log(se3.compose(T, T_prior_inv))
            H = H + torch.diag(lam)
            g = g + lam * xi
        H = H + 1e-8 * eye6 + 1e-4 * torch.trace(H) / 6.0 * eye6
        sol = solve.chol_solve_small(H.expand(7, 6, 6),
                                     torch.cat([eye6, g[None]]))
        Hinv = sol[:6]
        T = se3.compose(se3.exp(-sol[6]), T)
        for _ in range(inner):
            _, r, w_i, r_d_i, w_d_i = residual(T)
            g = torch.einsum("nri,n,nr->i", J, w_i, r)
            if use_disp:
                g = g + torch.einsum("ni,n,n->i", Jd, w_d_i, r_d_i)
            T = se3.compose(se3.exp(-(Hinv @ g)), T)

    x_c = se3.transform(T, X_world)
    uv_p, front = camera.project(cam, x_c)
    err = _norm(uv_p - uv_obs)
    inliers = mask & front & (err < cfg.refine_outlier_px * sig)
    stats = {
        "refine_rms_px": torch.sqrt(
            torch.sum(torch.where(inliers, err * err, torch.zeros_like(err)))
            / torch.clamp(inliers.sum(), min=1)),
        "refine_inliers": inliers.sum().to(torch.int32),
    }
    return T, inliers, stats
