"""Batched recursive depth filters (Gaussian × Beta inverse-depth model) —
port of ``stereo_svo_tpu/ops/depth_filter.py``. Every update is one masked
elementwise pass over all N seeds; the epipolar search samples its N·S
probe patches with kernel B3 in one launch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..config import CameraConfig, SvoConfig
from ..geometry import camera as cam_mod
from ..geometry import se3, triangulate
from . import interp


class SeedUpdate(NamedTuple):
    mu: torch.Tensor
    sigma2: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    updated: torch.Tensor   # (N,) bool — observation accepted and applied


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, -1))


def seed_from_stereo(cam: CameraConfig, cfg: SvoConfig, z0: torch.Tensor,
                     px_scale: torch.Tensor | None = None):
    """(mu, sigma2, a, b) from stereo depth z0 (1-px disparity noise)."""
    mu = 1.0 / torch.clamp(z0, min=1e-3)
    noise = cfg.px_noise if px_scale is None else cfg.px_noise * px_scale
    tau_inv = noise / (cam.fx * cam.baseline)
    sigma2 = (3.0 * tau_inv) ** 2 * torch.ones_like(mu)
    return mu, sigma2, 10.0 * torch.ones_like(mu), 10.0 * torch.ones_like(mu)


def compute_tau(T_rc: torch.Tensor, f_ref: torch.Tensor, z: torch.Tensor,
                px_error_angle) -> torch.Tensor:
    """Depth std-dev of a triangulated observation (SVO's computeTau)."""
    t = se3.translation(T_rc)
    t_norm = _norm(t)
    a_vec = f_ref * z[..., None] - t
    a_norm = _norm(a_vec)
    tn = torch.clamp(t_norm, min=1e-9)
    an = torch.clamp(a_norm, min=1e-9)
    alpha = torch.arccos(torch.clamp(torch.sum(f_ref * t, -1) / tn, -1.0, 1.0))
    beta = torch.arccos(torch.clamp(-torch.sum(a_vec * t, -1) / (an * tn),
                                    -1.0, 1.0))
    beta_plus = beta + px_error_angle
    gamma = math.pi - alpha - beta_plus
    sin_g = torch.clamp(torch.sin(gamma), min=1e-6)
    z_plus = t_norm * torch.sin(beta_plus) / sin_g
    return torch.abs(z_plus - z)


def update(mu, sigma2, a, b, x, tau2, z_range, apply_mask) -> SeedUpdate:
    """One Vogiatzis-Hernández posterior update with measurement
    x ~ N(μ, τ²); ``apply_mask`` gates which seeds commit it."""
    sigma2 = torch.clamp(sigma2, min=1e-12)
    tau2 = torch.clamp(tau2, min=1e-12)
    norm_scale = torch.sqrt(sigma2 + tau2)
    s2 = 1.0 / (1.0 / sigma2 + 1.0 / tau2)
    m = s2 * (mu / sigma2 + x / tau2)
    gauss = torch.exp(-0.5 * (x - mu) ** 2 / (norm_scale ** 2)) / (
        math.sqrt(2.0 * math.pi) * norm_scale)
    C1 = a / (a + b) * gauss
    C2 = b / (a + b) * (1.0 / torch.clamp(z_range, min=1e-6))
    norm = torch.clamp(C1 + C2, min=1e-12)
    C1 = C1 / norm
    C2 = C2 / norm
    f = C1 * (a + 1.0) / (a + b + 1.0) + C2 * a / (a + b + 1.0)
    e = (C1 * (a + 1.0) * (a + 2.0) / ((a + b + 1.0) * (a + b + 2.0))
         + C2 * a * (a + 1.0) / ((a + b + 1.0) * (a + b + 2.0)))
    mu_new = C1 * m + C2 * mu
    sigma2_new = C1 * (s2 + m * m) + C2 * (sigma2 + mu * mu) - mu_new * mu_new
    denom = f - e / torch.clamp(f, min=1e-12)
    denom = torch.where(torch.abs(denom) > 1e-12, denom,
                        torch.full_like(denom, -1e-12))
    a_new = (e - f) / denom
    b_new = a_new * (1.0 - f) / torch.clamp(f, min=1e-12)
    finite = (torch.isfinite(mu_new) & torch.isfinite(sigma2_new)
              & torch.isfinite(a_new) & torch.isfinite(b_new)
              & (sigma2_new > 0) & (a_new > 0) & (b_new > 0))
    ok = apply_mask & finite
    return SeedUpdate(mu=torch.where(ok, mu_new, mu),
                      sigma2=torch.where(ok, sigma2_new, sigma2),
                      a=torch.where(ok, a_new, a),
                      b=torch.where(ok, b_new, b), updated=ok)


def _floor_sigma(cfg: SvoConfig, upd: SeedUpdate) -> SeedUpdate:
    """Posterior σ floor (cfg.seed_sigma_floor · μ); off at 0."""
    if cfg.seed_sigma_floor <= 0.0:
        return upd
    s_min = (cfg.seed_sigma_floor * upd.mu) ** 2
    return upd._replace(sigma2=torch.maximum(upd.sigma2, s_min))


def _bearing(cam: CameraConfig, uv: torch.Tensor) -> torch.Tensor:
    return torch.cat([(uv[:, 0:1] - cam.cx) / cam.fx,
                      (uv[:, 1:2] - cam.cy) / cam.fy,
                      torch.ones_like(uv[:, 0:1])], -1)


def observe_and_update(cam: CameraConfig, cfg: SvoConfig,
                       T_ck: torch.Tensor, kf_uv: torch.Tensor,
                       cur_uv: torch.Tensor, mu, sigma2, a, b, z_range,
                       active: torch.Tensor,
                       px_scale: torch.Tensor | None = None) -> SeedUpdate:
    """Triangulate the tracked observation against the owner keyframe,
    derive τ, update the posterior. T_ck: (N,3,4) owner-KF → current."""
    f_ref = _bearing(cam, kf_uv)
    f_cur = _bearing(cam, cur_uv)
    z_obs, tri_ok = triangulate.two_view_depth(T_ck, f_ref, f_cur)
    T_kc = se3.inverse(T_ck)
    f_len = _norm(f_ref)
    f_unit = f_ref / f_len[:, None]
    z_unit = z_obs * f_len
    noise_px = cfg.px_noise if px_scale is None else cfg.px_noise * px_scale
    if isinstance(noise_px, torch.Tensor):
        px_error_angle = torch.arctan(noise_px / (2.0 * cam.fx)) * 2.0
    else:
        px_error_angle = math.atan(noise_px / (2.0 * cam.fx)) * 2.0
    tau = torch.clamp(compute_tau(T_kc, f_unit, z_unit, px_error_angle),
                      min=1e-6)
    z_lo = torch.clamp(z_unit - tau, min=1e-3)
    z_hi = z_unit + tau
    tau_inv = 0.5 * (1.0 / z_lo - 1.0 / z_hi)
    x_obs = 1.0 / torch.clamp(z_obs, min=1e-3)
    apply_mask = active & tri_ok & (z_obs > 0.05)
    return _floor_sigma(cfg, update(mu, sigma2, a, b, x_obs, tau_inv ** 2,
                                    z_range, apply_mask))


def stereo_observe_and_update(cam: CameraConfig, cfg: SvoConfig,
                              T_kc: torch.Tensor, cur_uv: torch.Tensor,
                              disp: torch.Tensor, disp_ok: torch.Tensor,
                              mu, sigma2, a, b, z_range,
                              active: torch.Tensor,
                              px_scale: torch.Tensor | None = None
                              ) -> SeedUpdate:
    """Per-frame stereo depth observation folded into the anchor-ray
    posterior (pose-scale-free metric anchor)."""
    z_c = cam_mod.disparity_to_depth(cam, disp)
    X_c = cam_mod.backproject(cam, cur_uv, z_c)
    z_k = se3.transform(T_kc, X_c)[..., 2]
    x_obs = 1.0 / torch.clamp(z_k, min=1e-3)
    noise = cfg.px_noise if px_scale is None else cfg.px_noise * px_scale
    dlo = torch.clamp(disp - noise, min=0.25)
    dhi = disp + noise
    z_c_hi = cam_mod.disparity_to_depth(cam, dlo)
    z_c_lo = cam_mod.disparity_to_depth(cam, dhi)
    dz_k_hi = z_k + (z_c_hi - z_c)
    dz_k_lo = torch.clamp(z_k + (z_c_lo - z_c), min=1e-3)
    tau_inv = 0.5 * (1.0 / dz_k_lo - 1.0 / torch.clamp(dz_k_hi, min=1e-3))
    tau_inv = torch.clamp(torch.abs(tau_inv), min=1e-8)
    apply_mask = active & disp_ok & (z_c > 0.1) & (z_k > 0.05)
    return _floor_sigma(cfg, update(mu, sigma2, a, b, x_obs, tau_inv ** 2,
                                    z_range, apply_mask))


def epipolar_search(cam: CameraConfig, cfg: SvoConfig, T_ck: torch.Tensor,
                    kf_uv: torch.Tensor, mu: torch.Tensor,
                    sigma2: torch.Tensor, tmpl_patch: torch.Tensor,
                    img: torch.Tensor, active: torch.Tensor, level: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched 1-D epipolar search for seeds the tracker lost this frame.

    The posterior's μ±3σ inverse-depth interval projects to a segment in
    the current image; ``cfg.epi_samples`` ZNCC probes cover it (one B3
    launch for all N·S patches) and a parabola over the peak gives the
    sub-sample position.

    T_ck: (N,3,4) owner-KF → current poses; kf_uv: (N,2) level-0 anchors;
    tmpl_patch: (N,P²) reference patches at ``level``; img: current image
    at ``level``; active: (N,) seeds to search.
    Returns (uv (N,2) level-0 matches, ok (N,), best ZNCC (N,)).
    """
    N = kf_uv.shape[0]
    S = cfg.epi_samples
    P = int(round(tmpl_patch.shape[-1] ** 0.5))
    scale = 1.0 / (2 ** level)

    sd = torch.sqrt(torch.clamp(sigma2, min=1e-12))
    x_hi = mu + 3.0 * sd                       # nearest plausible
    x_lo = torch.clamp(mu - 3.0 * sd, min=1e-4)  # farthest plausible
    p_near = cam_mod.backproject(cam, kf_uv, 1.0 / x_hi)
    p_far = cam_mod.backproject(cam, kf_uv, 1.0 / x_lo)
    uv_a, front_a = cam_mod.project(cam, se3.transform(T_ck, p_near))
    uv_b, front_b = cam_mod.project(cam, se3.transform(T_ck, p_far))

    t = torch.linspace(0.0, 1.0, S, dtype=kf_uv.dtype, device=kf_uv.device)
    uv_s = uv_a[:, None] + t[None, :, None] * (uv_b - uv_a)[:, None]
    cur = interp.sample_patch(img, uv_s.reshape(N * S, 2) * scale,
                              P).reshape(N, S, P * P)

    def znorm(p):
        p = p - p.mean(-1, keepdim=True)
        return p / torch.clamp(torch.sqrt(torch.sum(p * p, -1, keepdim=True)),
                               min=1e-6)

    scores = torch.einsum("np,nsp->ns", znorm(tmpl_patch), znorm(cur))
    best = torch.argmax(scores, 1)

    def at(i):
        return torch.gather(scores, 1, i[:, None])[:, 0]

    s_best = at(best)
    s0 = at(torch.clamp(best - 1, 0, S - 1))
    s2 = at(torch.clamp(best + 1, 0, S - 1))
    denom = s0 - 2.0 * s_best + s2
    big = torch.abs(denom) > 1e-6
    off = torch.where(big, 0.5 * (s0 - s2) / torch.where(
        big, denom, torch.ones_like(denom)), torch.zeros_like(denom))
    off = torch.clamp(off, -0.5, 0.5)
    tt = (best.to(off.dtype) + off) / (S - 1)
    uv = uv_a + tt[:, None] * (uv_b - uv_a)

    seg = _norm(uv_b - uv_a)
    spacing_ok = seg * scale / (S - 1) <= 0.75 * P  # probes overlap the peak
    interior = (best > 0) & (best < S - 1)
    in_img = cam_mod.in_bounds(cam, uv, margin=P * (2 ** level))
    # prominence gate: a flat correlation ridge localizes arbitrarily
    prominent = s_best - 0.5 * (s0 + s2) > 0.01
    ok = (active & front_a & front_b & interior & in_img & spacing_ok
          & prominent & (s_best > cfg.epi_min_zncc))
    return uv, ok, s_best


def converged(cfg: SvoConfig, mu: torch.Tensor, sigma2: torch.Tensor
              ) -> torch.Tensor:
    """Seed convergence: inverse-depth std below a fraction of the mean."""
    return (torch.sqrt(sigma2)
            < cfg.seed_sigma_ratio * torch.clamp(mu, min=1e-6))


def diverged(cfg: SvoConfig, a: torch.Tensor, b: torch.Tensor,
             n_updates: torch.Tensor) -> torch.Tensor:
    """Cull: posterior inlier probability collapsed, or update budget spent."""
    inlier_prob = a / torch.clamp(a + b, min=1e-6)
    return (inlier_prob < 0.1) | (n_updates > cfg.seed_max_updates)
