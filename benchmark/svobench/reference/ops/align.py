"""Sparse direct image alignment (coarse-to-fine inverse-compositional
Gauss-Newton) — port of ``stereo_svo_tpu/ops/align.py``.

Per level, chunked IRLS as in the reference: each refresh pass samples the
current image, fits the global illumination pair (a, b), and accumulates
the normal equations with kernel B4 (``kernels/align_kernel.gn_accumulate``)
before an exact 6×6 solve; the inner passes in between sample with B3 and
reuse H⁻¹ as one matvec. At the default (2,3,4,8) schedule a frame runs 7
refresh passes and 8 inner passes.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ..config import CameraConfig, SvoConfig
from ..geometry import camera, se3
from . import interp, pyramid, solve
from .kernels import align_kernel


class Template(NamedTuple):
    """Per-reference-frame alignment template (one entry per align level).
    L = align levels, N = max_features, P2 = patch²."""
    p_ref: torch.Tensor      # (N, 3) feature 3-D points in ref camera frame
    patches: torch.Tensor    # (L, N, P2) reference intensities
    jac: torch.Tensor        # (L, N, P2, 6) IC Jacobians d(intensity)/d(twist)
    mask: torch.Tensor       # (N,) feature validity


def _level_list(cfg: SvoConfig):
    """Align levels, coarse→fine."""
    return list(range(cfg.align_levels - 1, cfg.align_min_level - 1, -1))


def make_template(levels: Sequence[torch.Tensor],
                  gxs: Sequence[torch.Tensor], gys: Sequence[torch.Tensor],
                  cam: CameraConfig, cfg: SvoConfig, uv: torch.Tensor,
                  z: torch.Tensor, mask: torch.Tensor) -> Template:
    """Build the IC template from a reference frame (uv level-0, z depths).
    Patch-pixel 3-D points share the centre depth."""
    P = cfg.align_patch
    offs = interp.patch_coords(P, uv.dtype, uv.device)     # (P2, 2)
    p_ref = camera.backproject(cam, uv, z)
    patches, jacs = [], []
    for lv in _level_list(cfg):
        uv_l = uv * (1.0 / (2 ** lv))
        pts = uv_l[:, None, :] + offs[None]                 # (N, P2, 2)
        patch, gu, gv = interp.sample_patch(      # one B3 launch
            pyramid.level_planes(levels[lv], gxs[lv], gys[lv]), uv_l, P)
        p_pix = camera.backproject(cam, pts * (2 ** lv),
                                   z[:, None].expand(pts.shape[:2]))
        Jpose = camera.proj_pose_jacobian(cam, p_pix, level=lv)  # (N,P2,2,6)
        J = gu[..., None] * Jpose[..., 0, :] + gv[..., None] * Jpose[..., 1, :]
        ok = camera.in_bounds(cam, pts, level=lv, margin=1.0)
        J = torch.where(ok[..., None], J, torch.zeros_like(J))
        patches.append(patch)
        jacs.append(J)
    return Template(p_ref=p_ref, patches=torch.stack(patches),
                    jac=torch.stack(jacs), mask=mask & (z > 1e-2))


def _huber_weight(e: torch.Tensor, k: float) -> torch.Tensor:
    a = torch.abs(e)
    return torch.where(a <= k, torch.ones_like(a),
                       k / torch.clamp(a, min=1e-6))


def align(levels_cur: Sequence[torch.Tensor], tmpl: Template,
          cam: CameraConfig, cfg: SvoConfig,
          T_init: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Estimate T_cr (ref→cur) by coarse-to-fine IC Gauss-Newton.
    Returns (T_cr, stats)."""
    P = cfg.align_patch
    k = cfg.align_huber
    dev = T_init.device
    offs = interp.patch_coords(P, torch.float32, dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    lam = 1e-4
    T = T_init
    last_cost = torch.zeros((), device=dev)
    inlier_frac = torch.zeros((), device=dev)
    if not cfg.illum_affine:
        a_il = torch.ones((), device=dev)
        b_il = torch.zeros((), device=dev)

    lvl_list = _level_list(cfg)
    schedule = cfg.align_iters_per_level
    if schedule is not None:
        if len(schedule) < len(lvl_list):
            raise ValueError("align_iters_per_level shorter than the "
                             "number of align levels")
        schedule = schedule[len(schedule) - len(lvl_list):]

    for li, lv in enumerate(lvl_list):
        img = levels_cur[lv]
        ref_patch = tmpl.patches[li]                         # (N, P2)
        J = tmpl.jac[li]                                     # (N, P2, 6)
        iters_l = schedule[li] if schedule is not None \
            else cfg.align_max_iters

        def sample_cur(T):
            p_cur = se3.transform(T, tmpl.p_ref)
            uv_c, front = camera.project(cam, p_cur, level=lv)
            pts = uv_c[:, None, :] + offs[None]
            cur = interp.sample_patch(img, uv_c, P)          # B3
            ok = (camera.in_bounds(cam, pts, level=lv, margin=1.0)
                  & front[:, None] & tmpl.mask[:, None])
            return uv_c, cur, ok

        chunks = max(1, min(cfg.align_irls_chunks, iters_l // 2, iters_l))
        inner = max(iters_l // chunks - 1, 0)
        for _ in range(chunks):
            # refresh pass: (a, b) from a B3 sample, then B4 re-samples and
            # accumulates H, g, cost and the counts in one fused pass
            uv_c, cur, ok = sample_cur(T)
            okf = ok.to(torch.float32)
            if cfg.illum_affine:
                sw = torch.clamp(okf.sum(), min=1.0)
                m_ref = torch.sum(ref_patch * okf) / sw
                m_cur = torch.sum(cur * okf) / sw
                cov = torch.sum((cur - m_cur) * (ref_patch - m_ref) * okf) / sw
                var = torch.sum((ref_patch - m_ref) ** 2 * okf) / sw
                a_il = torch.clamp(cov / torch.clamp(var, min=1e-3), 0.5, 2.0)
                b_il = m_cur - a_il * m_ref
            # the Huber weights of this pass, reused by the inner passes
            w = _huber_weight(cur - (a_il * ref_patch + b_il), k) * okf
            H, g, cost_sum, n_eff, n_inl = align_kernel.gn_accumulate(
                img, uv_c, ref_patch, J, okf, P, k, a_il, b_il)
            n_ok = torch.clamp(n_eff, min=1.0)
            last_cost = cost_sum / n_ok
            inlier_frac = n_inl / n_ok
            H = H + lam * torch.trace(H) / 6.0 * eye6 + 1e-8 * eye6
            rhs = torch.cat([eye6, g[None]])
            sol = solve.chol_solve_small(H.expand(7, 6, 6), rhs)
            Hinv = sol[:6]
            T = se3.compose(T, se3.exp(-sol[6] / a_il))

            for _ in range(inner):
                _, cur_i, ok_i = sample_cur(T)
                e = cur_i - (a_il * ref_patch + b_il)
                b = torch.einsum("npi,np,np->i", J, w, e)
                T = se3.compose(T, se3.exp(-(Hinv @ b / a_il)))
                last_cost = torch.sum(w * e * e) / n_ok
                inlier_frac = (torch.sum((torch.abs(e) < k) & ok_i)
                               / torch.clamp(ok_i.sum(), min=1))

    return T, {"align_cost": last_cost, "align_inlier_frac": inlier_frac}
