"""Sparse direct image alignment (coarse-to-fine inverse-compositional
Gauss-Newton) — port of ``stereo_svo_tpu/ops/align.py``.

Per level, chunked IRLS as in the reference: each refresh pass samples the
current image, fits the global illumination pair (a, b), and accumulates
the normal equations before an exact 6×6 solve; the inner passes in between
sample again and reuse H⁻¹ as one matvec. At the default (2,3,4,8) schedule
a frame runs 7 refresh passes and 8 inner passes. On CUDA the whole of it
is one launch of one kernel (``kernels/align_kernel.align_levels``); its
plain version, :func:`align_plain`, is the chain of PyTorch ops with B3 and
B4 (``gn_accumulate``) that the CPU runs.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from ..config import CameraConfig, SvoConfig
from ..geometry import camera, se3
from . import interp, pyramid, solve
from .kernels import _build, align_kernel


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


class Spec(NamedTuple):
    """What ``align`` runs, from the camera and the configuration alone:
    per aligned level (coarse→fine), its pyramid level, its intrinsics
    (``camera.intrinsics``), the largest in-bounds u and v (``camera
    .in_bounds`` with margin 1) and its refresh and inner passes."""
    levels: tuple
    intrinsics: tuple   # ((fx, fy, cx, cy), …)
    bounds: tuple       # ((w − 2, h − 2), …)
    schedule: tuple     # ((refresh passes, inner passes after each), …)
    patch: int
    huber_k: float
    illum_affine: bool


@functools.lru_cache(maxsize=64)
def spec(cam: CameraConfig, cfg: SvoConfig) -> Spec:
    lvl_list = _level_list(cfg)
    schedule = cfg.align_iters_per_level
    if schedule is not None:
        if len(schedule) < len(lvl_list):
            raise ValueError("align_iters_per_level shorter than the "
                             "number of align levels")
        schedule = schedule[len(schedule) - len(lvl_list):]
    passes, bounds = [], []
    for li, lv in enumerate(lvl_list):
        iters_l = schedule[li] if schedule is not None \
            else cfg.align_max_iters
        chunks = max(1, min(cfg.align_irls_chunks, iters_l // 2, iters_l))
        passes.append((chunks, max(iters_l // chunks - 1, 0)))
        margin = 1.0
        bounds.append((cam.width // (2 ** lv) - 1 - margin,
                       cam.height // (2 ** lv) - 1 - margin))
    return Spec(levels=tuple(lvl_list),
                intrinsics=tuple(camera.intrinsics(cam, lv)
                                 for lv in lvl_list),
                bounds=tuple(bounds), schedule=tuple(passes),
                patch=cfg.align_patch, huber_k=float(cfg.align_huber),
                illum_affine=bool(cfg.illum_affine))


def _project(intr, x_cam: torch.Tensor):
    """``camera.project`` with the level's intrinsics given."""
    fx, fy, cx, cy = intr
    z = x_cam[..., 2]
    valid = z > 1e-3
    zs = torch.where(valid, z, torch.ones_like(z))
    u = fx * x_cam[..., 0] / zs + cx
    v = fy * x_cam[..., 1] / zs + cy
    return torch.stack([u, v], -1), valid


def chain(levels: Sequence[torch.Tensor], p_ref: torch.Tensor,
          patches: torch.Tensor, jac: torch.Tensor, mask: torch.Tensor,
          T_init: torch.Tensor, s: Spec) -> Tuple[torch.Tensor, dict]:
    """The alignment as a chain of PyTorch ops, B3 and B4: ``levels`` the
    images of ``s.levels`` (coarse→fine), the template's fields, ``s`` the
    static schedule. Under ``torch.func.vmap`` each op takes the batch."""
    P = s.patch
    k = s.huber_k
    dev = T_init.device
    offs = interp.patch_coords(P, torch.float32, dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    lam = 1e-4
    T = T_init
    last_cost = torch.zeros((), device=dev)
    inlier_frac = torch.zeros((), device=dev)
    if not s.illum_affine:
        a_il = torch.ones((), device=dev)
        b_il = torch.zeros((), device=dev)

    for li, img in enumerate(levels):
        ref_patch = patches[li]                              # (N, P2)
        J = jac[li]                                          # (N, P2, 6)
        intr, (u_max, v_max) = s.intrinsics[li], s.bounds[li]

        def sample_cur(T):
            p_cur = se3.transform(T, p_ref)
            uv_c, front = _project(intr, p_cur)
            pts = uv_c[:, None, :] + offs[None]
            cur = interp.sample_patch(img, uv_c, P)          # B3
            u, v = pts[..., 0], pts[..., 1]
            ok = ((u >= 1.0) & (u <= u_max) & (v >= 1.0) & (v <= v_max)
                  & front[:, None] & mask[:, None])
            return uv_c, cur, ok

        chunks, inner = s.schedule[li]
        for _ in range(chunks):
            # refresh pass: (a, b) from a B3 sample, then B4 re-samples and
            # accumulates H, g, cost and the counts in one fused pass
            uv_c, cur, ok = sample_cur(T)
            okf = ok.to(torch.float32)
            if s.illum_affine:
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


def align_plain(levels_cur: Sequence[torch.Tensor], tmpl: Template,
                cam: CameraConfig, cfg: SvoConfig,
                T_init: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """:func:`align` as the chain of PyTorch ops, B3 and B4 (the plain
    version of ``svo::align_levels``; the CPU's path)."""
    s = spec(cam, cfg)
    return chain([levels_cur[lv] for lv in s.levels], tmpl.p_ref,
                 tmpl.patches, tmpl.jac, tmpl.mask, T_init, s)


def align(levels_cur: Sequence[torch.Tensor], tmpl: Template,
          cam: CameraConfig, cfg: SvoConfig,
          T_init: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Estimate T_cr (ref→cur) by coarse-to-fine IC Gauss-Newton.
    Returns (T_cr, stats). On CUDA one launch of ``align_levels_kernel``
    (``svo::align_levels``; under ``vmap``, one for the batch); on the CPU
    :func:`align_plain`."""
    s = spec(cam, cfg)
    levels = [levels_cur[lv] for lv in s.levels]
    if _build.plain(T_init, tmpl.p_ref, tmpl.patches, tmpl.jac, tmpl.mask,
                    *levels):
        return chain(levels, tmpl.p_ref, tmpl.patches, tmpl.jac, tmpl.mask,
                     T_init, s)
    T, cost, frac = align_kernel.align_levels(
        levels, tmpl.p_ref, tmpl.patches, tmpl.jac, tmpl.mask, T_init, s)
    return T, {"align_cost": cost, "align_inlier_frac": frac}
