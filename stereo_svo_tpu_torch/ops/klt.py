"""Pyramidal inverse-compositional Lucas-Kanade feature tracking — port of
``stereo_svo_tpu/ops/klt.py`` (``make_template`` and ``track``; the affine
template warp ``warp_template_level`` is not ported yet).

Every iteration samples all N patches of the current level with kernel B3
(``interp.sample_patch``): klt_levels × klt_max_iters calls per frame.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ..config import SvoConfig
from . import interp, solve


class KltTemplate(NamedTuple):
    """IC-LK template per feature per KLT level (L levels, N features)."""
    patches: torch.Tensor   # (L, N, P2) template intensities
    jac: torch.Tensor       # (L, N, P2, 2) template gradients (du, dv)
    hinv: torch.Tensor      # (L, N, 2, 2) inverse IC Hessians
    mask: torch.Tensor      # (N,)
    big: torch.Tensor       # (L, N, B2) oversized patches for affine warping
    big_ok: torch.Tensor    # (L, N)


def make_template(levels: Sequence[torch.Tensor],
                  gxs: Sequence[torch.Tensor], gys: Sequence[torch.Tensor],
                  cfg: SvoConfig, uv: torch.Tensor,
                  mask: torch.Tensor) -> KltTemplate:
    """Extract KLT templates at level-0 positions ``uv`` from a keyframe."""
    if cfg.klt_big_patch > 1:
        raise NotImplementedError(
            "klt_affine_warp: the affine template warp is ROADMAP item A14")
    P = cfg.klt_patch
    N = uv.shape[0]
    patches, jacs, hinvs = [], [], []
    eye2 = torch.eye(2, dtype=uv.dtype, device=uv.device)
    for lv in range(cfg.klt_levels):
        uv_l = uv * (1.0 / (2 ** lv))
        t = interp.sample_patch(levels[lv], uv_l, P)
        gu = interp.sample_patch(gxs[lv], uv_l, P)
        gv = interp.sample_patch(gys[lv], uv_l, P)
        J = torch.stack([gu, gv], -1)                       # (N, P2, 2)
        H = torch.einsum("npi,npj->nij", J, J) + 1e-3 * eye2
        hinvs.append(solve.inv2x2(H))
        patches.append(t)
        jacs.append(J)
    L = cfg.klt_levels
    return KltTemplate(
        patches=torch.stack(patches), jac=torch.stack(jacs),
        hinv=torch.stack(hinvs), mask=mask,
        big=torch.zeros((L, N, 1), dtype=uv.dtype, device=uv.device),
        big_ok=torch.zeros((L, N), dtype=torch.bool, device=uv.device))


def track(levels_cur: Sequence[torch.Tensor], tmpl: KltTemplate,
          cfg: SvoConfig, uv_init: torch.Tensor,
          edge_dir: torch.Tensor | None = None,
          is_edgelet: torch.Tensor | None = None,
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Refine feature positions in the current frame.

    uv_init: (N,2) predicted level-0 positions. ``edge_dir``/``is_edgelet``
    constrain edgelets to a 1-DoF update along their gradient normal.
    Returns (uv (N,2), converged-and-plausible (N,), mean |residual| (N,)).
    """
    P = cfg.klt_patch
    uv = uv_init
    converged = torch.zeros(uv.shape[0], dtype=torch.bool, device=uv.device)
    res = torch.zeros(uv.shape[0], dtype=levels_cur[0].dtype,
                      device=uv.device)
    for lv in range(cfg.klt_levels - 1, -1, -1):
        img = levels_cur[lv]
        H, W = img.shape
        t, J, Hinv = tmpl.patches[lv], tmpl.jac[lv], tmpl.hinv[lv]
        scale = 1.0 / (2 ** lv)
        # convergence flags reset per level (the finer level re-refines)
        converged = torch.zeros_like(converged)
        for _ in range(cfg.klt_max_iters):
            cur = interp.sample_patch(img, uv * scale, P)   # B3
            if cfg.illum_affine:
                # per-feature affine fit cur ≈ a·t + b, corners only
                mc = cur.mean(-1, keepdim=True)
                mt = t.mean(-1, keepdim=True)
                cov = ((cur - mc) * (t - mt)).mean(-1, keepdim=True)
                var = ((t - mt) ** 2).mean(-1, keepdim=True)
                a_fit = torch.clamp(cov / torch.clamp(var, min=1e-3),
                                    0.6, 1.6)
                e_fit = (cur - mc) - a_fit * (t - mt)
                if is_edgelet is not None:
                    edge = is_edgelet[:, None]
                    a_il = torch.where(edge, torch.ones_like(a_fit), a_fit)
                    e = torch.where(edge, cur - t, e_fit)
                else:
                    a_il, e = a_fit, e_fit
            else:
                a_il = torch.ones((uv.shape[0], 1), device=uv.device)
                e = cur - t
            g = torch.einsum("npi,np->ni", J, e)
            delta = torch.einsum("nij,nj->ni", Hinv, g) / a_il
            if edge_dir is not None and is_edgelet is not None:
                along = torch.sum(delta * edge_dir, -1, keepdim=True)
                delta = torch.where(is_edgelet[:, None], along * edge_dir,
                                    delta)
            step = delta * (2 ** lv)
            us, vs = uv[:, 0] * scale, uv[:, 1] * scale
            in_b = (us > P) & (us < W - P) & (vs > P) & (vs < H - P)
            active = tmpl.mask & in_b & ~converged
            uv = torch.where(active[:, None], uv - step, uv)
            converged = converged | (
                active
                & (torch.sum(delta * delta, -1) < cfg.klt_conv_eps ** 2))
            res = torch.where(active, torch.abs(e).mean(-1), res)

    moved2 = torch.sum((uv - uv_init) ** 2, -1)
    ok = tmpl.mask & (moved2 < (4.0 * cfg.klt_patch) ** 2)
    return uv, ok & converged, res
