"""Pyramidal inverse-compositional Lucas-Kanade feature tracking — port of
``stereo_svo_tpu/ops/klt.py``.

On CUDA :func:`track` is one launch of ``klt_track_kernel``
(``kernels/klt_kernel.klt_track``; under ``vmap``, one for the batch): every
level and iteration, the template warp included. Its plain version,
:func:`track_plain`, the chain of PyTorch ops that the CPU runs, samples all
N patches of the current level with kernel B3 (``interp.sample_patch``)
every iteration: klt_levels × klt_max_iters calls per frame. With
``klt_affine_warp`` the keyframe also stores an oversized 2P×2P patch per
level (B3 at 2P, :func:`make_template`), which ``warp_template_level``
resamples once per level and frame through each feature's pose-predicted
affine warp — a batched gather inside each feature's own patch, not B3 on
a shared image.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ..config import SvoConfig
from . import interp, pyramid, solve
from .kernels import _build, klt_kernel


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
    P = cfg.klt_patch
    B = cfg.klt_big_patch
    N = uv.shape[0]
    patches, jacs, hinvs, bigs, big_oks = [], [], [], [], []
    eye2 = torch.eye(2, dtype=uv.dtype, device=uv.device)
    for lv in range(cfg.klt_levels):
        uv_l = uv * (1.0 / (2 ** lv))
        t, gu, gv = interp.sample_patch(          # one B3 launch
            pyramid.level_planes(levels[lv], gxs[lv], gys[lv]), uv_l, P)
        J = torch.stack([gu, gv], -1)                       # (N, P2, 2)
        H = torch.einsum("npi,npj->nij", J, J) + 1e-3 * eye2
        hinvs.append(solve.inv2x2(H))
        patches.append(t)
        jacs.append(J)
        if B > 1:
            bigs.append(interp.sample_patch(levels[lv], uv_l, B))
            # the big patch must lie inside the level image: border-clamped
            # samples would corrupt the warped template
            Hh, Ww = levels[lv].shape
            half = (B - 1) / 2.0 + 1.0   # +1: bilinear right/bottom tap
            big_oks.append((uv_l[:, 0] >= half) & (uv_l[:, 0] < Ww - half)
                           & (uv_l[:, 1] >= half) & (uv_l[:, 1] < Hh - half))
        else:
            bigs.append(torch.zeros((N, 1), dtype=t.dtype, device=t.device))
            big_oks.append(torch.zeros(N, dtype=torch.bool, device=t.device))
    return KltTemplate(
        patches=torch.stack(patches), jac=torch.stack(jacs),
        hinv=torch.stack(hinvs), mask=mask, big=torch.stack(bigs),
        big_ok=torch.stack(big_oks))


def warp_template_level(big: torch.Tensor, A_inv: torch.Tensor, patch: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Resample stored oversized patches through per-feature affine warps.

    big: (N, B²) oversized patches (ref-frame pixel grid); A_inv: (N,2,2)
    maps current-frame patch offsets to ref-frame offsets. Returns the
    warped template (N,P²), its gradients in current-frame pixels (N,P²,2),
    the inverse IC Hessian (N,2,2), and whether every warped sample landed
    inside the stored B×B grid (N,) — callers fall back to the
    fronto-parallel template where it did not.
    """
    N, B2 = big.shape
    B = int(round(B2 ** 0.5))
    offs = interp.patch_coords(patch, big.dtype, big.device)   # (P2, 2)
    r_ref = torch.einsum("nij,pj->npi", A_inv, offs)           # ref px
    contained = torch.all(torch.all(torch.abs(r_ref) <= (B - 1) / 2.0, -1),
                          -1)
    # each feature samples its own B×B grid (offsets [-(B-1)/2, (B-1)/2])
    val, gu, gv = interp.bilinear_with_grad(big.reshape(N, B, B),
                                            r_ref + (B - 1) / 2.0)
    J = torch.einsum("npj,nji->npi", torch.stack([gu, gv], -1), A_inv)
    H = torch.einsum("npi,npj->nij", J, J) + 1e-3 * torch.eye(
        2, dtype=J.dtype, device=J.device)
    return val, J, solve.inv2x2(H), contained


def track(levels_cur: Sequence[torch.Tensor], tmpl: KltTemplate,
          cfg: SvoConfig, uv_init: torch.Tensor,
          edge_dir: torch.Tensor | None = None,
          is_edgelet: torch.Tensor | None = None,
          A_inv: torch.Tensor | None = None,
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Refine feature positions in the current frame: :func:`track_plain`'s
    arguments and return. On CUDA one ``klt_track_kernel`` launch
    (``svo::klt_track``); on the CPU :func:`track_plain`."""
    levels = list(levels_cur[:cfg.klt_levels])
    if _build.plain(uv_init, *levels, *tmpl, edge_dir, is_edgelet, A_inv):
        return track_plain(levels, tmpl, cfg, uv_init, edge_dir=edge_dir,
                           is_edgelet=is_edgelet, A_inv=A_inv)
    return klt_kernel.klt_track(levels, tmpl, cfg, uv_init, edge_dir=edge_dir,
                                is_edgelet=is_edgelet, A_inv=A_inv)


def track_plain(levels_cur: Sequence[torch.Tensor], tmpl: KltTemplate,
                cfg: SvoConfig, uv_init: torch.Tensor,
                edge_dir: torch.Tensor | None = None,
                is_edgelet: torch.Tensor | None = None,
                A_inv: torch.Tensor | None = None,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """:func:`track` as a chain of PyTorch ops and B3 launches (the
    reference's arithmetic); under ``torch.func.vmap`` each op takes the
    batch.

    uv_init: (N,2) predicted level-0 positions. ``edge_dir``/``is_edgelet``
    constrain edgelets to a 1-DoF update along their gradient normal.
    ``A_inv`` (N,2,2), with oversized templates, warps each template once
    per level instead of using the fronto-parallel one.
    Returns (uv (N,2), converged-and-plausible (N,), mean |residual| (N,),
    and the number of (feature, level) pairs of ``tmpl.mask`` tracked on
    the warped template (int32, 0 without ``A_inv``)). The reference
    returns the first three.
    """
    P = cfg.klt_patch
    uv = uv_init
    use_warp = A_inv is not None and tmpl.big.shape[-1] > 1
    converged = torch.zeros(uv.shape[0], dtype=torch.bool, device=uv.device)
    res = torch.zeros(uv.shape[0], dtype=levels_cur[0].dtype,
                      device=uv.device)
    n_warped = torch.zeros((), dtype=torch.int32, device=uv.device)
    for lv in range(cfg.klt_levels - 1, -1, -1):
        img = levels_cur[lv]
        H, W = img.shape
        t, J, Hinv = tmpl.patches[lv], tmpl.jac[lv], tmpl.hinv[lv]
        if use_warp:
            t_w, J_w, Hinv_w, contained = warp_template_level(
                tmpl.big[lv], A_inv, P)
            w_ok = contained & tmpl.big_ok[lv]
            n_warped = n_warped + (w_ok & tmpl.mask).sum(dtype=torch.int32)
            t = torch.where(w_ok[:, None], t_w, t)
            J = torch.where(w_ok[:, None, None], J_w, J)
            Hinv = torch.where(w_ok[:, None, None], Hinv_w, Hinv)
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
    return uv, ok & converged, res, n_warped
