"""Rectified-stereo scanline matching (1-D ZNCC search) — port of
``stereo_svo_tpu/ops/stereo_match.py``.

``_search_1d`` builds the D sliding windows of the sampled strip as a view
(``Tensor.unfold``) instead of the reference's one-hot einsum, which only
existed to keep the TPU graph small; the windows hold the same values.
"""

from __future__ import annotations

import torch

from . import interp


def _normalize(p: torch.Tensor) -> torch.Tensor:
    """Zero-mean, unit-norm over the last axis (ZNCC normalization)."""
    p = p - p.mean(-1, keepdim=True)
    n = torch.sqrt(torch.sum(p * p, -1, keepdim=True))
    return p / torch.clamp(n, min=1e-6)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx[:, None])[:, 0]


def _search_1d(ref_n: torch.Tensor, img: torch.Tensor, uv0: torch.Tensor,
               D: int, P: int, direction: float):
    """Score D windows from uv0 stepping ``direction`` (−1 leftward, +1
    rightward) with a sub-pixel peak. Returns (disp, best, s0, s2,
    interior)."""
    half = (P - 1) / 2.0
    C = D + P - 1
    dev = img.device
    if direction < 0:
        col_off = torch.arange(C, dtype=img.dtype, device=dev) - (D - 1) - half
    else:
        col_off = torch.arange(C, dtype=img.dtype, device=dev) - half
    row_off = torch.arange(P, dtype=img.dtype, device=dev) - half
    strip = interp.sample_rect(img, uv0, row_off, col_off)   # (N,P,C)
    N = uv0.shape[0]
    wins = strip.unfold(2, P, 1).permute(0, 2, 1, 3)         # (N,C-P+1,P,P)
    if direction < 0:
        wins = wins.flip(1)        # window for disparity d starts at D-1-d
    wins_n = _normalize(wins.reshape(N, D, P * P))
    scores = torch.einsum("np,ndp->nd", ref_n, wins_n)

    best = torch.argmax(scores, 1)
    best_score = _take(scores, best)
    s0 = _take(scores, torch.clamp(best - 1, 0, D - 1))
    s2 = _take(scores, torch.clamp(best + 1, 0, D - 1))
    denom = s0 - 2.0 * best_score + s2
    big = torch.abs(denom) > 1e-6
    offset = torch.where(
        big, 0.5 * (s0 - s2) / torch.where(big, denom, torch.ones_like(denom)),
        torch.zeros_like(denom))
    offset = torch.clamp(offset, -0.5, 0.5)
    disp = best.to(img.dtype) + offset
    interior = (best > 0) & (best < D - 1)
    return disp, best_score, s0, s2, interior


def match(left: torch.Tensor, right: torch.Tensor, uv: torch.Tensor,
          max_disp: int, patch: int, min_zncc: float = 0.5,
          lr_check_px: float = 1.0, prominence: float = 0.005):
    """Match features left→right along rectified scanlines over
    [0, max_disp), with the left-right round-trip and prominence gates.
    Returns (disp, zncc, valid)."""
    D, P = max_disp, patch
    ref_n = _normalize(interp.sample_patch(left, uv, P))
    disp, best_score, s0, s2, interior = _search_1d(ref_n, right, uv, D, P,
                                                    direction=-1.0)
    valid = (best_score > min_zncc) & interior
    if prominence > 0.0:
        valid = valid & (best_score - 0.5 * (s0 + s2) > prominence)
    if lr_check_px > 0.0:
        uv_r = torch.stack([uv[:, 0] - disp, uv[:, 1]], -1)
        ref_r = _normalize(interp.sample_patch(right, uv_r, P))
        disp_rl, _, _, _, interior_rl = _search_1d(ref_r, left, uv_r, D, P,
                                                   direction=+1.0)
        valid = valid & interior_rl & (torch.abs(disp_rl - disp)
                                       <= lr_check_px)
    return disp, best_score, valid


def refine_disparity(left: torch.Tensor, right: torch.Tensor,
                     uv: torch.Tensor, disp_pred: torch.Tensor,
                     window: int, patch: int, min_zncc: float = 0.6):
    """Narrow stereo re-measurement in disp_pred ± window.
    Returns (disp, zncc, ok); ok requires an interior, prominent peak."""
    D, P = 2 * window + 1, patch
    base = disp_pred - float(window)
    ref_n = _normalize(interp.sample_patch(left, uv, P))
    uv0 = torch.stack([uv[:, 0] - base, uv[:, 1]], -1)
    d_rel, score, s0, s2, interior = _search_1d(ref_n, right, uv0, D, P,
                                                direction=-1.0)
    disp = base + d_rel
    prominent = score - 0.5 * (s0 + s2) > 0.005
    ok = (score > min_zncc) & interior & prominent & (disp > 0.5)
    return disp, score, ok
