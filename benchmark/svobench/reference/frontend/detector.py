"""Grid-bucketed FAST + edgelet feature selection, fixed capacity — port of
``stereo_svo_tpu/frontend/detector.py``. Corners on ``detect_levels``
pyramid levels, edgelets on level 0; a corner outranks an edgelet."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..config import SvoConfig
from ..ops import fast

_CORNER_BIAS = 1e4  # any corner beats any edgelet in a cell


class Detection(NamedTuple):
    uv: torch.Tensor        # (M, 2) level-0 pixel coords
    score: torch.Tensor     # (M,) selection score (bias removed)
    is_corner: torch.Tensor  # (M,) bool (False → edgelet)
    level: torch.Tensor     # (M,) int32 pyramid level of detection
    grad_dir: torch.Tensor  # (M, 2) unit gradient at the feature
    valid: torch.Tensor     # (M,) bool


def _cell_max(score: torch.Tensor, rows: int, cols: int):
    """Per-cell max + argmax position: (rows*cols,) values, (rows*cols,2)."""
    H, W = score.shape
    ch, cw = H // rows, W // cols
    s = score[: rows * ch, : cols * cw].reshape(rows, ch, cols, cw)
    s = s.permute(0, 2, 1, 3).reshape(rows * cols, ch * cw)
    idx = torch.argmax(s, 1)
    val = torch.gather(s, 1, idx[:, None])[:, 0]
    cell = torch.arange(rows * cols, device=score.device)
    u = ((cell % cols) * cw + idx % cw).to(score.dtype)
    v = ((cell // cols) * ch + idx // cw).to(score.dtype)
    return val, torch.stack([u, v], -1)


def _border_mask(shape, margin: int, dtype, device):
    H, W = shape
    m = torch.zeros((H, W), dtype=dtype, device=device)
    m[margin: H - margin, margin: W - margin] = 1.0
    return m


def detect(levels: Sequence[torch.Tensor], gx0: torch.Tensor,
           gy0: torch.Tensor, cfg: SvoConfig,
           free_cells: torch.Tensor | None = None) -> Detection:
    """Select the best feature per grid cell across detection levels;
    ``free_cells`` (rows*cols,) bool marks cells eligible for a feature."""
    rows, cols = cfg.grid_rows, cfg.grid_cols
    dev = gx0.device
    best_score = best_uv = best_level = None
    for lv in range(min(cfg.detect_levels, cfg.num_levels)):
        img = levels[lv]
        if img.shape[0] < rows or img.shape[1] < cols:
            break  # level coarser than the bucketing grid
        margin = max(4, cfg.border_margin // (2 ** lv))
        cs = fast.corner_score(img) * _border_mask(img.shape, margin,
                                                   img.dtype, dev)
        cs = torch.where(cs > cfg.fast_threshold, cs, torch.zeros_like(cs))
        val, uv = _cell_max(cs, rows, cols)
        val = val * (0.5 ** lv)      # prefer fine levels
        uv = uv * (2 ** lv) + (2 ** lv - 1) / 2.0   # level-lv pixel centre
        if best_score is None:
            best_score, best_uv = val, uv
            best_level = torch.zeros(val.shape, dtype=torch.int32, device=dev)
        else:
            take = val > best_score
            best_uv = torch.where(take[:, None], uv, best_uv)
            best_level = torch.where(take, torch.full_like(best_level, lv),
                                     best_level)
            best_score = torch.maximum(val, best_score)

    es = fast.edgelet_score(gx0, gy0) * _border_mask(
        levels[0].shape, cfg.border_margin, levels[0].dtype, dev)
    es = torch.where(es > cfg.edgelet_threshold, es, torch.zeros_like(es))
    e_val, e_uv = _cell_max(es, rows, cols)

    corner_sel = best_score > 0.0
    combined = torch.where(corner_sel, best_score + _CORNER_BIAS, e_val)
    uv = torch.where(corner_sel[:, None], best_uv, e_uv)
    level = torch.where(corner_sel, best_level, torch.zeros_like(best_level))
    valid = combined > cfg.min_score
    if free_cells is not None:
        valid = valid & free_cells

    H0, W0 = levels[0].shape
    iu = torch.clamp(uv[:, 0].long(), 0, W0 - 1)
    iv = torch.clamp(uv[:, 1].long(), 0, H0 - 1)
    gxs, gys = gx0[iv, iu], gy0[iv, iu]
    mag = torch.clamp(torch.sqrt(gxs * gxs + gys * gys), min=1e-6)
    grad_dir = torch.stack([gxs / mag, gys / mag], -1)
    score = torch.where(corner_sel, best_score, e_val)
    return Detection(uv=uv, score=score, is_corner=corner_sel, level=level,
                     grad_dir=grad_dir, valid=valid)
