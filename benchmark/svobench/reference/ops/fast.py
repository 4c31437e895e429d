"""FAST-9/16 corner scores + edgelet scores as dense maps — port of
``stereo_svo_tpu/ops/fast.py``. Shifts wrap like ``jnp.roll`` (the wrapped
3-px border is masked by the detector's border margin)."""

from __future__ import annotations

import torch

# Bresenham circle of radius 3: (dx, dy), clockwise from 12 o'clock.
_CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
_ARC = 9  # contiguous run length for FAST-9


def _shift(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """I_shift[y, x] = I[y+dy, x+dx] with circular wrap."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))


def corner_score(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9/16 score map (H, W): max over the 16 arcs of the
    minimum absolute contrast within the arc."""
    diffs = (torch.stack([_shift(img, dx, dy) for dx, dy in _CIRCLE])
             - img[None])
    ext = torch.cat([diffs, diffs[: _ARC - 1]], 0)          # (24, H, W)
    # (16, 9, H, W) view of every arc: arc s covers entries s … s+8
    arcs = ext.unfold(0, _ARC, 1).permute(0, 3, 1, 2)
    score_b = arcs.amin(1).amax(0)
    # dark arcs: max_s min_arc(−d) = −min_s max_arc(d), exactly
    score_d = -arcs.amax(1).amin(0)
    return torch.clamp(torch.maximum(score_b, score_d), min=0.0)


def edgelet_score(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Gradient-magnitude map used to score edgelet features."""
    return torch.sqrt(gx * gx + gy * gy)
