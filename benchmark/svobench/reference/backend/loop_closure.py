"""Appearance-based place recognition — the part of
``stereo_svo_tpu/backend/loop_closure.py`` that the benchmark's
configurations run (no online loop closure: ``online_loop_every`` is 0).

Descriptors: a keyframe's coarse pyramid level average-pooled onto a tiny
grid, zero-mean and unit-norm (dot product = ZNCC), with shifted and
rotated query variants; ``relocalize`` searches the bank with them.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def _pooled_grid(img: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(rows+2, cols+2) average-pooled grid of the image."""
    H, W = img.shape
    R, C = rows + 2, cols + 2
    ch, cw = H // R, W // C
    x = img[: R * ch, : C * cw].to(torch.float32)
    return x.reshape(R, ch, C, cw).mean(dim=(1, 3))


def _normalized(sub: torch.Tensor) -> torch.Tensor:
    sub = sub - sub.mean(-1, keepdim=True)
    n = torch.sqrt(torch.sum(sub * sub, -1, keepdim=True))
    return sub / torch.clamp(n, min=1e-6)


def descriptor(img: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Tiny-thumbnail global descriptor: the centred (rows, cols) sub-grid
    of the pooled grid, zero-mean, unit-norm. (rows*cols,)"""
    grid = _pooled_grid(img, rows, cols)
    return _normalized(grid[1:1 + rows, 1:1 + cols].reshape(-1))


def shifted_descriptors(img: torch.Tensor, rows: int, cols: int
                        ) -> torch.Tensor:
    """(9, rows*cols) descriptors of the ±1-cell-shifted pooling grids."""
    grid = _pooled_grid(img, rows, cols)
    subs = [grid[dy:dy + rows, dx:dx + cols].reshape(-1)
            for dy in (0, 1, 2) for dx in (0, 1, 2)]
    return _normalized(torch.stack(subs))


def _bilinear_grid(grid: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor
                   ) -> torch.Tensor:
    """Bilinear sample of a small (R,C) grid at float coords, clamped."""
    R, C = grid.shape
    sy = torch.clamp(sy, 0.0, R - 1.0)
    sx = torch.clamp(sx, 0.0, C - 1.0)
    y0 = torch.clamp(torch.floor(sy).long(), 0, R - 2)
    x0 = torch.clamp(torch.floor(sx).long(), 0, C - 2)
    fy = sy - y0
    fx = sx - x0
    g00, g01 = grid[y0, x0], grid[y0, x0 + 1]
    g10, g11 = grid[y0 + 1, x0], grid[y0 + 1, x0 + 1]
    return ((1 - fy) * (1 - fx) * g00 + (1 - fy) * fx * g01
            + fy * (1 - fx) * g10 + fy * fx * g11)


def _rotate_image(img: torch.Tensor, angle: float) -> torch.Tensor:
    """Bilinear in-plane rotation about the image centre (border clamped)."""
    H, W = img.shape
    ca, sa = math.cos(float(angle)), math.sin(float(angle))
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=img.device),
        torch.arange(W, dtype=torch.float32, device=img.device),
        indexing="ij")
    dx = xx - cx
    dy = yy - cy
    sx = ca * dx - sa * dy + cx
    sy = sa * dx + ca * dy + cy
    return _bilinear_grid(img.to(torch.float32), sy, sx)


def rotated_descriptors(img: torch.Tensor, rows: int, cols: int,
                        angles) -> torch.Tensor:
    """(len(angles), rows*cols) descriptors of in-plane-rotated views."""
    return torch.stack([descriptor(_rotate_image(img, a), rows, cols)
                        for a in angles])


def query_descriptors(img: torch.Tensor, rows: int, cols: int,
                      n_rot: int = 0, rot_step: float = 0.15
                      ) -> torch.Tensor:
    """All query-side matching variants, (9 + 2·n_rot, rows*cols): the 9
    shifts, then the rotations. The bank stores only the centre
    descriptor; viewpoint tolerance lives on the query side."""
    ds = [shifted_descriptors(img, rows, cols)]
    if n_rot > 0:
        angles = [k * rot_step for k in range(-n_rot, n_rot + 1) if k != 0]
        ds.append(rotated_descriptors(img, rows, cols, angles))
    return torch.cat(ds, 0)


def relocalize(kf_desc: torch.Tensor, kf_valid: torch.Tensor,
               coarse_img: torch.Tensor, rows: int, cols: int,
               n_rot: int = 0, rot_step: float = 0.15,
               rot_gate: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Appearance-nearest bank slot for a query frame: (slot, score);
    invalid slots score -2.

    rot_gate: compute the rotated query variants only when True (the
    engine passes "previous frame failed", which the host holds; the
    reference makes the same choice with ``lax.cond``).
    """
    if not rot_gate:
        n_rot = 0
    q = query_descriptors(coarse_img, rows, cols, n_rot, rot_step)
    sim = kf_desc @ q.T
    scores = torch.amax(sim, -1)
    scores = torch.where(kf_valid, scores, torch.full_like(scores, -2.0))
    return torch.argmax(scores).to(torch.int32), torch.amax(scores)
