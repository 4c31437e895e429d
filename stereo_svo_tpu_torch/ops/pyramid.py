"""Image pyramid + gradient maps — port of ``stereo_svo_tpu/ops/pyramid.py``.

A pyramid is a tuple of (H/2^l, W/2^l) float32 tensors. On CUDA every
level runs kernel B1 (half-sample) and every gradient map kernel B2
(``kernels/pyramid_kernel``).
"""

from __future__ import annotations

import torch

from .kernels import pyramid_kernel


def halfsample(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean downsample; odd trailing row/col dropped."""
    return pyramid_kernel.halfsample(img)


def build(img: torch.Tensor, num_levels: int):
    """Intensity pyramid: level 0 is the input image."""
    levels = [img]
    for _ in range(num_levels - 1):
        levels.append(halfsample(levels[-1]))
    return tuple(levels)


def gradients(img: torch.Tensor):
    """Central-difference gradients (gx, gy), border clamped to 0."""
    return pyramid_kernel.gradients(img)


def build_with_gradients(img: torch.Tensor, num_levels: int):
    """Pyramid plus per-level gradient maps: (levels, grads_x, grads_y)."""
    levels = build(img, num_levels)
    grads = [gradients(lv) for lv in levels]
    return (levels, tuple(g[0] for g in grads), tuple(g[1] for g in grads))
