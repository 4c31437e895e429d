"""Image pyramid + gradient maps — port of ``stereo_svo_tpu/ops/pyramid.py``.

A pyramid is a tuple of (H/2^l, W/2^l) float32 tensors. On CUDA,
:func:`build_with_gradients` builds every level with one launch of kernel
B1 and every level's gradient maps with one launch of kernel B2
(``kernels/pyramid_kernel``).
"""

from __future__ import annotations

import torch
from torch._C._functorch import is_batchedtensor

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
    """Pyramid plus per-level gradient maps: (levels, grads_x, grads_y).

    Each level lives in one (3,h,w) buffer [image, gx, gy], all of them
    views of one tensor that the functional op ``svo::pyramid`` returns:
    one B1 launch writes every image plane (level 0 a copy of ``img``), one
    B2 launch every level's gx and gy, and building a template samples all
    three with one B3 launch through :func:`level_planes`. Under
    ``torch.func.vmap`` the same launches take the whole batch."""
    bufs = pyramid_kernel.pyramid_with_gradients(img, num_levels)
    return (tuple(b[0] for b in bufs), tuple(b[1] for b in bufs),
            tuple(b[2] for b in bufs))


def level_planes(img: torch.Tensor, gx: torch.Tensor,
                 gy: torch.Tensor) -> torch.Tensor:
    """(3,h,w) [img, gx, gy] of one level: a view of the buffer
    :func:`build_with_gradients` keeps the level in, or a stacked copy when
    the three maps were built apart or are batched (under ``vmap`` a
    tensor has no storage to test; the copy is one kernel for the
    batch)."""
    if is_batchedtensor(img) or is_batchedtensor(gx) or is_batchedtensor(gy):
        return torch.stack([img, gx, gy])
    n, size = img.numel(), img.element_size()
    if (img.is_contiguous() and gx.is_contiguous() and gy.is_contiguous()
            and img.dtype == gx.dtype == gy.dtype
            and img.shape == gx.shape == gy.shape
            and gx.data_ptr() == img.data_ptr() + n * size
            and gy.data_ptr() == img.data_ptr() + 2 * n * size
            and img.untyped_storage().data_ptr()
            == gx.untyped_storage().data_ptr()
            == gy.untyped_storage().data_ptr()):
        return img.as_strided((3,) + tuple(img.shape),
                              (n,) + tuple(img.stride()))
    return torch.stack([img, gx, gy])
