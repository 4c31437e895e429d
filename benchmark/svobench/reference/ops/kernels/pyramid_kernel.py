"""Kernels B1 (pyramid levels) and B2 (gradients) in plain PyTorch: the
plain versions of the program's CUDA kernels, frozen with the rest of this
reference. Every function runs on any device, element for element as the
program's plain versions do."""

from __future__ import annotations

import torch


def halfsample_plain(img: torch.Tensor) -> torch.Tensor:
    """2×2 mean of (…,H,W); an odd trailing row/column is dropped."""
    H, W = img.shape[-2:]
    x = img[..., : (H // 2) * 2, : (W // 2) * 2]
    return (((x[..., 0::2, 0::2] + x[..., 0::2, 1::2]) + x[..., 1::2, 0::2])
            + x[..., 1::2, 1::2]) * 0.25


def pyramid_plain(img: torch.Tensor, num_levels: int) -> tuple:
    """The ``num_levels`` image levels of (…,H,W)."""
    levels = [img]
    for _ in range(num_levels - 1):
        levels.append(halfsample_plain(levels[-1]))
    return tuple(levels)


def gradients_plain(img: torch.Tensor):
    """Central differences (gx, gy) of (…,H,W); border columns/rows are
    0."""
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[..., :, 1:-1] = 0.5 * (img[..., :, 2:] - img[..., :, :-2])
    gy[..., 1:-1, :] = 0.5 * (img[..., 2:, :] - img[..., :-2, :])
    return gx, gy


def pyramid_with_gradients(img: torch.Tensor, num_levels: int) -> tuple:
    """Every level's (…,3,h_l,w_l) [image, gx, gy] buffer of (…,H,W)."""
    return tuple(torch.stack([level, *gradients_plain(level)], -3)
                 for level in pyramid_plain(img, num_levels))


def halfsample(img: torch.Tensor) -> torch.Tensor:
    return halfsample_plain(img)


def gradients(img: torch.Tensor):
    return gradients_plain(img)
