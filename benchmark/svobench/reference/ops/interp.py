"""Bilinear image sampling — port of ``stereo_svo_tpu/ops/interp.py``,
gather path only (the tent-kernel MXU path was a TPU device).

``sample_patch`` runs kernel B3 on CUDA (``kernels/align_kernel``);
``sample_rect`` stays a plain gather (no TPU kernel existed for it).
"""

from __future__ import annotations

import torch

from .kernels import align_kernel


def _taps(img: torch.Tensor, uv: torch.Tensor):
    """Clamped taps and fractions of ``interp.bilinear``. ``img`` is (H,W),
    or a batch (N,H,W) with ``uv`` (N,…,2): entry n samples image n only
    (the reference's ``vmap`` over per-feature images)."""
    H, W = img.shape[-2:]
    u = torch.clamp(uv[..., 0], 0.0, W - 1.000001)
    v = torch.clamp(uv[..., 1], 0.0, H - 1.000001)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    # indices clamped again: a NaN coordinate converts to an arbitrary
    # integer, which the reference's gather clamps implicitly
    iu0 = u0.long().clamp(0, W - 1)
    iv0 = v0.long().clamp(0, H - 1)
    iu1 = torch.clamp(iu0 + 1, max=W - 1)
    iv1 = torch.clamp(iv0 + 1, max=H - 1)
    if img.dim() == 2:
        return (img[iv0, iu0], img[iv0, iu1], img[iv1, iu0], img[iv1, iu1],
                du, dv)
    flat = img.reshape(img.shape[0], H * W)

    def tap(iv, iu):
        idx = (iv * W + iu).reshape(img.shape[0], -1)
        return torch.gather(flat, 1, idx).reshape(iv.shape)

    return (tap(iv0, iu0), tap(iv0, iu1), tap(iv1, iu0), tap(iv1, iu1),
            du, dv)


def bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (H,W) at ``uv`` (…,2) [u = column, v = row]; taps
    clamp to the border (callers mask validity separately)."""
    p00, p01, p10, p11, du, dv = _taps(img, uv)
    top = p00 + du * (p01 - p00)
    bot = p10 + du * (p11 - p10)
    return top + dv * (bot - top)


def bilinear_with_grad(img: torch.Tensor, uv: torch.Tensor):
    """Sample value and the analytic gradient of the bilinear interpolant;
    ``img`` (H,W) or a per-feature batch (N,H,W), as ``_taps``."""
    p00, p01, p10, p11, du, dv = _taps(img, uv)
    val = (p00 * (1 - du) * (1 - dv) + p01 * du * (1 - dv)
           + p10 * (1 - du) * dv + p11 * du * dv)
    gu = (p01 - p00) * (1 - dv) + (p11 - p10) * dv
    gv = (p10 - p00) * (1 - du) + (p11 - p01) * du
    return val, gu, gv


def patch_coords(patch: int, dtype=torch.float32, device=None
                 ) -> torch.Tensor:
    """Centred patch offsets: (patch², 2) of (du, dv), row-major."""
    r = torch.arange(patch, dtype=dtype, device=device) - (patch - 1) / 2.0
    dv, du = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([du.reshape(-1), dv.reshape(-1)], -1)


def sample_patch(img: torch.Tensor, center_uv: torch.Tensor,
                 patch: int) -> torch.Tensor:
    """(…,patch²) intensity patches centred at (…,2) points (kernel B3);
    ``img`` (K,H,W) with K ≤ 3 gives (K,…,patch²), one launch."""
    return align_kernel.sample_patches(img, center_uv, patch)


def sample_rect(img: torch.Tensor, center_uv: torch.Tensor,
                row_offs: torch.Tensor, col_offs: torch.Tensor
                ) -> torch.Tensor:
    """(N,2) centres + (P,)/(Q,) offsets → (N,P,Q) bilinear samples."""
    N = center_uv.shape[0]
    P, Q = row_offs.shape[0], col_offs.shape[0]
    su = center_uv[:, None, None, 0] + col_offs[None, None, :]
    sv = center_uv[:, None, None, 1] + row_offs[None, :, None]
    return bilinear(img, torch.stack([su.expand(N, P, Q),
                                      sv.expand(N, P, Q)], -1))
