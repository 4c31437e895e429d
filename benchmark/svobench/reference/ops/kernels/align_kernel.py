"""Kernels B3 (patch sampling) and B4 (Gauss-Newton accumulation) in plain
PyTorch: the plain versions of the program's CUDA kernels, frozen with the
rest of this reference."""

from __future__ import annotations

import torch

from .. import interp


def sample_patches_plain(img: torch.Tensor, uv: torch.Tensor,
                         P: int) -> torch.Tensor:
    """(…,2) centres → (…,P²) bilinear patches of ``img`` (H,W), or
    (K,…,P²) of each plane of ``img`` (K,H,W)."""
    pts = uv[..., None, :] + interp.patch_coords(P, img.dtype, img.device)
    if img.dim() == 2:
        return interp.bilinear(img, pts)
    return torch.stack([interp.bilinear(plane, pts) for plane in img])


def sample_patches(img: torch.Tensor, uv: torch.Tensor,
                   P: int) -> torch.Tensor:
    if img.dim() not in (2, 3):
        raise ValueError(f"img: (H,W) or (K,H,W), got {tuple(img.shape)}")
    return sample_patches_plain(img, uv, P)


def _full_mask(mask: torch.Tensor, N: int, P: int) -> torch.Tensor:
    """Per-pixel (N,P²) float mask from a per-pixel or per-feature mask."""
    if mask.dim() == 1:
        mask = mask[:, None].expand(N, P * P)
    return mask.to(torch.float32)


def gn_accumulate(img, uv, tmpl, jac, mask, P: int, huber_k: float,
                  a_il: torch.Tensor, b_il: torch.Tensor):
    """H (6,6) = JᵀWJ, g (6,) = JᵀWe, cost = Σ w·e², n_eff = Σ mask and
    n_inl = Σ (|e| < k)·mask, with w = Huber_k(e)·mask and the residual
    e = sample(img, uv) − (a_il·tmpl + b_il)."""
    N = uv.shape[0]
    m = _full_mask(mask, N, P)
    cur = sample_patches_plain(img, uv, P)
    e = cur - (a_il * tmpl + b_il)
    a = torch.abs(e)
    w = torch.where(a <= huber_k, torch.ones_like(a),
                    huber_k / torch.clamp(a, min=1e-6)) * m
    H = torch.einsum("npi,np,npj->ij", jac, w, jac)
    g = torch.einsum("npi,np,np->i", jac, w, e)
    return (H, g, torch.sum(w * e * e), torch.sum(m),
            torch.sum((a < huber_k) * m))
