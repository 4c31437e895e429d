"""Alignment kernels B3 (patch sampling) and B4 (fused Gauss-Newton
accumulation): CUDA wrappers, plain PyTorch versions and launch counters.

Source note. Replaces the Pallas TPU kernels
``stereo_svo_tpu/ops/pallas/align_kernel.py::sample_patches``
(``_sample_kernel`` with ``_prep_indices``/``_extract_window``/
``_bilinear_window``) and ``::gn_accumulate`` (``_gn_kernel``); CUDA source
in ``csrc/align.cu``.

* B3 is a gather: N·P² independent 4-tap samples (192×64 at P=8), bound by
  launch latency at main-path sizes and by L2 gather traffic beyond. One
  thread per (centre, patch pixel); the TPU's one-hot window extraction is
  unnecessary because Hopper gathers natively. Border rule: per tap, as
  ``ops/interp.bilinear`` (not the Pallas centre clamp).
* B4 fuses the sample, the illumination-corrected residual, the Huber
  weight and the 6×6 normal equations: 30 running sums over N·P² terms
  (3,072 at N=192, P=4) — a reduction of a few hundred kFLOP, bound by
  launch latency. Each block reduces its grid-strided terms in registers
  and a fixed shuffle tree to per-block partials in a scratch buffer; one
  fixed-order final pass adds the partials. No float atomics, so a run on
  one card repeats bit for bit.
"""

from __future__ import annotations

import torch

from .. import interp
from . import _build

LAUNCHES = {"sample_patches": 0, "gn_accumulate": 0}


def sample_patches_plain(img: torch.Tensor, uv: torch.Tensor,
                         P: int) -> torch.Tensor:
    """(…,2) centres → (…,P²) bilinear patches (``interp.bilinear`` rule)."""
    offs = interp.patch_coords(P, img.dtype, img.device)
    return interp.bilinear(img, uv[..., None, :] + offs)


def sample_patches(img: torch.Tensor, uv: torch.Tensor,
                   P: int) -> torch.Tensor:
    """(…,2) centres → (…,P²) bilinear patches of ``img`` (H,W)."""
    if _build.is_cpu(img, uv):
        return sample_patches_plain(img, uv, P)
    _build.check(img, "img", (None, None))
    lead = uv.shape[:-1]
    flat = uv.reshape(-1, 2).contiguous()
    _build.check(flat, "uv", (None, 2))
    out = torch.empty(lead + (P * P,), dtype=img.dtype, device=img.device)
    H, W = img.shape
    lib = _build.load_library()
    _build.raise_on_error(lib.svo_sample_patch(
        img.data_ptr(), H, W, flat.data_ptr(), flat.shape[0], P,
        out.data_ptr(), _build.stream()), "sample_patches")
    LAUNCHES["sample_patches"] += 1
    return out


def _full_mask(mask: torch.Tensor, N: int, P: int) -> torch.Tensor:
    """Per-pixel (N,P²) float mask from a per-pixel or per-feature mask."""
    if mask.dim() == 1:
        mask = mask[:, None].expand(N, P * P)
    return mask.to(torch.float32)


def gn_accumulate_plain(img, uv, tmpl, jac, mask, P: int, huber_k: float,
                        ab: torch.Tensor):
    """Plain version of :func:`gn_accumulate`."""
    N = uv.shape[0]
    m = _full_mask(mask, N, P)
    cur = sample_patches_plain(img, uv, P)
    e = cur - (ab[0] * tmpl + ab[1])
    a = torch.abs(e)
    w = torch.where(a <= huber_k, torch.ones_like(a),
                    huber_k / torch.clamp(a, min=1e-6)) * m
    H = torch.einsum("npi,np,npj->ij", jac, w, jac)
    g = torch.einsum("npi,np,np->i", jac, w, e)
    return (H, g, torch.sum(w * e * e), torch.sum(m),
            torch.sum((a < huber_k) * m))


def gn_accumulate(img: torch.Tensor, uv: torch.Tensor, tmpl: torch.Tensor,
                  jac: torch.Tensor, mask: torch.Tensor, P: int,
                  huber_k: float, ab: torch.Tensor):
    """Fused refresh pass of ``ops/align.align``.

    img: (H,W) level image; uv: (N,2) projected centres (level pixels);
    tmpl: (N,P²); jac: (N,P²,6); mask: (N,P²) per-pixel validity, or (N,)
    per-feature weight (broadcast over the patch); ab: (2,) tensor, the
    global illumination pair — residual e = cur − (a·tmpl + b).
    Returns H (6,6) = JᵀWJ, g (6,) = JᵀWe, cost = Σ w·e², n_eff = Σ mask
    and n_inl = Σ (|e| < k)·mask, with w = Huber_k(e)·mask.
    """
    if _build.is_cpu(img, uv, tmpl, jac, mask, ab):
        return gn_accumulate_plain(img, uv, tmpl, jac, mask, P, huber_k, ab)
    N = uv.shape[0]
    _build.check(img, "img", (None, None))
    _build.check(uv, "uv", (N, 2))
    _build.check(tmpl, "tmpl", (N, P * P))
    _build.check(jac, "jac", (N, P * P, 6))
    _build.check(ab, "ab", (2,))
    m = _full_mask(mask, N, P).contiguous()
    lib = _build.load_library()
    partials = torch.empty(lib.svo_gn_blocks(N, P) * 30, dtype=torch.float32,
                           device=img.device)
    out = torch.empty(45, dtype=torch.float32, device=img.device)
    H, W = img.shape
    _build.raise_on_error(lib.svo_gn_accumulate(
        img.data_ptr(), H, W, uv.data_ptr(), tmpl.data_ptr(), jac.data_ptr(),
        m.data_ptr(), N, P, ab.data_ptr(), float(huber_k),
        partials.data_ptr(), out.data_ptr(), _build.stream()),
        "gn_accumulate")
    LAUNCHES["gn_accumulate"] += 1
    return out[:36].view(6, 6), out[36:42], out[42], out[43], out[44]
