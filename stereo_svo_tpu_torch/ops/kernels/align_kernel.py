"""Alignment kernels B3 (patch sampling) and B4 (fused Gauss-Newton
accumulation): CUDA wrappers, plain PyTorch versions and launch counters.

Source note. Replaces the Pallas TPU kernels
``stereo_svo_tpu/ops/pallas/align_kernel.py::sample_patches``
(``_sample_kernel`` with ``_prep_indices``/``_extract_window``/
``_bilinear_window``) and ``::gn_accumulate`` (``_gn_kernel``); CUDA source
in ``csrc/align.cu``, whose header gives the design in full.

What bounds them: at the main path's sizes (192 centres, P = 4 or 8) each
call moves ~100 KB — 0.03 µs at the card's memory rate — so launch latency
and the host's cost per call decide their time, not bytes or operations.

* B3 samples up to three same-shape images (one (K,H,W) buffer, K ≤ 3: a
  pyramid level's image, gx and gy) at the same centres in one launch.
  A group of threads per centre stages the centre's (P+2)² footprint in
  shared memory once and every output reads its four taps there; outputs
  whose taps the border clamp moves read them from device memory. Each
  output computes its taps exactly as ``interp.bilinear`` does, so the
  result equals the plain version bit for bit. Border rule: per tap, as
  ``ops/interp.bilinear`` (not the Pallas centre clamp).
* B4 fuses the sample, the illumination-corrected residual, the Huber
  weight and the 6×6 normal equations: 30 sums over N·P² terms (3,072 at
  N=192, P=4), in one launch. Each block writes its partial sums to
  scratch and takes a ticket; the last block adds the partials in block
  order and resets the ticket counter. No float atomics and a fixed
  assignment of terms to threads for each (N, P): a call repeats bit for
  bit (at P = 4, the assignment and reduction tree of the earlier
  two-launch design, whose sums it repeats exactly). The scratch
  (partials and counter) is allocated once per device and stream and
  reused in stream order.
"""

from __future__ import annotations

import torch

from .. import interp
from . import _build

LAUNCHES = {"sample_patches": 0, "gn_accumulate": 0}
# the CUDA function each counter's launches run (csrc/align.cu)
KERNELS = {"sample_patches": "sample_patch_kernel",
           "gn_accumulate": "gn_accumulate_kernel"}
MAX_IMAGES = 3   # images one B3 launch samples (csrc/align.cu kMaxImages)

_SCRATCH = {}    # (device index, stream) -> (partials, counter) of B4


def sample_patches_plain(img: torch.Tensor, uv: torch.Tensor,
                         P: int) -> torch.Tensor:
    """(…,2) centres → (…,P²) bilinear patches of ``img`` (H,W), or
    (K,…,P²) of each plane of ``img`` (K,H,W) (``interp.bilinear`` rule)."""
    pts = uv[..., None, :] + interp.patch_coords(P, img.dtype, img.device)
    if img.dim() == 2:
        return interp.bilinear(img, pts)
    return torch.stack([interp.bilinear(plane, pts) for plane in img])


def sample_patches(img: torch.Tensor, uv: torch.Tensor,
                   P: int) -> torch.Tensor:
    """(…,2) centres → (…,P²) bilinear patches of ``img`` (H,W), or
    (K,…,P²) of the K ≤ 3 planes of ``img`` (K,H,W), in one launch."""
    if _build.plain(img, uv):
        return sample_patches_plain(img, uv, P)
    if img.dim() == 3:
        K, H, W = img.shape
        if not 1 <= K <= MAX_IMAGES:
            raise ValueError(f"img: 1 to {MAX_IMAGES} planes, got {K}")
        planes = (K,)
    else:
        K, planes = 1, ()
        H, W = img.shape[-2:]
    _build.check(img, "img", planes + (H, W))
    _build.check(uv, "uv", uv.shape[:-1] + (2,))
    out = torch.empty(planes + uv.shape[:-1] + (P * P,), dtype=img.dtype,
                      device=img.device)
    _build.raise_on_error(_build.load_library().svo_sample_patch(
        img.data_ptr(), K, H, W, uv.data_ptr(), uv.numel() // 2, P,
        out.data_ptr(), _build.stream(img.device)), "sample_patches")
    LAUNCHES["sample_patches"] += 1
    return out


def _full_mask(mask: torch.Tensor, N: int, P: int) -> torch.Tensor:
    """Per-pixel (N,P²) float mask from a per-pixel or per-feature mask."""
    if mask.dim() == 1:
        mask = mask[:, None].expand(N, P * P)
    return mask.to(torch.float32)


def gn_accumulate_plain(img, uv, tmpl, jac, mask, P: int, huber_k: float,
                        a_il: torch.Tensor, b_il: torch.Tensor):
    """Plain version of :func:`gn_accumulate`."""
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


def _scratch(device: torch.device, stream: int):
    """B4's partial sums and ticket counter for this device and stream,
    allocated (the counter zeroed) at the first call; the kernel leaves the
    counter at 0 for the next call on the stream."""
    key = (device.index, stream)
    if key not in _SCRATCH:
        n = _build.load_library().svo_gn_scratch_floats()
        _SCRATCH[key] = (torch.empty(n, dtype=torch.float32, device=device),
                         torch.zeros(1, dtype=torch.int32, device=device))
    return _SCRATCH[key]


def gn_accumulate(img: torch.Tensor, uv: torch.Tensor, tmpl: torch.Tensor,
                  jac: torch.Tensor, mask: torch.Tensor, P: int,
                  huber_k: float, a_il: torch.Tensor, b_il: torch.Tensor):
    """Fused refresh pass of ``ops/align.align``.

    img: (H,W) level image; uv: (N,2) projected centres (level pixels);
    tmpl: (N,P²); jac: (N,P²,6); mask: (N,P²) per-pixel validity, or (N,)
    per-feature weight (broadcast over the patch); a_il, b_il: 0-dim
    tensors, the global illumination pair — residual e = cur − (a·tmpl + b).
    Returns H (6,6) = JᵀWJ, g (6,) = JᵀWe, cost = Σ w·e², n_eff = Σ mask
    and n_inl = Σ (|e| < k)·mask, with w = Huber_k(e)·mask.
    """
    if _build.plain(img, uv, tmpl, jac, mask, a_il, b_il):
        return gn_accumulate_plain(img, uv, tmpl, jac, mask, P, huber_k,
                                   a_il, b_il)
    N, P2 = uv.shape[0], P * P
    H, W = img.shape[-2:]
    m = _full_mask(mask, N, P).contiguous()
    for t, name, shape in ((img, "img", (H, W)), (uv, "uv", (N, 2)),
                           (tmpl, "tmpl", (N, P2)), (jac, "jac", (N, P2, 6)),
                           (m, "mask", (N, P2)), (a_il, "a_il", ()),
                           (b_il, "b_il", ())):
        _build.check(t, name, shape)
    if jac.data_ptr() % 8:
        raise ValueError("jac: 8-byte aligned storage required (read as "
                         "float2)")
    stream = _build.stream(img.device)
    partials, counter = _scratch(img.device, stream)
    out = torch.empty(45, dtype=torch.float32, device=img.device)
    _build.raise_on_error(_build.load_library().svo_gn_accumulate(
        img.data_ptr(), H, W, uv.data_ptr(), tmpl.data_ptr(), jac.data_ptr(),
        m.data_ptr(), N, P, a_il.data_ptr(), b_il.data_ptr(), float(huber_k),
        partials.data_ptr(), counter.data_ptr(), out.data_ptr(), stream),
        "gn_accumulate")
    LAUNCHES["gn_accumulate"] += 1
    return out[:36].view(6, 6), out[36:42], out[42], out[43], out[44]
