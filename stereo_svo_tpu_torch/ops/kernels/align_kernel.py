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
  (partials and counter) is allocated once per device, stream and number
  of problems, and reused in stream order.

The problem axis. Both kernels take B independent problems in one launch
(the reference's ``jax.vmap`` over sequences or loop edges): B3 (B,K,H,W)
images at (B,M,2) centres give (B,K,M,P²), B4 B systems give (B,45), each
problem with its own partials and ticket counter. Problem b equals its
one-problem launch bit for bit. The paths reach them through the
functional custom ops ``svo::sample_patches`` and ``svo::gn_accumulate``,
whose ``torch.func.vmap`` rules move the batch dims to the front, expand an
argument that every problem shares (a template, a shared image) without a
copy, and make one problem-axis launch (nested ``vmap`` too: sequences ×
edges). On the CPU an op runs the plain version; on CUDA its kernel, with
no fallback between the two.
"""

from __future__ import annotations

import torch

from .. import interp
from . import _build
from .pyramid_kernel import _vmap_rule

LAUNCHES = {"sample_patches": 0, "gn_accumulate": 0}
# the CUDA function each counter's launches run (csrc/align.cu)
KERNELS = {"sample_patches": "sample_patch_kernel",
           "gn_accumulate": "gn_accumulate_kernel"}
MAX_IMAGES = 3   # images one B3 launch samples (csrc/align.cu kMaxImages)
N_OUT = 45       # B4's outputs a problem: H (36), g (6), cost, n_eff, n_inl

# (device index, stream, problems) -> (partials, counters) of B4
_SCRATCH = {}


def sample_patches_plain(img: torch.Tensor, uv: torch.Tensor,
                         P: int) -> torch.Tensor:
    """(…,2) centres → (…,P²) bilinear patches of ``img`` (H,W), or
    (K,…,P²) of each plane of ``img`` (K,H,W) (``interp.bilinear`` rule)."""
    pts = uv[..., None, :] + interp.patch_coords(P, img.dtype, img.device)
    if img.dim() == 2:
        return interp.bilinear(img, pts)
    return torch.stack([interp.bilinear(plane, pts) for plane in img])


def sample_patches_batched_plain(img: torch.Tensor, uv: torch.Tensor,
                                 P: int) -> torch.Tensor:
    """Plain version of the problem-axis B3: (*B,K,H,W) images and
    (*B,M,2) centres → (*B,K,M,P²), problem b exactly
    ``sample_patches_plain(img[b], uv[b], P)`` (the same per-tap
    arithmetic, gathered from each problem's own planes)."""
    lead = img.shape[:-3]
    if not lead:
        return sample_patches_plain(img, uv, P)
    K, H, W = img.shape[-3:]
    M = uv.shape[-2]
    pts = uv[..., None, :] + interp.patch_coords(P, img.dtype, img.device)
    pts = pts.unsqueeze(-4).expand(lead + (K, M, P * P, 2))
    out = interp.bilinear(img.reshape(-1, H, W),
                          pts.reshape(-1, M * P * P, 2))
    return out.reshape(lead + (K, M, P * P))


def _check_f32(t: torch.Tensor, name: str) -> None:
    if t.dtype != _build.F32:
        raise TypeError(f"{name}: float32 required, got {t.dtype}")


def _check_lead(lead, t: torch.Tensor, name: str, core: tuple) -> None:
    if tuple(t.shape) != tuple(lead) + tuple(core):
        raise ValueError(f"{name}: shape {tuple(t.shape)} does not match "
                         f"{tuple(lead) + tuple(core)}")


@torch.library.custom_op("svo::sample_patches", mutates_args=())
def sample_patches_op(img: torch.Tensor, uv: torch.Tensor,
                      P: int) -> torch.Tensor:
    """(*B,K,H,W) images (K ≤ 3), (*B,M,2) centres → (*B,K,M,P²) bilinear
    patches: on CUDA one B3 launch for all B·K·M patches."""
    if _build.plain(img, uv):
        return sample_patches_batched_plain(img, uv, P)
    K, H, W = img.shape[-3:]
    lead, M = img.shape[:-3], uv.shape[-2]
    if not 1 <= K <= MAX_IMAGES:
        raise ValueError(f"img: 1 to {MAX_IMAGES} planes, got {K}")
    _check_f32(img, "img")
    _check_f32(uv, "uv")
    _check_lead(lead, uv, "uv", (M, 2))
    src, img_stride = _build.problems(img, 3)
    cen, uv_stride = _build.problems(uv, 2)
    n = src.shape[0]
    if n > _build.MAX_PROBLEMS:
        raise ValueError(f"{n} problems: at most {_build.MAX_PROBLEMS}")
    out = torch.empty((n, K, M, P * P), dtype=img.dtype, device=img.device)
    _build.raise_on_error(_build.load_library().svo_sample_patch(
        src.data_ptr(), img_stride, K, H, W, cen.data_ptr(), uv_stride, M,
        P, out.data_ptr(), n, _build.stream(img.device)), "sample_patches")
    LAUNCHES["sample_patches"] += int(n > 0 and M > 0)
    return out.reshape(lead + (K, M, P * P))


@sample_patches_op.register_fake
def _(img, uv, P):
    return img.new_empty(img.shape[:-2] + (uv.shape[-2], P * P))


def sample_patches(img: torch.Tensor, uv: torch.Tensor,
                   P: int) -> torch.Tensor:
    """(…,2) centres → (…,P²) bilinear patches of ``img`` (H,W), or
    (K,…,P²) of the K ≤ 3 planes of ``img`` (K,H,W), in one launch
    (``svo::sample_patches``; under ``vmap``, one launch for the batch)."""
    _build.plain(img, uv)   # the device rule, before the op
    if img.dim() not in (2, 3):
        raise ValueError(f"img: (H,W) or (K,H,W), got {tuple(img.shape)}")
    img3 = img if img.dim() == 3 else img.unsqueeze(0)
    out = sample_patches_op(img3, uv.reshape(-1, 2), P)
    out = out.reshape((img3.shape[0],) + uv.shape[:-1] + (P * P,))
    return out if img.dim() == 3 else out[0]


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


def gn_accumulate_batched_plain(img, uv, tmpl, jac, mask, P: int,
                                huber_k: float, a_il: torch.Tensor,
                                b_il: torch.Tensor) -> torch.Tensor:
    """Plain version of the problem-axis B4: (*B,H,W), (*B,N,2),
    (*B,N,P²), (*B,N,P²,6), (*B,N,P²) float mask, (*B) a_il, b_il →
    (*B,45) [H row-major, g, cost, n_eff, n_inl]. Without leading dims,
    :func:`gn_accumulate_plain`'s sums; with them, the same terms summed
    by one batched einsum (another order: within float32 rounding of
    the per-problem sums)."""
    lead = uv.shape[:-2]
    if not lead:
        H, g, cost, n_eff, n_inl = gn_accumulate_plain(
            img, uv, tmpl, jac, mask, P, huber_k, a_il, b_il)
        return torch.cat([H.reshape(36), g, torch.stack([cost, n_eff,
                                                         n_inl])])
    cur = sample_patches_batched_plain(img.unsqueeze(-3), uv, P)[..., 0, :, :]
    e = cur - (a_il[..., None, None] * tmpl + b_il[..., None, None])
    a = torch.abs(e)
    w = torch.where(a <= huber_k, torch.ones_like(a),
                    huber_k / torch.clamp(a, min=1e-6)) * mask
    H = torch.einsum("...npi,...np,...npj->...ij", jac, w, jac)
    g = torch.einsum("...npi,...np,...np->...i", jac, w, e)
    sums = torch.stack([torch.sum(w * e * e, (-2, -1)),
                        torch.sum(mask, (-2, -1)),
                        torch.sum((a < huber_k) * mask, (-2, -1))], -1)
    return torch.cat([H.flatten(-2), g, sums], -1)


def _scratch(device: torch.device, stream: int, n: int):
    """B4's partial sums and ticket counters for n problems on this device
    and stream, allocated (the counters zeroed) at the first call; the
    kernel leaves every counter at 0 for the next call on the stream. (One
    allocation for each number of problems, never resized: a CUDA graph
    keeps the pointers it captured.)"""
    key = (device.index, stream, n)
    if key not in _SCRATCH:
        floats = _build.load_library().svo_gn_scratch_floats()
        _SCRATCH[key] = (
            torch.empty(n * floats, dtype=torch.float32, device=device),
            torch.zeros(n, dtype=torch.int32, device=device))
    return _SCRATCH[key]


@torch.library.custom_op("svo::gn_accumulate", mutates_args=())
def gn_accumulate_op(img: torch.Tensor, uv: torch.Tensor, tmpl: torch.Tensor,
                     jac: torch.Tensor, mask: torch.Tensor, P: int,
                     huber_k: float, a_il: torch.Tensor,
                     b_il: torch.Tensor) -> torch.Tensor:
    """B independent refresh passes: (*B,H,W), (*B,N,2), (*B,N,P²),
    (*B,N,P²,6), (*B,N,P²) float mask, (*B) a_il, b_il → (*B,45); on CUDA
    one B4 launch for all of them."""
    if _build.plain(img, uv, tmpl, jac, mask, a_il, b_il):
        return gn_accumulate_batched_plain(img, uv, tmpl, jac, mask, P,
                                           huber_k, a_il, b_il)
    lead, N = uv.shape[:-2], uv.shape[-2]
    H, W = img.shape[-2:]
    P2 = P * P
    for t, name, core in ((img, "img", (H, W)), (uv, "uv", (N, 2)),
                          (tmpl, "tmpl", (N, P2)), (jac, "jac", (N, P2, 6)),
                          (mask, "mask", (N, P2)), (a_il, "a_il", ()),
                          (b_il, "b_il", ())):
        _check_f32(t, name)
        _check_lead(lead, t, name, core)
    img_p, s_img = _build.problems(img, 2)
    uv_p, s_uv = _build.problems(uv, 2)
    tmpl_p, s_tmpl = _build.problems(tmpl, 2)
    jac_p, s_jac = _build.problems(jac, 3)
    if s_jac % 2 or jac_p.data_ptr() % 8:
        raise ValueError("jac: every problem's Jacobians 8-byte aligned "
                         "required (read as float2)")
    mask_p, s_mask = _build.problems(mask, 2)
    a_p, s_a = _build.problems(a_il, 0)
    b_p, s_b = _build.problems(b_il, 0)
    n = uv_p.shape[0]
    if n > _build.MAX_PROBLEMS:
        raise ValueError(f"{n} problems: at most {_build.MAX_PROBLEMS}")
    stream = _build.stream(img.device)
    partials, counters = _scratch(img.device, stream, n)
    out = torch.empty((n, N_OUT), dtype=torch.float32, device=img.device)
    _build.raise_on_error(_build.load_library().svo_gn_accumulate(
        img_p.data_ptr(), s_img, H, W, uv_p.data_ptr(), s_uv,
        tmpl_p.data_ptr(), s_tmpl, jac_p.data_ptr(), s_jac,
        mask_p.data_ptr(), s_mask, N, P, a_p.data_ptr(), s_a,
        b_p.data_ptr(), s_b, float(huber_k), partials.data_ptr(),
        counters.data_ptr(), out.data_ptr(), n, stream), "gn_accumulate")
    LAUNCHES["gn_accumulate"] += int(n > 0)
    return out.reshape(lead + (N_OUT,))


@gn_accumulate_op.register_fake
def _(img, uv, tmpl, jac, mask, P, huber_k, a_il, b_il):
    return uv.new_empty(uv.shape[:-2] + (N_OUT,))


torch.library.register_vmap(sample_patches_op, _vmap_rule(sample_patches_op))
torch.library.register_vmap(gn_accumulate_op, _vmap_rule(gn_accumulate_op))


def gn_accumulate(img: torch.Tensor, uv: torch.Tensor, tmpl: torch.Tensor,
                  jac: torch.Tensor, mask: torch.Tensor, P: int,
                  huber_k: float, a_il: torch.Tensor, b_il: torch.Tensor):
    """Fused refresh pass of ``ops/align.align`` (``svo::gn_accumulate``;
    under ``vmap``, one launch for the batch).

    img: (H,W) level image; uv: (N,2) projected centres (level pixels);
    tmpl: (N,P²); jac: (N,P²,6); mask: (N,P²) per-pixel validity, or (N,)
    per-feature weight (broadcast over the patch); a_il, b_il: 0-dim
    tensors, the global illumination pair — residual e = cur − (a·tmpl + b).
    Returns H (6,6) = JᵀWJ, g (6,) = JᵀWe, cost = Σ w·e², n_eff = Σ mask
    and n_inl = Σ (|e| < k)·mask, with w = Huber_k(e)·mask.
    """
    _build.plain(img, uv, tmpl, jac, mask, a_il, b_il)   # the device rule
    out = gn_accumulate_op(img, uv, tmpl, jac,
                           _full_mask(mask, uv.shape[0], P), P,
                           float(huber_k), a_il, b_il)
    return out[:36].reshape(6, 6), out[36:42], out[42], out[43], out[44]
