"""Alignment kernels B3 (patch sampling), B4 (fused Gauss-Newton
accumulation) and ``align_levels_kernel`` (the whole alignment in one
launch): CUDA wrappers, plain PyTorch versions and launch counters.

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

``align_levels_kernel`` (``svo::align_levels``) replaces no Pallas
kernel: it fuses the ``jnp`` chain of ``stereo_svo_tpu/ops/align.py:align``
(every level, refresh pass and inner pass of the coarse-to-fine IC
Gauss-Newton) with B4's accumulation. Why: on the graphed main path that
chain was ~3,135 kernel nodes a frame (4.3 ms of a 9.4-ms frame); it is one.
What bounds it: the latency of 15 dependent passes, each a sweep over
N·P² terms, one to three reductions over the problem and, on a refresh
pass, a 6×6 factorisation and solve; not bytes. Design: a cluster of 8
thread blocks a problem, each taking an eighth of the features, reducing
through distributed shared memory; the features projected once a pass into
shared memory; each thread's terms, their samples and Huber weights, in
shared memory between the sweeps and passes that reuse them; the refresh
pass's illumination fit in two sweeps, B4's 30 sums, one factorisation by
``solve.chol_solve_small``'s rule for H⁻¹ and the step, ``se3.exp``'s
formula; no float atomics, so a call repeats bit for bit. Its plain version
is ``ops/align.chain``, problem by problem; ``csrc/align.cu`` gives the
design in full.

The problem axis. All three kernels take B independent problems in one
launch (the reference's ``jax.vmap`` over sequences or loop edges): B3
(B,K,H,W) images at (B,M,2) centres give (B,K,M,P²), B4 B systems give
(B,45), each problem with its own partials and ticket counter, and
``align_levels`` B alignments give (B,14), a cluster each. Problem b equals
its one-problem launch bit for bit. The paths reach them through the
functional custom ops ``svo::sample_patches``, ``svo::gn_accumulate`` and
``svo::align_levels``, whose ``torch.func.vmap`` rules move the batch dims
to the front, expand an argument that every problem shares (a template, a
shared image) without a copy, and make one problem-axis launch (nested
``vmap`` too: sequences × edges). On the CPU an op runs the plain
version; on CUDA its kernel, with no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import List

import torch

from .. import interp
from . import _build
from .pyramid_kernel import _vmap_rule

# launches by counter (the kernels: ops.kernels.KERNELS)
LAUNCHES = {"sample_patches": 0, "gn_accumulate": 0, "align_levels": 0}
MAX_IMAGES = 3   # images one B3 launch samples (csrc/align.cu kMaxImages)
N_OUT = 45       # B4's outputs a problem: H (36), g (6), cost, n_eff, n_inl
ALIGN_OUT = 14   # align_levels' outputs a problem: T (12), cost, inlier share
MAX_ALIGN_LEVELS = 8   # levels of one align_levels launch (kMaxAlignLevels)

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


def _align_static(intrinsics, bounds, schedule, P, huber_k, illum_affine):
    """The ``ops/align.Spec`` of the op's static arguments."""
    from .. import align
    L = len(schedule) // 2
    return align.Spec(
        levels=tuple(range(L)),
        intrinsics=tuple(tuple(intrinsics[4 * i:4 * i + 4]) for i in range(L)),
        bounds=tuple(tuple(bounds[2 * i:2 * i + 2]) for i in range(L)),
        schedule=tuple(tuple(schedule[2 * i:2 * i + 2]) for i in range(L)),
        patch=P, huber_k=huber_k, illum_affine=illum_affine)


def align_levels_plain(levels, p_ref, patches, jac, mask, T_init,
                       intrinsics, bounds, schedule, P: int, huber_k: float,
                       illum_affine: bool) -> torch.Tensor:
    """Plain version of ``svo::align_levels``: ``ops/align.chain`` on each
    problem in turn, (*B,14) [T row-major, cost, inlier share]; problem b
    exactly its call alone."""
    from .. import align
    s = _align_static(intrinsics, bounds, schedule, P, huber_k, illum_affine)
    lead = T_init.shape[:-2]
    n = T_init[..., 0, 0].numel()

    def one(t):
        return t.reshape((n,) + t.shape[len(lead):])

    lv, args = [one(x) for x in levels], [one(x) for x in (
        p_ref, patches, jac, mask, T_init)]
    outs = []
    for b in range(n):
        T, stats = align.chain([x[b] for x in lv], *(a[b] for a in args), s)
        outs.append(torch.cat([T.reshape(12), stats["align_cost"][None],
                               stats["align_inlier_frac"][None]]))
    out = torch.stack(outs) if outs else T_init.new_empty((0, ALIGN_OUT))
    return out.reshape(lead + (ALIGN_OUT,))


@torch.library.custom_op("svo::align_levels", mutates_args=())
def align_levels_op(levels: List[torch.Tensor], p_ref: torch.Tensor,
                    patches: torch.Tensor, jac: torch.Tensor,
                    mask: torch.Tensor, T_init: torch.Tensor,
                    intrinsics: List[float], bounds: List[float],
                    schedule: List[int], P: int, huber_k: float,
                    illum_affine: bool) -> torch.Tensor:
    """B independent alignments: per aligned level li (coarse→fine) the
    (*B,H_l,W_l) image ``levels[li]``, its (fx, fy, cx, cy) at
    ``intrinsics[4li:]``, in-bounds (u, v) limits at ``bounds[2li:]`` and
    (refresh passes, inner passes after each) at ``schedule[2li:]``; the
    template's (*B,N,3) points, (*B,L,N,P²) patches, (*B,L,N,P²,6)
    Jacobians and (*B,N) bool mask; (*B,3,4) T_init → (*B,14) [T, cost,
    inlier share]. On CUDA one ``align_levels_kernel`` launch for all of
    them."""
    if _build.plain(*levels, p_ref, patches, jac, mask, T_init):
        return align_levels_plain(levels, p_ref, patches, jac, mask, T_init,
                                  intrinsics, bounds, schedule, P, huber_k,
                                  illum_affine)
    L = len(levels)
    lead, N = T_init.shape[:-2], p_ref.shape[-2]
    P2 = P * P
    if not 0 <= L <= MAX_ALIGN_LEVELS or len(intrinsics) != 4 * L \
            or len(bounds) != 2 * L or len(schedule) != 2 * L:
        raise ValueError(f"align_levels: {L} levels (at most "
                         f"{MAX_ALIGN_LEVELS}) with {len(intrinsics)} "
                         f"intrinsics, {len(bounds)} bounds and "
                         f"{len(schedule)} schedule entries")
    for t, name, core in ((p_ref, "p_ref", (N, 3)),
                          (patches, "patches", (L, N, P2)),
                          (jac, "jac", (L, N, P2, 6)),
                          (T_init, "T_init", (3, 4))):
        _check_f32(t, name)
        _check_lead(lead, t, name, core)
    if mask.dtype != torch.bool:
        raise TypeError(f"mask: bool required, got {mask.dtype}")
    _check_lead(lead, mask, "mask", (N,))
    imgs, strides, hw = [], [], []
    for i, img in enumerate(levels):
        _check_f32(img, f"levels[{i}]")
        _check_lead(lead, img, f"levels[{i}]", tuple(img.shape[-2:]))
        img_p, s_img = _build.problems(img, 2)
        imgs.append(img_p)
        strides.append(s_img)
        hw += list(img.shape[-2:])
    p_ref_p, s_p_ref = _build.problems(p_ref, 2)
    patches_p, s_patches = _build.problems(patches, 3)
    jac_p, s_jac = _build.problems(jac, 4)
    if s_jac % 2 or jac_p.data_ptr() % 8:
        raise ValueError("jac: every problem's Jacobians 8-byte aligned "
                         "required (read as float2)")
    mask_p, s_mask = _build.problems(mask, 1)
    T_p, s_T = _build.problems(T_init, 2)
    n = T_p.shape[0]
    if n > _build.MAX_PROBLEMS:
        raise ValueError(f"{n} problems: at most {_build.MAX_PROBLEMS}")
    out = torch.empty((n, ALIGN_OUT), dtype=torch.float32,
                      device=T_init.device)
    lib = _build.load_library()
    _build.raise_on_error(lib.svo_align_levels(
        (ctypes.c_longlong * L)(*(x.data_ptr() for x in imgs)),
        (ctypes.c_long * L)(*strides),
        (ctypes.c_int * (2 * L))(*hw),
        (ctypes.c_float * (4 * L))(*intrinsics),
        (ctypes.c_float * (2 * L))(*bounds),
        (ctypes.c_int * (2 * L))(*schedule), L,
        p_ref_p.data_ptr(), s_p_ref, patches_p.data_ptr(), s_patches,
        jac_p.data_ptr(), s_jac, mask_p.data_ptr(), s_mask, T_p.data_ptr(),
        s_T, N, P, float(huber_k), int(illum_affine), out.data_ptr(), n,
        lib.svo_align_threads(N, P), _build.stream(T_init.device)),
        "align_levels")
    LAUNCHES["align_levels"] += int(n > 0)
    return out.reshape(lead + (ALIGN_OUT,))


@align_levels_op.register_fake
def _(levels, p_ref, patches, jac, mask, T_init, intrinsics, bounds,
      schedule, P, huber_k, illum_affine):
    return T_init.new_empty(T_init.shape[:-2] + (ALIGN_OUT,))


def _list_vmap_rule(op):
    """``_vmap_rule`` of an op whose first argument is a list of tensors
    (``svo::align_levels``, ``svo::klt_track``): every batched tensor's dim
    to the front, the others expanded (no copy), then one call of the
    op."""
    def rule(info, in_dims, *args):
        def front(a, d):
            if not isinstance(a, torch.Tensor):
                return a
            return (a.movedim(d, 0) if d is not None
                    else a.expand((info.batch_size,) + a.shape))
        levels = [front(a, d) for a, d in zip(args[0], in_dims[0])]
        rest = [front(a, d) for a, d in zip(args[1:], in_dims[1:])]
        return op(levels, *rest), 0
    return rule


torch.library.register_vmap(sample_patches_op, _vmap_rule(sample_patches_op))
torch.library.register_vmap(gn_accumulate_op, _vmap_rule(gn_accumulate_op))
torch.library.register_vmap(align_levels_op, _list_vmap_rule(align_levels_op))


def align_levels(levels, p_ref: torch.Tensor, patches: torch.Tensor,
                 jac: torch.Tensor, mask: torch.Tensor, T_init: torch.Tensor,
                 s):
    """The whole of ``ops/align.align`` as one launch
    (``svo::align_levels``; under ``vmap``, one launch for the batch):
    ``levels`` the images of the aligned levels, coarse→fine, the
    template's fields, ``s`` its ``ops/align.Spec``. Returns (T (3,4),
    cost, inlier share)."""
    out = align_levels_op(
        list(levels), p_ref, patches, jac, mask, T_init,
        [float(x) for intr in s.intrinsics for x in intr],
        [float(x) for b in s.bounds for x in b],
        [int(x) for sc in s.schedule for x in sc], s.patch, s.huber_k,
        s.illum_affine)
    return out[..., :12].unflatten(-1, (3, 4)), out[..., 12], out[..., 13]


def gn_accumulate(img: torch.Tensor, uv: torch.Tensor, tmpl: torch.Tensor,
                  jac: torch.Tensor, mask: torch.Tensor, P: int,
                  huber_k: float, a_il: torch.Tensor, b_il: torch.Tensor):
    """Fused refresh pass of ``ops/align.chain``, the alignment's plain
    version (``svo::gn_accumulate``; under ``vmap``, one launch for the
    batch). On the card the main path's alignment is one ``align_levels``
    launch, which does this work itself.

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
