"""KLT in one launch, ``klt_track_kernel`` (``svo::klt_track``): the CUDA
wrapper, its plain version and its launch counter.

Source note. Replaces no Pallas kernel on its own: it fuses the ``jnp``
chain of ``stereo_svo_tpu/ops/klt.py:track`` (every level and iteration of
the pyramidal inverse-compositional Lucas-Kanade tracking, with the affine
illumination fit, the edgelets' 1-DoF step and, with ``klt_affine_warp``,
``warp_template_level``) with its use of B3
(``stereo_svo_tpu/ops/pallas/align_kernel.py:110``, one sample of the N
patches an iteration). Why: on the graphed main path that chain was ~950
kernel nodes a tracked frame (1.50 ms of a 3.28-ms frame on an H100); it
is one. What bounds it: the latency of its 18 dependent iterations
(``klt_levels`` 3 × ``klt_max_iters`` 6 at every shipped configuration),
each a gather of every feature's P×P patch from the level image and three
sums over it; not bytes (the templates once and four taps a pixel an
iteration, ~0.7 MB at N = 192, P = 8: ~0.2 µs at 3.35 TB/s) nor flops
(~0.1 MFLOP an iteration: ~2 ns at 67 TFLOP/s). Design: one group of
threads a feature (B3's group size: 16 threads at P = 4, a warp at P = 8,
four warps at P = 16), no cluster and no barrier between features; the
group keeps its feature's position, convergence flag and residual in
registers across every level and iteration, and its pixels' template in
registers for a level; each sum over the patch a butterfly of shuffles in
a fixed order, no float atomics, so a call repeats bit for bit; a feature
inactive at a level leaves that level's loop, where the chain freezes it.
Float32, ``-fmad=false``: the chain's arithmetic up to the order of its
sums. ``csrc/klt.cu`` gives the design in full.

The problem axis: B independent trackings in one launch (the batched
step's ``vmap`` over sequences), one grid row each; problem b equals its
one-problem launch bit for bit. On the CPU the op runs the plain version,
``ops/klt.track_plain``, problem by problem; on CUDA the kernel, with no
fallback between the two.
"""

from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace
from typing import List, Optional, Tuple

import torch

from . import _build
from .align_kernel import _check_lead, _list_vmap_rule

# launches by counter (the kernels: ops.kernels.KERNELS)
LAUNCHES = {"klt_track": 0}
MAX_KLT_LEVELS = 8   # levels of one launch (csrc/klt.cu kMaxKltLevels)
MAX_PATCH = 32       # patch side (kKltMaxPix pixels a thread of the group)

# (device index, stream, problems) -> the warped tallies (n_warped)
_TALLY = {}


def klt_track_plain(levels, patches, jac, hinv, mask, big, big_ok, uv_init,
                    edge_dir, is_edgelet, A_inv, P: int, iters: int,
                    conv_eps: float, illum_affine: bool):
    """Plain version of ``svo::klt_track``: ``klt.track_plain`` on each
    problem in turn; problem b exactly its call alone."""
    from .. import klt
    cfg = SimpleNamespace(klt_patch=P, klt_levels=len(levels),
                          klt_max_iters=iters, klt_conv_eps=conv_eps,
                          illum_affine=illum_affine)
    lead, N = uv_init.shape[:-2], uv_init.shape[-2]
    n = math.prod(lead)

    def one(t):
        return None if t is None else t.reshape((n,) + t.shape[len(lead):])

    lv = [one(x) for x in levels]
    args = [one(t) for t in (patches, jac, hinv, mask, big, big_ok, uv_init,
                             edge_dir, is_edgelet, A_inv)]
    outs = []
    for b in range(n):
        pb, jb, hb, mb, bb, okb, uvb, edb, isb, Ab = (
            None if a is None else a[b] for a in args)
        outs.append(klt.track_plain(
            [x[b] for x in lv], klt.KltTemplate(pb, jb, hb, mb, bb, okb), cfg,
            uvb, edge_dir=edb, is_edgelet=isb, A_inv=Ab))
    if outs:
        uv, ok, res, nw = (torch.stack(x) for x in zip(*outs))
    else:
        uv = uv_init.new_empty((0, N, 2))
        ok = mask.new_empty((0, N))
        res = uv_init.new_empty((0, N))
        nw = uv_init.new_empty((0,), dtype=torch.int32)
    return (uv.reshape(lead + (N, 2)), ok.reshape(lead + (N,)),
            res.reshape(lead + (N,)), nw.reshape(lead))


def _tally(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The n_warped tallies of n problems on this device and stream, zeroed
    at the first call; the kernel leaves them zero for the next call on the
    stream. (One allocation for each number of problems, never resized: a
    CUDA graph keeps the pointer it captured.)"""
    key = (device.index, stream, n)
    if key not in _TALLY:
        _TALLY[key] = torch.zeros((n, 2), dtype=torch.int32, device=device)
    return _TALLY[key]


@torch.library.custom_op("svo::klt_track", mutates_args=())
def klt_track_op(levels: List[torch.Tensor], patches: torch.Tensor,
                 jac: torch.Tensor, hinv: torch.Tensor, mask: torch.Tensor,
                 big: torch.Tensor, big_ok: torch.Tensor,
                 uv_init: torch.Tensor, edge_dir: Optional[torch.Tensor],
                 is_edgelet: Optional[torch.Tensor],
                 A_inv: Optional[torch.Tensor], P: int, iters: int,
                 conv_eps: float, illum_affine: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """B independent KLT trackings: per level lv (level 0 the finest) the
    (*B,H_l,W_l) image ``levels[lv]``; the template's (*B,L,N,P²) patches,
    (*B,L,N,P²,2) gradients, (*B,L,N,2,2) inverse Hessians, (*B,N) bool
    mask, (*B,L,N,B²) oversized patches and (*B,L,N) bool ``big_ok``;
    (*B,N,2) level-0 ``uv_init``; optional (*B,N,2) ``edge_dir``, (*B,N)
    bool ``is_edgelet`` and (*B,N,2,2) ``A_inv`` (None: none; ``A_inv``
    warps only where B > 1) → ((*B,N,2) uv, (*B,N) bool converged and
    plausible, (*B,N) mean |residual|, (*B,) int32 warped (feature, level)
    pairs of the mask). On CUDA one ``klt_track_kernel`` launch for all of
    them."""
    if _build.plain(*levels, patches, jac, hinv, mask, big, big_ok, uv_init,
                    edge_dir, is_edgelet, A_inv):
        return klt_track_plain(levels, patches, jac, hinv, mask, big, big_ok,
                               uv_init, edge_dir, is_edgelet, A_inv, P,
                               iters, conv_eps, illum_affine)
    L = len(levels)
    lead, N = uv_init.shape[:-2], uv_init.shape[-2]
    P2, B2 = P * P, big.shape[-1]
    if not 0 <= L <= MAX_KLT_LEVELS or not 1 <= P <= MAX_PATCH:
        raise ValueError(f"klt_track: {L} levels (at most {MAX_KLT_LEVELS}) "
                         f"and patch {P} (1 to {MAX_PATCH})")
    if A_inv is not None and B2 <= 1:
        A_inv = None   # no oversized patches: track's fronto-parallel rule
    side = int(round(B2 ** 0.5))
    f32, b8 = _build.F32, torch.bool
    ptrs = []   # each array and its problem stride, in the C order
    for t, name, dtype, core in (
            (patches, "patches", f32, (L, N, P2)),
            (jac, "jac", f32, (L, N, P2, 2)),
            (hinv, "hinv", f32, (L, N, 2, 2)), (mask, "mask", b8, (N,)),
            (big, "big", f32, (L, N, B2)), (big_ok, "big_ok", b8, (L, N))):
        if t.dtype != dtype:
            raise TypeError(f"{name}: {dtype} required, got {t.dtype}")
        _check_lead(lead, t, name, core)
        if A_inv is None and name in ("big", "big_ok"):
            ptrs += [None, 0]   # read only with the warp
            continue
        p, s = _build.problems(t, len(core))
        ptrs += [p.data_ptr(), s]
    ptrs.append(side)
    for t, name, dtype, core in (
            (uv_init, "uv_init", f32, (N, 2)),
            (edge_dir, "edge_dir", f32, (N, 2)),
            (is_edgelet, "is_edgelet", b8, (N,)),
            (A_inv, "A_inv", f32, (N, 2, 2))):
        if t is None:
            ptrs += [None, 0]
            continue
        if t.dtype != dtype:
            raise TypeError(f"{name}: {dtype} required, got {t.dtype}")
        _check_lead(lead, t, name, core)
        p, s = _build.problems(t, len(core))
        ptrs += [p.data_ptr(), s]
    imgs, strides, hw = [], [], []
    for i, img in enumerate(levels):
        if img.dtype != f32:
            raise TypeError(f"levels[{i}]: float32 required, got {img.dtype}")
        _check_lead(lead, img, f"levels[{i}]", tuple(img.shape[-2:]))
        img_p, s_img = _build.problems(img, 2)
        imgs.append(img_p)
        strides.append(s_img)
        hw += list(img.shape[-2:])
    n = math.prod(lead)
    if n > _build.MAX_PROBLEMS:
        raise ValueError(f"{n} problems: at most {_build.MAX_PROBLEMS}")
    dev = uv_init.device
    uv = torch.empty((n, N, 2), dtype=f32, device=dev)
    ok = torch.empty((n, N), dtype=b8, device=dev)
    res = torch.empty((n, N), dtype=f32, device=dev)
    n_warped = torch.empty((n,), dtype=torch.int32, device=dev)
    stream = _build.stream(dev)
    tally = _tally(dev, stream, n) if A_inv is not None and n else None
    _build.raise_on_error(_build.load_library().svo_klt_track(
        (ctypes.c_longlong * max(L, 1))(*(x.data_ptr() for x in imgs)),
        (ctypes.c_long * max(L, 1))(*strides),
        (ctypes.c_int * max(2 * L, 1))(*hw), L, *ptrs, N, P, iters,
        conv_eps ** 2, (4.0 * P) ** 2,
        int(illum_affine), uv.data_ptr(), ok.data_ptr(), res.data_ptr(),
        n_warped.data_ptr(), None if tally is None else tally.data_ptr(), n,
        stream), "klt_track")
    LAUNCHES["klt_track"] += int(n > 0)
    return (uv.reshape(lead + (N, 2)), ok.reshape(lead + (N,)),
            res.reshape(lead + (N,)), n_warped.reshape(lead))


@klt_track_op.register_fake
def _(levels, patches, jac, hinv, mask, big, big_ok, uv_init, edge_dir,
      is_edgelet, A_inv, P, iters, conv_eps, illum_affine):
    lead, N = uv_init.shape[:-2], uv_init.shape[-2]
    return (uv_init.new_empty(lead + (N, 2)), mask.new_empty(lead + (N,)),
            uv_init.new_empty(lead + (N,)),
            uv_init.new_empty(lead, dtype=torch.int32))


torch.library.register_vmap(klt_track_op, _list_vmap_rule(klt_track_op))


def klt_track(levels, tmpl, cfg, uv_init: torch.Tensor,
              edge_dir: torch.Tensor | None = None,
              is_edgelet: torch.Tensor | None = None,
              A_inv: torch.Tensor | None = None):
    """The whole of ``ops/klt.track`` as one launch (``svo::klt_track``;
    under ``vmap``, one launch for the batch): ``levels`` the images of the
    tracked levels (level 0 first), ``tmpl`` the ``KltTemplate``, with
    ``track``'s other arguments and its return: (uv, converged and
    plausible, mean |residual|, warped pairs)."""
    return klt_track_op(
        list(levels), tmpl.patches, tmpl.jac, tmpl.hinv, tmpl.mask, tmpl.big,
        tmpl.big_ok, uv_init, edge_dir, is_edgelet, A_inv, cfg.klt_patch,
        cfg.klt_max_iters, float(cfg.klt_conv_eps), bool(cfg.illum_affine))
