"""Pyramid kernels B1 (every level's image plane) and B2 (gradients): CUDA
wrappers, plain PyTorch versions and launch counters.

Source note. Replaces the Pallas TPU kernels
``stereo_svo_tpu/ops/pallas/pyramid_kernel.py::halfsample``
(``_half_kernel``) and ``::gradients`` (``_grad_kernel``); CUDA source in
``csrc/pyramid.cu``. Both are memory-bound stencils with almost no
arithmetic. B1 builds a whole pyramid's image planes in one launch (up to
six levels): each block stages a 32×64 tile of the frame in shared memory,
writes it out as level 0 and halves it level by level there, so the frame
is read once (752×480, 4 levels: 1.44 MB read, 1.92 MB written). B2 is one
thread per pixel, warps along image rows (level 0 at 752×480: 1.4 MB read,
2.9 MB written). The TPU's 16-row VMEM tiles have no counterpart.
"""

from __future__ import annotations

import functools

import torch

from . import _build

LAUNCHES = {"halfsample": 0, "gradients": 0}
# the CUDA function each counter's launches run (csrc/pyramid.cu)
KERNELS = {"halfsample": "pyramid_levels_kernel",
           "gradients": "gradients_kernel"}
CHAIN = 6          # levels one B1 launch builds (csrc/pyramid.cu's tile)
MAX_LEVELS = 32    # svo_pyramid's limit


def halfsample_plain(img: torch.Tensor) -> torch.Tensor:
    """2×2 mean; an odd trailing row/column is dropped."""
    H, W = img.shape
    x = img[: (H // 2) * 2, : (W // 2) * 2]
    return (((x[0::2, 0::2] + x[0::2, 1::2]) + x[1::2, 0::2])
            + x[1::2, 1::2]) * 0.25


def pyramid_plain(img: torch.Tensor, num_levels: int) -> tuple:
    """The ``num_levels`` image levels: ``img``, then each the
    :func:`halfsample_plain` of the one above."""
    levels = [img]
    for _ in range(num_levels - 1):
        levels.append(halfsample_plain(levels[-1]))
    return tuple(levels)


def gradients_plain(img: torch.Tensor):
    """Central differences (gx, gy); border columns/rows are 0."""
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return gx, gy


@functools.lru_cache(maxsize=16)
def _layout(H: int, W: int, num_levels: int):
    """(elements in all, each level buffer's (size, stride, offset), B1
    launches) of an H×W pyramid, as svo_pyramid lays it out and launches:
    each level halves the one above, rounding down."""
    if not 1 <= num_levels <= MAX_LEVELS:
        raise ValueError(f"num_levels must be in 1..{MAX_LEVELS}, got "
                         f"{num_levels}")
    views, offset, h, w = [], 0, H, W
    for _ in range(num_levels):
        views.append(((3, h, w), (h * w, w, 1), offset))
        offset += 3 * h * w
        h, w = h // 2, w // 2
    # one launch from level 0, then one more from every CHAIN-1'th level
    # before the last, while that level is not empty
    launches = sum(1 for s in range(0, max(num_levels - 1, 1), CHAIN - 1)
                   if views[s][1][0] > 0)
    return offset, tuple(views), launches


def pyramid(img: torch.Tensor, num_levels: int) -> tuple:
    """Every level's (3, h_l, w_l) [image, gx, gy] buffer, views one after
    another of a single tensor, with the image planes filled: level 0 a
    copy of ``img`` (H,W), level l+1 the 2×2 mean of level l. The gx and gy
    planes are left for :func:`gradients`."""
    plain = _build.plain(img)
    H, W = img.shape
    total, views, launches = _layout(H, W, num_levels)
    flat = torch.empty(total, dtype=img.dtype, device=img.device)
    bufs = tuple(flat.as_strided(*view) for view in views)
    if plain:
        for b, level in zip(bufs, pyramid_plain(img, num_levels)):
            b[0].copy_(level)
        return bufs
    _build.check(img, "img", (H, W))
    _build.raise_on_error(_build.load_library().svo_pyramid(
        img.data_ptr(), flat.data_ptr(), H, W, num_levels,
        _build.stream(img.device)), "pyramid")
    LAUNCHES["halfsample"] += launches
    return bufs


def halfsample(img: torch.Tensor, out: torch.Tensor | None = None
               ) -> torch.Tensor:
    """2×2 mean of ``img`` (H,W) → (H//2, W//2), written into ``out`` when
    given (a contiguous float32 tensor of that shape): B1 with two levels,
    the input not copied."""
    if _build.plain(img, out):
        half = halfsample_plain(img)
        return half if out is None else out.copy_(half)
    H, W = img.shape[-2:]
    _build.check(img, "img", (H, W))
    if out is None:
        out = torch.empty((H // 2, W // 2), dtype=img.dtype, device=img.device)
    else:
        _build.check(out, "out", (H // 2, W // 2))
    _build.raise_on_error(_build.load_library().svo_halfsample(
        img.data_ptr(), out.data_ptr(), H, W, _build.stream(img.device)),
        "halfsample")
    LAUNCHES["halfsample"] += int(H * W > 0)
    return out


def gradients(img: torch.Tensor, out: torch.Tensor | None = None):
    """Central differences (gx, gy) of ``img`` (H,W), written into the two
    planes of ``out`` (2,H,W) when given."""
    if _build.plain(img, out):
        grads = gradients_plain(img)
        if out is None:
            return grads
        out[0].copy_(grads[0])
        out[1].copy_(grads[1])
        return out[0], out[1]
    H, W = img.shape[-2:]
    _build.check(img, "img", (H, W))
    if out is None:
        out = torch.empty((2, H, W), dtype=img.dtype, device=img.device)
    else:
        _build.check(out, "out", (2, H, W))
    gx, gy = out[0], out[1]
    _build.raise_on_error(_build.load_library().svo_gradients(
        img.data_ptr(), gx.data_ptr(), gy.data_ptr(), H, W,
        _build.stream(img.device)), "gradients")
    LAUNCHES["gradients"] += 1
    return gx, gy
