"""Pyramid kernels B1 (every level's image plane) and B2 (every level's
gradients): CUDA wrappers, plain PyTorch versions and launch counters.

Source note. Replaces the Pallas TPU kernels
``stereo_svo_tpu/ops/pallas/pyramid_kernel.py::halfsample``
(``_half_kernel``) and ``::gradients`` (``_grad_kernel``, the
``pl.pallas_call`` at line 70); CUDA source in ``csrc/pyramid.cu``. Both
are memory-bound stencils with almost no arithmetic. B1 builds a whole
pyramid's image planes in one launch (up to six levels): each block stages
a 32×64 tile of the frame in shared memory, writes it out as level 0 and
halves it level by level there, so the frame is read once (752×480, 4
levels: 1.44 MB read, 1.92 MB written). B2 writes every level's gx and gy
in one launch: bytes bound it, every level's image read once and gx, gy
written once (752×480, 4 levels: 5.75 MB, 1.717 µs at 3.35 TB/s). One
launch per level paid a full launch floor for each of levels 1–3, which
move less than 1.1 MB; now the grid walks the tiles of every level, and a
warp walks down 32 (or, as float4, 128) columns with gx from its
neighbouring lanes. The TPU's 16-row VMEM tiles have no counterpart.

The problem axis. Both kernels take any number of leading dims, flattened
into one grid dimension: B frames (or thumbnails) of one shape in one
launch, problem b bit for bit its one-problem launch. The paths reach them
through two functional custom ops, ``svo::pyramid`` (two launches for up
to six levels: B1, then B2 on every level, into one new buffer) and
``svo::gradients`` (B2 on one level into a new (…,2,H,W) tensor), whose
``torch.func.vmap`` rules move the batch dims to the front and make one
problem-axis launch (nested ``vmap`` too). On the CPU an op runs the plain
version; on CUDA its kernels, with no fallback between the two.
"""

from __future__ import annotations

import functools

import torch

from . import _build

# launches by counter (the kernels: ops.kernels.KERNELS)
LAUNCHES = {"halfsample": 0, "gradients": 0}
CHAIN = 6          # levels one B1 launch builds (csrc/pyramid.cu's tile)
MAX_LEVELS = 32    # svo_pyramid's limit


def halfsample_plain(img: torch.Tensor) -> torch.Tensor:
    """2×2 mean of (…,H,W); an odd trailing row/column is dropped."""
    H, W = img.shape[-2:]
    x = img[..., : (H // 2) * 2, : (W // 2) * 2]
    return (((x[..., 0::2, 0::2] + x[..., 0::2, 1::2]) + x[..., 1::2, 0::2])
            + x[..., 1::2, 1::2]) * 0.25


def pyramid_plain(img: torch.Tensor, num_levels: int) -> tuple:
    """The ``num_levels`` image levels of (…,H,W): ``img``, then each the
    :func:`halfsample_plain` of the one above."""
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


def level_views(flat: torch.Tensor, H: int, W: int, num_levels: int
                ) -> tuple:
    """Every level's (…,3,h_l,w_l) [image, gx, gy] buffer as a view of
    ``flat`` (…, elements of an H×W pyramid's buffers)."""
    _, views, _ = _layout(H, W, num_levels)
    return tuple(flat.narrow(-1, off, size[0] * size[1] * size[2])
                 .unflatten(-1, size) for size, _, off in views)


def _check_f32(t: torch.Tensor, name: str) -> None:
    if t.dtype != _build.F32:
        raise TypeError(f"{name}: float32 required, got {t.dtype}")


def _launch_b1(img: torch.Tensor, num_levels: int) -> torch.Tensor:
    """B1 on the CUDA frames ``img`` (…,H,W): a new (n, total) buffer of n
    pyramids, image planes written (gx, gy planes left)."""
    _check_f32(img, "img")
    H, W = img.shape[-2:]
    total, _, launches = _layout(H, W, num_levels)
    src, stride = _build.problems(img, 2)
    n = src.shape[0]
    if n > _build.MAX_PROBLEMS:
        raise ValueError(f"{n} frames: at most {_build.MAX_PROBLEMS} a launch")
    flat = torch.empty((n, total), dtype=img.dtype, device=img.device)
    _build.raise_on_error(_build.load_library().svo_pyramid(
        src.data_ptr(), stride, flat.data_ptr(), H, W, num_levels, n,
        _build.stream(img.device)), "pyramid")
    LAUNCHES["halfsample"] += launches if n else 0
    return flat


def _launch_b2_levels(flat: torch.Tensor, H: int, W: int,
                      num_levels: int) -> None:
    """B2 on every level of the n pyramids in ``flat`` (n, total), whose
    image planes B1 wrote: one launch writes every gx and gy plane."""
    n = flat.shape[0]
    _build.check(flat, "pyramids", (n, _layout(H, W, num_levels)[0]))
    _build.raise_on_error(_build.load_library().svo_pyramid_gradients(
        flat.data_ptr(), H, W, num_levels, n, _build.stream(flat.device)),
        "gradients")
    LAUNCHES["gradients"] += int(H * W > 0 and n > 0)


def _pyramid_flat_plain(img: torch.Tensor, num_levels: int) -> torch.Tensor:
    parts = []
    for level in pyramid_plain(img, num_levels):
        gx, gy = gradients_plain(level)
        parts.append(torch.stack([level, gx, gy], -3).flatten(-3))
    return torch.cat(parts, -1)


@torch.library.custom_op("svo::pyramid", mutates_args=())
def pyramid_op(img: torch.Tensor, num_levels: int) -> torch.Tensor:
    """Every level's [image, gx, gy] of the (…,H,W) frames, one after
    another in a new (…, total) tensor (:func:`level_views` cuts it): on
    CUDA one B1 launch for all frames and levels (up to six), then one B2
    launch for all frames and levels."""
    if _build.plain(img):
        return _pyramid_flat_plain(img, num_levels)
    H, W = img.shape[-2:]
    flat = _launch_b1(img, num_levels)
    _launch_b2_levels(flat, H, W, num_levels)
    return flat.reshape(img.shape[:-2] + (flat.shape[1],))


@pyramid_op.register_fake
def _(img, num_levels):
    total, _, _ = _layout(img.shape[-2], img.shape[-1], num_levels)
    return img.new_empty(img.shape[:-2] + (total,))


@torch.library.custom_op("svo::gradients", mutates_args=())
def gradients_op(img: torch.Tensor) -> torch.Tensor:
    """(…,2,H,W) [gx, gy] of the (…,H,W) images: on CUDA one B2 launch for
    all of them (a one-level work list)."""
    if _build.plain(img):
        return torch.stack(gradients_plain(img), -3)
    _check_f32(img, "img")
    H, W = img.shape[-2:]
    src, stride = _build.problems(img, 2)
    n = src.shape[0]
    if n > _build.MAX_PROBLEMS:
        raise ValueError(f"{n} images: at most {_build.MAX_PROBLEMS} a launch")
    out = torch.empty((n, 2, H, W), dtype=img.dtype, device=img.device)
    _build.raise_on_error(_build.load_library().svo_gradients(
        src.data_ptr(), stride, out.data_ptr(),
        out.data_ptr() + H * W * out.element_size(), 2 * H * W, H, W, n,
        _build.stream(img.device)), "gradients")
    LAUNCHES["gradients"] += int(H * W > 0 and n > 0)
    return out.reshape(img.shape[:-2] + (2, H, W))


@gradients_op.register_fake
def _(img):
    return img.new_empty(img.shape[:-2] + (2,) + img.shape[-2:])


def _vmap_rule(op):
    """The ops' ``vmap`` rule: batch dims to the front (an unbatched tensor
    expanded, no copy), then one call of the op, whose kernels take every
    leading dim as the problem axis."""
    def rule(info, in_dims, *args):
        args = [a if not isinstance(a, torch.Tensor)
                else a.movedim(d, 0) if d is not None
                else a.expand((info.batch_size,) + a.shape)
                for a, d in zip(args, in_dims)]
        return op(*args), 0
    return rule


torch.library.register_vmap(pyramid_op, _vmap_rule(pyramid_op))
torch.library.register_vmap(gradients_op, _vmap_rule(gradients_op))


def pyramid_with_gradients(img: torch.Tensor, num_levels: int) -> tuple:
    """Every level's (…,3,h_l,w_l) [image, gx, gy] buffer of the (…,H,W)
    frames, views one after another of a single new tensor (``svo::pyramid``
    under ``vmap`` too)."""
    _build.plain(img)       # the device rule, before the op
    H, W = img.shape[-2:]
    return level_views(pyramid_op(img, num_levels), H, W, num_levels)


def pyramid(img: torch.Tensor, num_levels: int) -> tuple:
    """B1 alone: every level's (…,3,h_l,w_l) [image, gx, gy] buffer of the
    (…,H,W) frames, views one after another of a single tensor, with the
    image planes filled (level 0 a copy of ``img``, level l+1 the 2×2 mean
    of level l) and the gx and gy planes left unwritten. Not for ``vmap``:
    the paths call :func:`pyramid_with_gradients`."""
    plain = _build.plain(img)
    H, W = img.shape[-2:]
    total, _, _ = _layout(H, W, num_levels)
    if plain:
        flat = torch.empty(img.shape[:-2] + (total,), dtype=img.dtype,
                           device=img.device)
        bufs = level_views(flat, H, W, num_levels)
        for b, level in zip(bufs, pyramid_plain(img, num_levels)):
            b[..., 0, :, :].copy_(level)
        return bufs
    flat = _launch_b1(img, num_levels).reshape(img.shape[:-2] + (total,))
    return level_views(flat, H, W, num_levels)


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


def gradients(img: torch.Tensor):
    """Central differences (gx, gy) of the (…,H,W) images
    (``svo::gradients``, under ``vmap`` too)."""
    _build.plain(img)       # the device rule, before the op
    g = gradients_op(img)
    return g[..., 0, :, :], g[..., 1, :, :]
