"""Pyramid kernels B1 (half-sample) and B2 (gradients): CUDA wrappers,
plain PyTorch versions and launch counters.

Source note. Replaces the Pallas TPU kernels
``stereo_svo_tpu/ops/pallas/pyramid_kernel.py::halfsample``
(``_half_kernel``) and ``::gradients`` (``_grad_kernel``); CUDA source in
``csrc/pyramid.cu``. Both are memory-bound stencils with almost no
arithmetic (level 0 at 752×480: B1 reads 1.4 MB and writes 0.36 MB, B2
reads 1.4 MB and writes 2.9 MB), so the design is one thread per output
pixel with warps along image rows for coalesced loads and stores; the
TPU's 16-row VMEM tiles have no counterpart. Launch overhead, not
bandwidth, dominates at the coarse levels.
"""

from __future__ import annotations

import torch

from . import _build

LAUNCHES = {"halfsample": 0, "gradients": 0}


def halfsample_plain(img: torch.Tensor) -> torch.Tensor:
    """2×2 mean; an odd trailing row/column is dropped."""
    H, W = img.shape
    x = img[: (H // 2) * 2, : (W // 2) * 2]
    return (((x[0::2, 0::2] + x[0::2, 1::2]) + x[1::2, 0::2])
            + x[1::2, 1::2]) * 0.25


def gradients_plain(img: torch.Tensor):
    """Central differences (gx, gy); border columns/rows are 0."""
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return gx, gy


def halfsample(img: torch.Tensor, out: torch.Tensor | None = None
               ) -> torch.Tensor:
    """2×2 mean of ``img`` (H,W) → (H//2, W//2), written into ``out`` when
    given (a contiguous float32 tensor of that shape)."""
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
    LAUNCHES["halfsample"] += 1
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
