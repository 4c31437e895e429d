#!/usr/bin/env python3
"""Time the four CUDA kernels of one source tree of the port at
chip_smoke.py's phase-2 shapes, for a before/after comparison on one GPU.

Run from the repository root:
    python3 compare_kernels.py [--tree DIR] [--tag NAME]

``--tree`` is the root of a checkout whose ``stereo_svo_tpu_torch`` is
timed (default: this one), e.g. an unpacked ``git archive`` of an earlier
commit in an ignored directory; its kernels build into ``DIR/build/``.
The measurement functions (``cuda_ms``, ``device_us``, ``host_us``) come
from this checkout's chip_smoke.py, so two trees are timed alike. Compare
two trees only within one command on one card, in turns: parent, change,
change, parent.

Prints one JSON line per row: tag, kernel, use, shape, ms (median CUDA
event pair around one call), device_us and cuda_launches_per_call
(torch.profiler over 200 back-to-back calls), host_us (host clock over
200 back-to-back calls, no sync). A "pyramid" row times the tree's own way
of building a pyramid's image levels into its (3,h,w) level buffers: one
``pyramid_kernel.pyramid`` call where the tree has it, else the allocations,
the copy of level 0 and one half-sample launch per level, as that tree's
``ops/pyramid.build_with_gradients`` does; a "build_with_gradients" row
times the whole layer (B2 included). Both count every CUDA function they
launch (the copy too). A "gradients" row "per pyramid" times the tree's
own way of writing every level's gx and gy of pyramids whose image
planes B1 wrote before the timing: one launch where the tree has
``_launch_b2_levels``, else one launch a level (for 1 frame and for 8);
the other "gradients" rows time one level, every level of the 752x480
(5 levels) and 1241x376 (4 levels) pyramids. A "template" row times the
samples of one template level (image, gx and gy at the same centres): one
call on the (3,H,W) level buffer where the tree's B3 takes one, three
calls where it does not. B4 rows call the wrapper as the tree's
``ops/align.py`` does (with its ``torch.stack`` of the illumination pair
where the tree's B4 takes one tensor).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--tag", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: compare_kernels.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    tag = args.tag or os.path.relpath(tree, ROOT)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, tree)
    import stereo_svo_tpu_torch as port
    if not os.path.abspath(port.__file__).startswith(tree + os.sep):
        print(f"FAIL: imported {port.__file__}, not the tree {tree}",
              file=sys.stderr)
        return 1
    from stereo_svo_tpu_torch.ops import pyramid
    from stereo_svo_tpu_torch.ops.kernels import align_kernel as ak
    from stereo_svo_tpu_torch.ops.kernels import pyramid_kernel as pk

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(cs.SEED)

    def image(h, w):
        return (torch.rand(h, w, generator=gen) * 255.0).to(dev)

    def centres(N, h, w):
        return (torch.rand(N, 2, generator=gen)
                * torch.tensor([w + 4.0, h + 4.0]) - 2.0).to(dev)

    img, kitti = image(480, 752), image(376, 1241)
    half_img, half_kitti = pk.halfsample(img), pk.halfsample(kitti)
    stacked_b3 = hasattr(ak, "MAX_IMAGES")
    split_ab = len(inspect.signature(ak.gn_accumulate).parameters) == 9

    def row(name, use, shape, fn, functions=None):
        dev_us, per_call, method = cs.device_us(
            fn, functions or cs.KERNEL_FUNCTIONS[name])
        print(json.dumps({
            "tag": tag, "kernel": name, "use": use, "shape": shape,
            "ms": cs.cuda_ms(fn), "device_us": dev_us,
            "device_method": method, "cuda_launches_per_call": per_call,
            "host_us": cs.host_us(fn)}), flush=True)

    def image_levels(x, L):
        if hasattr(pk, "pyramid"):
            return pk.pyramid(x, L)
        bufs = [torch.empty((3,) + tuple(x.shape), device=dev)]
        bufs[0][0].copy_(x)
        for _ in range(L - 1):
            h, w = bufs[-1].shape[1:]
            bufs.append(torch.empty((3, h // 2, w // 2), device=dev))
            pk.halfsample(bufs[-2][0], out=bufs[-1][0])
        return bufs

    for x, L, what in ((img, 4, "752x480"), (kitti, 4, "1241x376"),
                       (img, 5, "752x480 5-level")):
        row("halfsample", f"pyramid, {L} levels, {what}", list(x.shape),
            lambda x=x, L=L: image_levels(x, L), ("",))
        row("build_with_gradients", f"{L} levels, {what}", list(x.shape),
            lambda x=x, L=L: pyramid.build_with_gradients(x, L), ("",))
    def b2_pyramid(flat, h, w, L):
        if hasattr(pk, "_launch_b2_levels"):
            pk._launch_b2_levels(flat, h, w, L)
            return
        n, total = flat.shape                 # one launch a level
        base, size = flat.data_ptr(), flat.element_size()
        for (_, lh, lw), _, off in pk._layout(h, w, L)[1]:
            pk._launch_b2(base + off * size, total,
                          base + (off + lh * lw) * size,
                          base + (off + 2 * lh * lw) * size, total, lh, lw,
                          n, flat.device)

    if hasattr(pk, "_launch_b1"):
        frames8 = torch.stack([image(480, 752) for _ in range(8)])
        for x, L, what in ((img, 4, "752x480"), (kitti, 4, "1241x376"),
                           (img, 5, "752x480 5-level"),
                           (frames8, 4, "8 frames, 752x480")):
            flat = pk._launch_b1(x, L)
            row("gradients", f"per pyramid, {L} levels, {what}",
                list(x.shape), lambda flat=flat, x=x, L=L: b2_pyramid(
                    flat, *x.shape[-2:], L))
    for x, L, what in ((img, 5, "752x480"), (kitti, 4, "1241x376")):
        row("halfsample", f"one level, {what}", list(x.shape),
            lambda x=x: pk.halfsample(x))
        for level in range(L):
            row("gradients", f"level {level} of {what}", list(x.shape),
                lambda x=x: pk.gradients(x))
            x = pk.halfsample(x)

    uv192 = centres(192, 480, 752)
    for x, uv, P, use in ((img, uv192, 8, "KLT iterations"),
                          (img, uv192, 4, "alignment inner passes"),
                          (half_kitti, centres(3840, 188, 620), 8,
                           "epipolar probes"),
                          (img, uv192, 16, "big templates"),
                          (kitti, centres(240, 376, 1241), 8, "KITTI KLT"),
                          (img, centres(2048, 480, 752), 8, "stress KLT")):
        row("sample_patches", use, [list(x.shape), uv.shape[0], P],
            lambda x=x, uv=uv, P=P: ak.sample_patches(x, uv, P))
    gx, gy = pk.gradients(img)
    planes = torch.stack([img, gx, gy])
    for P, use in ((4, "alignment template"), (8, "KLT template")):
        if stacked_b3:
            def fn(P=P):
                return ak.sample_patches(planes, uv192, P)
        else:
            def fn(P=P):
                return [ak.sample_patches(x, uv192, P) for x in (img, gx, gy)]
        row("sample_patches", use, [[3, 480, 752], 192, P], fn)

    P = 4
    for x, N, use in ((img, 192, "alignment refresh pass"),
                      (kitti, 240, "KITTI alignment"),
                      (half_img, 2048, "stress alignment")):
        h, w = x.shape
        uv = (torch.rand(N, 2, generator=gen)
              * torch.tensor([w - 8.0, h - 8.0]) + 4.0).to(dev)
        tmpl = (torch.rand(N, P * P, generator=gen) * 255.0).to(dev)
        jac = (torch.randn(N, P * P, 6, generator=gen) * 50.0).to(dev)
        mask = (torch.rand(N, P * P, generator=gen) > 0.2).float().to(dev)
        a_il = torch.tensor(1.3, device=dev)
        b_il = torch.tensor(-7.0, device=dev)
        if split_ab:
            def fn(x=x, uv=uv, tmpl=tmpl, jac=jac, mask=mask):
                return ak.gn_accumulate(x, uv, tmpl, jac, mask, P, 8.0, a_il,
                                        b_il)
        else:
            def fn(x=x, uv=uv, tmpl=tmpl, jac=jac, mask=mask):
                return ak.gn_accumulate(x, uv, tmpl, jac, mask, P, 8.0,
                                        torch.stack([a_il, b_il]))
        row("gn_accumulate", use, [list(x.shape), N, P], fn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
