#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stereo_svo_tpu_torch) once on one GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, one result line each, in order:
  0. device: CUDA required; card name, nvidia-smi name and power limit,
     torch/CUDA versions, the TF32 flags;
  1. build: the CUDA kernels from csrc/, timed;
  2. kernels: each of B1-B4 against its plain PyTorch version on the card
     at every shape a shipped path gives it: B1 per pyramid (one launch
     writes every level's image plane) and B1/B2 one level at a time,
     exactly on every level of the 752x480 (4 and 5 levels) and 1241x376
     pyramids, level 0 equal to the frame; B3 bit for bit
     at N=192 (P=8 KLT, P=4 alignment, and the K=3 template launches that
     sample a level's image, gx and gy together), at the epipolar-search
     shape (3,840 centres, P=8, 620x188), the affine-KLT big templates
     (N=192, P=16) and the KLT widths N=240 (KITTI) and N=2048 (stress);
     B4 at N=192, 240 (KITTI) and 2048 (stress level 1), P=4, within 1e-4
     relative with exact counts, bit-reproducible, one CUDA launch per
     call, and unchanged after calls at another width. Each row gives:
     ms and plain_ms (median CUDA-event pair around one call, 60 runs);
     device_us (torch.profiler device time of the kernel's own CUDA
     functions per call over 200 back-to-back calls, or an event pair
     around them where the profiler shows none: device_method);
     host_us (host clock over 200 back-to-back calls, no sync); bound_us
     (the larger of bytes / 3.35 TB/s and float32 operations / 67 TFLOP/s
     from the row's shapes, with bound_by); library_call, library_ms,
     library_device_us, library_host_us and library_max_abs_err (one
     PyTorch call computing the same function, timed alone as the kernel
     is; for B1 the copy_ of the frame and L-1 chained avg_pool2d calls,
     timed as one function; none for B4, library_reason says why); and,
     after the paths ran, launches_per_frame of the kernel on the path that
     gives it the shape (B1: 1.0 on every path, or the run fails);
  3. main path: SvoConfig() as shipped (window BA on) over the 100-frame
     synthetic arc sequence (752×480, dt 0.08, seed 0) rendered on the
     card, through StereoSvo(cfg, device="cuda").new_image; ATE and
     tracking gates, BA calls and acceptances, per-frame time;
  4. kitti_config() as shipped (epipolar search on) over 100 frames of the
     road scene on the kitti trajectory at 1241×376, dt 0.08, seed 0,
     rendered with 2×2 anti-aliasing; gates ATE ≤ max(0.25 m, 1.5 % of the
     travel), tracking, and epipolar recoveries > 0;
  5. stress_config() as shipped (2048 slots, 5 levels) over the phase-3
     sequence; gates ATE ≤ 0.02 m and tracking;
  6. SvoConfig(klt_affine_warp=True) over the first 50 frames of that
     sequence; gates ATE, tracking, and (feature, level) pairs tracked on
     warped templates > 0 (the step's n_warped metric).
Each of phases 3-6 zeroes the launch counters just before its run, reads
them just after, and fails unless every kernel launched; it counts host
syncs on every frame of the run (CUDA sync debug mode) and fails unless
the bootstrap frame has none and every other frame, keyframe frames with
window BA and frames with epipolar recoveries included, has exactly one.
Then phase2_rows (every kernel row with its launches per frame), the
kernels JSON line (each kernel's main-path row, launches from phase 3),
the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure exits non-zero with no ok line.
Extra detail (build log, per-frame times) goes to build/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FRAMES, DT, SEED = 100, 0.08, 0
N_AFFINE_FRAMES = 50
ATE_GATE_M, TRACK_GATE = 0.02, 0.99        # bench.py:54-55
KITTI_ATE_FLOOR_M, KITTI_ATE_FRAC = 0.25, 0.015   # bench.py:529-536
N_TIMED = 60                               # event-pair timing repetitions
N_BACK = 200                               # back-to-back calls (device_us,
                                           # host_us)
MEM_BYTES_PER_S = 3.35e12                  # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12                    # H100 SXM, float32, no tensor
                                           # cores
TPU_KERNELS = {                            # pl.pallas_call sites replaced
    "halfsample": "stereo_svo_tpu/ops/pallas/pyramid_kernel.py:37",
    "gradients": "stereo_svo_tpu/ops/pallas/pyramid_kernel.py:70",
    "sample_patches": "stereo_svo_tpu/ops/pallas/align_kernel.py:110",
    "gn_accumulate": "stereo_svo_tpu/ops/pallas/align_kernel.py:217",
}
SOURCES = {"halfsample": "stereo_svo_tpu_torch/csrc/pyramid.cu",
           "gradients": "stereo_svo_tpu_torch/csrc/pyramid.cu",
           "sample_patches": "stereo_svo_tpu_torch/csrc/align.cu",
           "gn_accumulate": "stereo_svo_tpu_torch/csrc/align.cu"}
# the CUDA functions each wrapper launches (as torch.profiler names them);
# gn_partial_kernel/gn_final_kernel are the two-launch B4 of earlier trees,
# which compare_kernels.py times
# halfsample_kernel is the one-launch-per-level B1 of earlier trees
KERNEL_FUNCTIONS = {"halfsample": ("pyramid_levels_kernel",
                                   "halfsample_kernel"),
                    "gradients": ("gradients_kernel",),
                    "sample_patches": ("sample_patch_kernel",),
                    "gn_accumulate": ("gn_accumulate_kernel",
                                      "gn_partial_kernel", "gn_final_kernel")}
LIBRARY_CALLS = {
    "halfsample": "copy_ of the frame, then L-1 chained "
                  "torch.nn.functional.avg_pool2d(x, 2) calls",
    "gradients": "torch.nn.functional.conv2d, both stencils as two output "
                 "channels (compared on the interior)",
    "sample_patches": "torch.nn.functional.grid_sample(bilinear, border, "
                      "align_corners=True) on a grid built outside the "
                      "timed region (compared at interior centres)",
    "gn_accumulate": None,
}
NO_LIBRARY_CALL = ("no single PyTorch call computes the sample, the Huber "
                   "weight and the normal equations together")


ROW_SUMMARY = ("name", "shape", "levels", "use", "path",
               "launches_per_frame", "max_abs_err", "ms", "plain_ms",
               "device_us", "host_us", "bound_us", "bound_by", "library_ms",
               "library_device_us", "library_host_us", "library_max_abs_err")


class SmokeFailure(RuntimeError):
    pass


def emit(tag: str, payload: dict) -> None:
    print(f"{tag} {json.dumps(payload, sort_keys=True)}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, n: int = N_TIMED, warmup: int = 5) -> float:
    """Median milliseconds of ``fn()`` over ``n`` runs, one CUDA-event pair
    around each run at an idle queue: the host's cost to issue the call
    plus the device's time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def device_us(fn, functions, n: int = N_BACK):
    """Device µs per call of ``fn()`` spent in the CUDA functions named in
    ``functions``: torch.profiler's key_averages over ``n`` back-to-back
    calls, the mean time of each function's launches times its launches
    per call (rounded: the profiler may drop a few records, never add
    one), summed over the functions a call launches; with the launches
    recorded per call. Where two profiles record no device time, an event
    pair around ``n`` back-to-back calls
    after a synchronised warm-up (launches per call then unknown).
    Returns (µs, launches per call, method)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):               # the first profile may record nothing
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        per_function = [
            (getattr(e, "self_device_time_total", 0.0), e.count)
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and any(f in e.key for f in functions)]
        if per_function and all(t > 0.0 for t, _ in per_function):
            return (sum(t / c * max(1, round(c / n))
                        for t, c in per_function),
                    sum(c for _, c in per_function) / n, "profiler")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / n, None, "events"


def host_us(fn, n: int = N_BACK) -> float:
    """Host µs per call of ``fn()`` over ``n`` back-to-back calls with no
    synchronisation: what the main path pays per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def bound_us(nbytes: float, flops: float):
    """The least time the card could take: bytes over the memory rate or
    float32 operations over the peak rate, whichever is larger."""
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e6, \
        "bytes" if t_bytes >= t_ops else "operations"


def footprint_pixels(h, w, uv, P) -> int:
    """Distinct pixels the bilinear taps of all patches read (the per-tap
    clamp of interp.bilinear): the input bytes B3/B4 need from this run's
    centres."""
    import torch
    from stereo_svo_tpu_torch.ops import interp
    pts = (uv.reshape(-1, 2)[:, None, :]
           + interp.patch_coords(P, uv.dtype, uv.device)).reshape(-1, 2)
    u = torch.clamp(pts[:, 0], 0.0, w - 1.000001)
    v = torch.clamp(pts[:, 1], 0.0, h - 1.000001)
    iu0 = torch.floor(u).long().clamp(0, w - 1)
    iv0 = torch.floor(v).long().clamp(0, h - 1)
    iu1 = torch.clamp(iu0 + 1, max=w - 1)
    iv1 = torch.clamp(iv0 + 1, max=h - 1)
    idx = torch.cat([iv0 * w + iu0, iv0 * w + iu1, iv1 * w + iu0,
                     iv1 * w + iu1])
    return int(torch.unique(idx).numel())


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def _max_err(a, b):
    import torch
    if isinstance(a, (tuple, list)):
        errs = [_max_err(x, y) for x, y in zip(a, b)]
        return max(e[0] for e in errs), max(e[1] for e in errs)
    d = float(torch.max(torch.abs(a.float() - b.float())))
    scale = float(torch.max(torch.abs(b.float())))
    return d, d / max(scale, 1e-30)


def _grid(uv, P, h, w, K):
    """grid_sample's normalised (K, M, P², 2) grid of the patches' sample
    points (align_corners=True: -1 and 1 are the border pixel centres)."""
    import torch
    from stereo_svo_tpu_torch.ops import interp
    pts = (uv.reshape(-1, 2)[:, None, :]
           + interp.patch_coords(P, uv.dtype, uv.device))
    scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], device=uv.device)
    return (pts * scale - 1.0)[None].expand(K, -1, -1, -1).contiguous()


def check_kernels(device, frame, kitti_frame):
    """Phase 2: each kernel against its plain version on the card at every
    shape a shipped path gives it, with its bound, device, host, event and
    library-call times. Returns the rows; the first row of each kernel is
    its main-path row."""
    import torch
    import torch.nn.functional as F
    from stereo_svo_tpu_torch.ops import pyramid
    from stereo_svo_tpu_torch.ops.kernels import _build
    from stereo_svo_tpu_torch.ops.kernels import align_kernel as ak
    from stereo_svo_tpu_torch.ops.kernels import pyramid_kernel as pk

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    img = frame.contiguous()
    H, W = img.shape
    rows = []

    def record(name, kernel, plain, tol_abs, tol_rel, shape, path,
               nbytes, flops, library=None, extra=None, outputs=None):
        """``library``: (the library call, timed alone; a function of its
        output giving the (library, kernel) values compared) or None.
        ``outputs``: what of the kernel's result is compared with the plain
        version (default: all of it)."""
        out, ref = kernel(), plain()
        if outputs is not None:
            out = outputs(out)
        torch.cuda.synchronize()
        err_abs, err_rel = _max_err(out, ref)
        ok = err_abs <= tol_abs or err_rel <= tol_rel
        dev_us, per_call, method = device_us(kernel, KERNEL_FUNCTIONS[name])
        bound, bound_by = bound_us(nbytes, flops)
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": TPU_KERNELS[name], "shape": shape, "path": path,
               "launches": None, "launches_per_frame": None,
               "max_abs_err": err_abs, "max_rel_err": err_rel,
               "tol_abs": tol_abs, "tol_rel": tol_rel,
               "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
               "device_us": dev_us, "device_method": method,
               "cuda_launches_per_call": per_call,
               "host_us": host_us(kernel), "bytes": nbytes, "flops": flops,
               "bound_us": bound, "bound_ms": bound / 1e3,
               "bound_by": bound_by, "library_call": LIBRARY_CALLS[name],
               "library_ms": None, "library_device_us": None,
               "library_host_us": None, "library_max_abs_err": None,
               **(extra or {})}
        if library is None:
            row["library_reason"] = NO_LIBRARY_CALL
        else:
            call, compared = library
            row["library_max_abs_err"] = _max_err(*compared(call()))[0]
            row["library_ms"] = cuda_ms(call)
            row["library_device_us"] = device_us(call, ("",))[0]
            row["library_host_us"] = host_us(call)
        emit("phase2", row)
        require(ok, f"{name} {shape}: kernel disagrees with its plain "
                    f"version (abs {err_abs}, rel {err_rel})")
        require(per_call is None or per_call <= 1.0,
                f"{name} {shape}: {per_call} CUDA launches per call, not 1")
        rows.append(row)

    def pyramid_case(image, path, levels, what):
        """B1/B2 exact on every level of a pyramid, B1 built one level at a
        time and in one launch; B1 timed per pyramid, B2 at level 0."""
        lv = image.contiguous()
        shapes = []
        for level in range(levels):
            shapes.append(list(lv.shape))
            for a, b in zip(pk.gradients(lv), pk.gradients_plain(lv)):
                e = _max_err(a, b)[0]
                require(e == 0.0, f"gradients, {what} level {level}: {e}")
            if level + 1 < levels:
                half = pk.halfsample(lv)
                e = _max_err(half, pk.halfsample_plain(lv))[0]
                require(e == 0.0, f"halfsample, {what} level {level}: {e}")
                lv = half
        before = pk.LAUNCHES["halfsample"]
        bufs = pk.pyramid(image, levels)
        torch.cuda.synchronize()
        require(pk.LAUNCHES["halfsample"] == before + 1,
                f"pyramid, {what}: {pk.LAUNCHES['halfsample'] - before} "
                f"B1 launches, not 1")
        require(torch.equal(bufs[0][0], image),
                f"pyramid, {what}: level 0 is not the frame")
        h, w = image.shape
        coarse = sum(a * b for a, b in shapes[1:])
        x = image[None, None]

        def library_chain():
            out = [torch.empty_like(image).copy_(image)]
            y = x
            for _ in range(levels - 1):
                y = F.avg_pool2d(y, 2)
                out.append(y[0, 0])
            return out

        def image_planes(bufs):
            return [b[0] for b in bufs]

        # every level's image plane against the plain chain: the same
        # additions in the same order, no fused multiply-add, so exact;
        # bytes: the frame read once, level 0 and every coarser level
        # written once
        record("halfsample", lambda: pk.pyramid(image, levels),
               lambda: pk.pyramid_plain(image, levels), 0.0, 0.0, [h, w],
               path, 4.0 * (2 * h * w + coarse), 4.0 * coarse,
               (library_chain,
                lambda y: (y, image_planes(pk.pyramid(image, levels)))),
               {"levels": levels, "levels_exact": shapes},
               outputs=image_planes)
        stencil = torch.zeros(2, 1, 3, 3, device=image.device)
        stencil[0, 0, 1, 0], stencil[0, 0, 1, 2] = -0.5, 0.5
        stencil[1, 0, 0, 1], stencil[1, 0, 2, 1] = -0.5, 0.5
        record("gradients", lambda: pk.gradients(image),
               lambda: pk.gradients_plain(image), 0.0, 0.0, [h, w], path,
               4.0 * 3 * h * w, 4.0 * h * w,
               (lambda: F.conv2d(x, stencil, padding=1),
                lambda y: (y[0, :, 1:-1, 1:-1],
                           torch.stack(pk.gradients(image))[:, 1:-1, 1:-1])))

    def patch_case(image, uv, P, path, use, K=1):
        """B3 at centres ``uv`` on ``image`` (K = 3: the level's image, gx
        and gy in one launch): bit for bit the plain version."""
        h, w = image.shape
        src = image
        if K == 3:
            levels, gxs, gys = pyramid.build_with_gradients(image, 1)
            src = pyramid.level_planes(levels[0], gxs[0], gys[0])
        M, P2 = uv.numel() // 2, P * P
        half = (P - 1) / 2.0
        flat = uv.reshape(-1, 2)
        inner = ((flat[:, 0] >= half + 1) & (flat[:, 0] <= w - half - 3)
                 & (flat[:, 1] >= half + 1) & (flat[:, 1] <= h - half - 3))
        grid = _grid(uv, P, h, w, K)
        planes = src.reshape(K, 1, h, w)
        record("sample_patches", lambda: ak.sample_patches(src, uv, P),
               lambda: ak.sample_patches_plain(src, uv, P), 0.0, 0.0,
               [K, h, w, M, P], path,
               4.0 * (K * footprint_pixels(h, w, uv, P) + 2 * M
                      + K * M * P2),
               # per output: 4 operations for the tap coordinates, 9 for
               # the blend
               13.0 * K * M * P2,
               (lambda: F.grid_sample(planes, grid, mode="bilinear",
                                      padding_mode="border",
                                      align_corners=True),
                lambda y: (y[:, 0][:, inner], ak.sample_patches(
                    src, uv, P).reshape(K, M, P2)[:, inner])),
               {"use": use, "interior_centres": int(inner.sum())})

    def gn_case(image, N, path, use):
        """B4 at N features, P=4, on ``image`` with (a, b) != (1, 0) and a
        per-pixel mask; bit-reproducible, also after a call at another
        width on the same stream."""
        P = 4
        h, w = image.shape
        uv_in = (torch.rand(N, 2, generator=gen)
                 * torch.tensor([w - 8.0, h - 8.0]) + 4.0).to(device)
        cur = ak.sample_patches_plain(image, uv_in, P)
        a_il = torch.tensor(1.3, device=device)
        b_il = torch.tensor(-7.0, device=device)
        tmpl = ((cur - b_il) / a_il
                + 6.0 * torch.randn(cur.shape, generator=gen).to(device))
        jac = torch.randn(N, P * P, 6, generator=gen).to(device) * 50.0
        mask = (torch.rand(N, P * P, generator=gen) > 0.2).float().to(device)
        args = (image, uv_in, tmpl.contiguous(), jac, mask, P, 8.0, a_il,
                b_il)
        kern = ak.gn_accumulate(*args)
        plain = ak.gn_accumulate_plain(*args)
        for a, b, name in zip(kern[3:], plain[3:], ("n_eff", "n_inl")):
            require(float(a) == float(b), f"gn_accumulate N={N} {name}: "
                                          f"{float(a)} vs {float(b)}")
        again = ak.gn_accumulate(*args)
        require(all(torch.equal(a, b) for a, b in zip(kern, again)),
                f"gn_accumulate N={N} is not bit-reproducible")
        gn_runs[N] = (args, kern)
        terms = N * P * P
        # H, g, cost: float32 sums of N·16 terms in two orders, so the
        # error is judged relative to each output's largest entry
        record("gn_accumulate", lambda: ak.gn_accumulate(*args)[:3],
               lambda: ak.gn_accumulate_plain(*args)[:3], 0.0, 1e-4,
               [h, w, N, P], path,
               4.0 * (footprint_pixels(h, w, uv_in, P) + 2 * N + terms * 8
                      + 2 + 45),
               # per term: 13 to sample, 6 for the residual and Huber
               # weight, 6 + 42 + 12 for Jw, H and g, 5 for cost and counts
               84.0 * terms, None,
               {"use": use, "a_b": [1.3, -7.0],
                "blocks": _build.load_library().svo_gn_blocks(N, P),
                "bit_reproducible": True})

    def centres(N, h, w, n_border=0):
        """N centres over the image and 2 px beyond it; the first
        ``n_border`` within 3 px of a corner side."""
        uv = (torch.rand(N, 2, generator=gen)
              * torch.tensor([w + 4.0, h + 4.0]) - 2.0)
        edge = torch.rand(n_border, 2, generator=gen) * 5.0 - 3.0
        uv[:n_border // 2] = edge[:n_border // 2]
        uv[n_border // 2:n_border] = (torch.tensor([w - 1.0, h - 1.0])
                                      + edge[n_border // 2:])
        return uv.to(device)

    gn_runs = {}
    kitti = kitti_frame.contiguous()
    half_img, half_kitti = pk.halfsample(img), pk.halfsample(kitti)
    uv192 = centres(192, H, W, n_border=48)
    # ---- main path (phase 3): the first row of each kernel ----
    pyramid_case(img, "phase3", 4, "752x480")
    patch_case(img, uv192, 8, "phase3", "KLT iterations")
    gn_case(img, 192, "phase3", "alignment refresh pass")
    patch_case(img, uv192, 4, "phase3", "alignment inner passes")
    patch_case(img, uv192, 4, "phase3", "alignment template", K=3)
    patch_case(img, uv192, 8, "phase3", "KLT template (keyframes)", K=3)
    # ---- the other paths' shapes ----
    pyramid_case(kitti, "phase4", 4, "1241x376")
    pyramid_case(img, "phase5", 5, "752x480 5-level")
    # epipolar search: 240 seeds x 16 probes on KITTI level 1 (620x188)
    patch_case(half_kitti, centres(240 * 16, *half_kitti.shape), 8,
               "phase4", "epipolar probes")
    patch_case(kitti, centres(240, *kitti.shape), 8, "phase4", "KITTI KLT")
    patch_case(img, centres(2048, H, W), 8, "phase5", "stress KLT")
    # affine KLT: oversized 16x16 templates at N=192 on the 752x480 level
    patch_case(img, uv192, 16, "phase6", "big templates")
    # alignment's refresh pass at the KITTI (level 0) and stress (level 1,
    # its finest alignment level) widths
    gn_case(kitti, 240, "phase4", "KITTI alignment")
    gn_case(half_img, 2048, "phase5", "stress alignment")
    # one launch per call leaves the ticket counter at 0 whatever the grid:
    # N = 192 → 2048 → 192 back to back repeats each first result
    outs = [ak.gn_accumulate(*gn_runs[N][0]) for N in (192, 2048, 192)]
    for out, N in zip(outs, (192, 2048, 192)):
        require(all(torch.equal(a, b) for a, b in zip(out, gn_runs[N][1])),
                f"gn_accumulate N={N} changed after a call at another width")
    emit("phase2_gn_alternation", {"widths": [192, 2048, 192],
                                   "bit_equal": True})
    return rows


def render_kitti_road(cam, n, device):
    """The KITTI-geometry road sequence as bench.py renders it: the frame
    loop of synthetic.make_sequence (road scene, kitti trajectory, seed 0,
    dt 0.08) with bench.py's 2×2 anti-aliasing for road scenes, which
    make_sequence does not offer."""
    import torch
    from stereo_svo_tpu_torch.io import synthetic
    scene = synthetic.get_scene("road", SEED, device)
    lefts, rights, poses = [], [], []
    for i in range(n):
        T = synthetic.trajectory_pose(
            torch.tensor(i * DT, dtype=torch.float32, device=device), "kitti")
        left, right = synthetic.render_stereo(cam, T, scene, aa=2)
        lefts.append(left)
        rights.append(right)
        poses.append(T)
    return torch.stack(lefts), torch.stack(rights), torch.stack(poses)


def drive(cfg, lefts, rights, gt, counters):
    """One run of StereoSvo over the frames with every launch counter set
    to 0 just before and read just after: gates' inputs and timings. Host
    syncs are counted on every frame under CUDA sync debug mode, where each
    synchronising call warns (a few µs of host time per frame)."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.engine.runner import StereoSvo
    from stereo_svo_tpu_torch.eval import ate

    svo = StereoSvo(cfg, device="cuda")
    n = lefts.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counts in counters:
        for k in counts:
            counts[k] = 0
    events, syncs, sync_sites = [], [], {}
    t_wall = time.perf_counter()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for i in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                a.record()
                svo.new_image(lefts[i], rights[i])
                b.record()
            events.append((a, b))
            hits = [w for w in caught if "synchroniz" in str(w.message)]
            syncs.append(len(hits))
            for w in hits:
                key = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                sync_sites[key] = sync_sites.get(key, 0) + 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t_wall
    launches = {k: v for counts in counters for k, v in counts.items()}
    frame_ms = [a.elapsed_time(b) for a, b in events]
    traj, metrics = svo.trajectory(), svo.metrics()
    require(traj.shape == (n, 3, 4) and np.isfinite(traj).all(),
            "trajectory must be finite (N,3,4)")
    gt = gt.cpu().numpy()
    kf = metrics["kf_inserted"]
    ba_frames = kf & (np.arange(n) > 0)       # window BA runs on these
    steady = frame_ms[1:]
    out = {
        "frames": n, "image": list(lefts.shape[1:]),
        "ate_m": ate.ate_rmse(ate.positions(traj), ate.positions(gt)),
        "gt_travel_m": float(np.sum(np.linalg.norm(
            np.diff(ate.positions(gt), axis=0), axis=-1))),
        "tracking_ok": float(np.mean(metrics["tracking_ok"])),
        "keyframes": int(kf.sum()),
        "ba_calls": int(ba_frames.sum()) if cfg.use_ba else 0,
        "ba_accepted": int(metrics["ba_diag"][ba_frames, 5].sum())
        if cfg.use_ba else 0,
        "epi_recovered": int(metrics["n_epi_recovered"].sum()),
        "warped_templates": int(metrics["n_warped"].sum()),
        "frame_ms_median": statistics.median(steady),
        "frame_ms_p90": statistics.quantiles(steady, n=10)[8],
        "kf_frame_ms_median": statistics.median(
            [frame_ms[i] for i in np.nonzero(ba_frames)[0]] or [0.0]),
        "fps": 1000.0 * len(steady) / sum(steady),
        "fps_wall_incl_first": n / wall_s, "first_frame_ms": frame_ms[0],
        "launches": launches,
        "launches_per_frame": {k: v / n for k, v in launches.items()},
        "max_memory_allocated_mb":
            torch.cuda.max_memory_allocated() / 2**20,
        "host_syncs_per_frame": {str(c): syncs.count(c)
                                 for c in sorted(set(syncs))},
        "sync_sites": sync_sites,
    }
    missing = [k for k, v in launches.items() if v <= 0]
    require(not missing, f"kernels never launched on this path: {missing}")
    require(syncs[0] == 0 and all(c == 1 for c in syncs[1:]),
            f"host syncs per frame {syncs} (want 0 on the bootstrap, 1 on "
            f"every tracked frame): {sync_sites}")
    return out, frame_ms, metrics


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: chip_smoke.py "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import stereo_svo_tpu_torch  # noqa: F401  (sets the TF32 flags)
        from stereo_svo_tpu_torch.config import (SvoConfig, kitti_config,
                                                 stress_config)
        from stereo_svo_tpu_torch.io import synthetic
        from stereo_svo_tpu_torch.ops.kernels import _build
        from stereo_svo_tpu_torch.ops.kernels import align_kernel as ak
        from stereo_svo_tpu_torch.ops.kernels import pyramid_kernel as pk
    except ImportError as e:
        print(f"FAIL: the port is not importable ({e}); run chip_smoke.py "
              "from the root of a checkout", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    counters = (pk.LAUNCHES, ak.LAUNCHES)
    detail = {}

    # ---- phase 0: device ----
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    phase0 = {"device_name": name, "nvidia_smi": smi,
              "device_count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
              "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    emit("phase0", phase0)
    require(not phase0["matmul_allow_tf32"] and not phase0["cudnn_allow_tf32"],
            "TF32 must stay off")

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log = _build.library_path().with_suffix(".log")
    detail["build_log"] = log.read_text() if log.exists() else ""
    emit("phase1", {"build_seconds": build_s,
                    "library": os.path.relpath(_build.library_path(), ROOT)})

    # ---- render the sequences on the card ----
    cfg = SvoConfig()
    kcfg = kitti_config()
    t0 = time.perf_counter()
    lefts, rights, gt = synthetic.make_sequence(
        cfg.camera, N_FRAMES, DT, kind="arc", seed=SEED, device=device)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    require(tuple(lefts.shape) == (N_FRAMES, 480, 752), f"{lefts.shape}")
    t0 = time.perf_counter()
    k_lefts, k_rights, k_gt = render_kitti_road(kcfg.camera, N_FRAMES,
                                                device)
    torch.cuda.synchronize()
    k_render_s = time.perf_counter() - t0
    require(tuple(k_lefts.shape) == (N_FRAMES, 376, 1241),
            f"{k_lefts.shape}")

    # ---- phase 2: kernels against plain versions ----
    rows = check_kernels(device, lefts[0], k_lefts[0])

    # ---- phase 3: the main path, SvoConfig() as shipped ----
    phase3, frame_ms, metrics = drive(cfg, lefts, rights, gt, counters)
    phase3.update(config="SvoConfig()", render_seconds=render_s)
    emit("phase3", phase3)
    detail.update(phase0=phase0, phase3=phase3, frame_ms=frame_ms,
                  n_tracked=metrics["n_tracked"].tolist(),
                  ba_diag=metrics["ba_diag"].tolist())
    require(phase3["ate_m"] <= ATE_GATE_M,
            f"ATE {phase3['ate_m']} m above {ATE_GATE_M}")
    require(phase3["tracking_ok"] >= TRACK_GATE,
            f"tracking_ok {phase3['tracking_ok']} below {TRACK_GATE}")
    require(phase3["ba_accepted"] >= 1, "no window BA call was accepted")

    # ---- phase 4: KITTI geometry ----
    phase4, frame_ms, metrics = drive(kcfg, k_lefts, k_rights, k_gt,
                                      counters)
    gate = max(KITTI_ATE_FLOOR_M, KITTI_ATE_FRAC * phase4["gt_travel_m"])
    phase4.update(config="kitti_config()", scene="road", traj="kitti",
                  aa=2, ate_gate_m=gate, render_seconds=k_render_s)
    emit("phase4", phase4)
    detail.update(phase4=phase4, phase4_frame_ms=frame_ms)
    require(phase4["ate_m"] <= gate, f"KITTI ATE {phase4['ate_m']} m above "
                                     f"{gate}")
    require(phase4["tracking_ok"] >= TRACK_GATE,
            f"KITTI tracking_ok {phase4['tracking_ok']}")
    require(phase4["epi_recovered"] > 0, "the epipolar search recovered "
                                         "no seed")
    del k_lefts, k_rights

    # ---- phase 5: stress ----
    phase5, frame_ms, _ = drive(stress_config(), lefts, rights, gt,
                                counters)
    phase5.update(config="stress_config()")
    emit("phase5", phase5)
    detail.update(phase5=phase5, phase5_frame_ms=frame_ms)
    require(phase5["ate_m"] <= ATE_GATE_M,
            f"stress ATE {phase5['ate_m']} m above {ATE_GATE_M}")
    require(phase5["tracking_ok"] >= TRACK_GATE,
            f"stress tracking_ok {phase5['tracking_ok']}")

    # ---- phase 6: affine-warped KLT templates ----
    acfg = SvoConfig(klt_affine_warp=True)
    n6 = N_AFFINE_FRAMES
    phase6, frame_ms, _ = drive(acfg, lefts[:n6], rights[:n6], gt[:n6],
                                counters)
    phase6.update(config="SvoConfig(klt_affine_warp=True)")
    emit("phase6", phase6)
    detail.update(phase6=phase6, phase6_frame_ms=frame_ms)
    require(phase6["ate_m"] <= ATE_GATE_M,
            f"affine ATE {phase6['ate_m']} m above {ATE_GATE_M}")
    require(phase6["tracking_ok"] >= TRACK_GATE,
            f"affine tracking_ok {phase6['tracking_ok']}")
    require(phase6["warped_templates"] > 0,
            "no feature was tracked on a warped template")

    # launches of each row's kernel on the path that gives it its shape
    paths = {"phase3": phase3, "phase4": phase4, "phase5": phase5,
             "phase6": phase6}
    b1 = {k: p["launches_per_frame"]["halfsample"] for k, p in paths.items()}
    require(all(v == 1.0 for v in b1.values()),
            f"B1 launches per frame {b1}, not 1.0 (one per pyramid)")
    for row in rows:
        path = paths[row["path"]]
        row["launches"] = path["launches"][row["name"]]
        row["launches_per_frame"] = path["launches_per_frame"][row["name"]]
    emit("phase2_rows", {"rows": [
        {k: r.get(k) for k in ROW_SUMMARY} for r in rows]})
    detail["kernels"] = rows
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1)

    main_rows = {}
    for row in rows:                 # each kernel's first row: phase 3
        main_rows.setdefault(row["name"], row)
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "max_rel_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms", "device_us",
                           "host_us")}
        for r in main_rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
