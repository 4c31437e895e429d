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
     warped templates > 0 (the step's n_warped metric);
  7. online loop closure at 752×480 on the EuRoC rig:
     SvoConfig(online_loop_every=1, kf_dist_ratio=0.05, loop_min_gap=15,
     loop_min_score=0.75) over the 60-frame out-and-back "loop" sequence
     (dt 0.25, seed 0) with tests/test_online_loop.py's drift injected
     before frame 30, then refine_trajectory on the final state; gates the
     keyframe frames, loop closures and offline edges equal to the JAX CPU
     reference, tail error and ATE within LOOP_TOL_M of it, tracking 1.0,
     and B2, B3 and B4 launched inside every online-loop call; reports per
     online-loop call its kernel launches, host ms and event ms, and for
     one call under torch.profiler its CUDA launches and device ms; per
     refine_trajectory call its kernel launches and host ms (its device ms
     are profile_step.py's "loop" line);
  7b. the same at 752×480 on tests/test_online_loop.py's rig (fx 760,
     baseline 0.25, a 3-keyframe window, a 12-slot bank), with
     online_loop_every=1 and the control at 0; gates loop closures and
     offline edges equal to the reference, none in the control, and the
     tail error below 0.75× the control's;
  8. batched-8 (bench.py's setup): SvoConfig(), 8 "planes" sequences of
     seeds 0-7 on the arc, 25 frames at dt 0.08, through
     run_sequence_batched; gates ATE and tracking per sequence, one host
     sync per batched frame after the first, and sequence 0's poses equal
     to phase 3's first 25 bit for bit; reports the aggregate frames/s.
  9. tracking loss and relocalisation: SvoConfig(kf_dist_ratio=0.05) over
     the first 48 frames of phase 7's sequence with frames 20-22 blacked
     out (zeros), as tests/test_engine.py sets it up; gates tracking_ok
     false exactly on those frames and true from the next real frame on,
     finite poses, the keyframe frames equal to the JAX CPU reference, tail
     error and ATE within BLACKOUT_TOL_M of it, one host sync on every
     tracked frame (the failed ones included), and the rotated
     relocalisation variants computed on each frame after a failed one;
  10. the command-line app in-process: cli.main(--dataset synthetic
     --frames 60 --loop-closure --metrics-out ... --out ...) on the card,
     writing under build/; gates the summary's keys, ATE and tracking, one
     TUM line per frame that load_tum reads back (stamps i*0.1, ATE of the
     file's positions equal to the summary's), one host sync per frame
     inside the frame loop; then checkpoint and resume: 30 frames of phase
     3's sequence, utils/checkpoint.save, load into a fresh StereoSvo on
     the card, 30 more frames, whose poses must equal phase 3's bit for
     bit; reports the milliseconds of save and load;
  11. the global map: the final states of two of phase 8's sequences into
     parallel/mapping.build_global_map (20 poses, 384 landmarks), then
     detect_loop_edges and optimize_global_map over an nccl process group
     of world size 1 on the card; gates finite output, every valid
     keyframe moved by less than MAP_MAX_MOVE_M, and the sharded BA at
     world size 1 within MAP_BA_TOL of the single-process ba_iteration
     loop on the same inputs; reports launches, device ms and wall ms of
     the call and of its pose-graph and BA parts. The machine has one GPU:
     no multi-rank NCCL run is made here (the multi-rank check is the gloo
     CPU dry run of tests/test_torch_parallel.py).
Phase 2 also holds B2, B3 (K=3 and K=1) and B4 at the keyframe thumbnail
(120x188, N=192, P=4, the centres a keyframe's features give it) that
phase 7's edge measurements use.
Each of phases 3-11 zeroes the launch counters just before its run, reads
them just after, and fails unless every kernel launched; it counts host
syncs on every frame of the run (CUDA sync debug mode) and fails unless
the bootstrap frame has none and every other frame, keyframe frames with
window BA, online loop closure and epipolar recoveries included, has
exactly one (phase 8: per batched frame; phases 10 and 11 count them
inside the frame loop only).
Then phase2_rows (every kernel row with its launches per frame), the
kernels JSON line (each kernel's main-path row, launches from phase 3),
the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure exits non-zero with no ok line.
Extra detail (build log, per-frame times) goes to build/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
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
# phases 7 and 7b: tests/test_online_loop.py's scenario at 752x480
LOOP_FRAMES, LOOP_DT, LOOP_INJECT_AT = 60, 0.25, 30
LOOP_DRIFT = [0.05, 0.02, -0.05, 0.004, -0.006, 0.003]
LOOP_KNOBS = dict(kf_dist_ratio=0.05, loop_min_gap=15, loop_min_score=0.75)
RIG_7B = dict(fx=760.0, fy=760.0, cx=376.0, cy=240.0, baseline=0.25,
              width=752, height=480)
# the JAX package on the CPU over the same frames and drift (recomputed by
# tests/test_torch_chip_reference.py); tail = mean position error of the
# last 5 frames
PHASE7_REF = dict(kf_frames=[0, 3, 6, 10, 16, 24, 28, 31, 34, 37, 41, 45, 51],
                  n_loop_closures=0, offline_edges=8,
                  tail_err_m=0.07580976188182831, ate_m=0.02633512466158519)
PHASE7B_REF = dict(kf_frames=[0, 3, 6, 9, 14, 24, 28, 31, 34, 37, 41, 45, 51],
                   n_loop_closures=3, offline_edges=8,
                   tail_err_m=0.02227490395307541,
                   control_tail_err_m=0.0713019147515297)
LOOP_TOL_M = 5e-3            # |card − reference| for tail error and ATE
BATCH, BATCH_FRAMES = 8, 25  # bench.py:376-429
# phase 9: tests/test_engine.py's blackout scenario at 752x480: the first
# frames of phase 7's sequence with zeros for the blacked-out ones
BLACKOUT_FRAMES, BLACKOUT = 48, (20, 21, 22)
BLACKOUT_KNOBS = dict(kf_dist_ratio=0.05)  # a keyframe near every frame
# the JAX package on the CPU over the same frames (recomputed by
# tests/test_torch_chip_reference.py)
PHASE9_REF = dict(kf_frames=[0, 3, 6, 10, 16, 24, 25, 29, 32, 35, 38, 42,
                             47],
                  lost_frames=[20, 21, 22],
                  tail_err_m=0.016947779804468155,
                  ate_m=0.051268993614293136)
BLACKOUT_TOL_M = 5e-3        # |card − reference| for tail error and ATE
# phase 10: the command-line app, then checkpoint and resume
CLI_FRAMES, CLI_DT = 60, 0.1               # the CLI's synthetic sequence
CLI_SUMMARY_KEYS = {"frames", "fps", "keyframes", "tracking_ok_frac",
                    "mean_tracked", "loop_edges", "out", "ate_rmse_m",
                    "rpe_t_m", "rpe_r_rad"}
RESUME_AT, RESUME_FRAMES = 30, 60          # of phase 3's sequence
# phase 11: the global map of two of phase 8's sequences
MAP_MAX_MOVE_M = 0.05                      # tests/test_mapping.py:52
MAP_BA_TOL = 1e-6            # sharded BA at world size 1 against the
                             # single-process iterations (same sums)
N_TIMED = 60                               # event-pair timing repetitions
N_BACK = 200                               # back-to-back calls (device_us,
                                           # host_us)
# the runtime calls that launch a kernel, as torch.profiler names them
LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
               "cuLaunchKernelEx")
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
               "launches_per_frame", "launches_per_loop_call",
               "max_abs_err", "ms", "plain_ms",
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


def check_kernels(device, frame, kitti_frame, thumb):
    """Phase 2: each kernel against its plain version on the card at every
    shape a shipped path gives it, with its bound, device, host, event and
    library-call times. ``thumb``: (keyframe thumbnail, its feature centres
    at thumbnail scale, their mask), the inputs of phase 7's edge
    measurements. Returns the rows; the first row of each kernel is its
    main-path row."""
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
        gradients_case(image, path)

    def gradients_case(image, path, extra=None):
        """B2 on one level, exact; the library call is a two-channel
        conv2d, compared on the interior."""
        h, w = image.shape
        x = image[None, None]
        stencil = torch.zeros(2, 1, 3, 3, device=image.device)
        stencil[0, 0, 1, 0], stencil[0, 0, 1, 2] = -0.5, 0.5
        stencil[1, 0, 0, 1], stencil[1, 0, 2, 1] = -0.5, 0.5
        record("gradients", lambda: pk.gradients(image),
               lambda: pk.gradients_plain(image), 0.0, 0.0, [h, w], path,
               4.0 * 3 * h * w, 4.0 * h * w,
               (lambda: F.conv2d(x, stencil, padding=1),
                lambda y: (y[0, :, 1:-1, 1:-1],
                           torch.stack(pk.gradients(image))[:, 1:-1, 1:-1])),
               extra)

    def patch_case(image, uv, P, path, use, K=1, extra=None):
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
               {"use": use, "interior_centres": int(inner.sum()),
                **(extra or {})})

    def gn_case(image, N, path, use, uv_in=None, feature_mask=None,
                tol_rel=1e-4, extra=None):
        """B4 at N features, P=4, on ``image`` with (a, b) != (1, 0) and a
        per-pixel mask (times ``feature_mask`` where given); at ``uv_in``,
        or N centres drawn inside the image; bit-reproducible, also after a
        call at another width on the same stream."""
        P = 4
        h, w = image.shape
        if uv_in is None:
            uv_in = (torch.rand(N, 2, generator=gen)
                     * torch.tensor([w - 8.0, h - 8.0]) + 4.0).to(device)
        cur = ak.sample_patches_plain(image, uv_in, P)
        a_il = torch.tensor(1.3, device=device)
        b_il = torch.tensor(-7.0, device=device)
        tmpl = ((cur - b_il) / a_il
                + 6.0 * torch.randn(cur.shape, generator=gen).to(device))
        jac = torch.randn(N, P * P, 6, generator=gen).to(device) * 50.0
        mask = (torch.rand(N, P * P, generator=gen) > 0.2).float().to(device)
        if feature_mask is not None:
            mask = mask * feature_mask[:, None].float()
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
               lambda: ak.gn_accumulate_plain(*args)[:3], 0.0, tol_rel,
               [h, w, N, P], path,
               4.0 * (footprint_pixels(h, w, uv_in, P) + 2 * N + terms * 8
                      + 2 + 45),
               # per term: 13 to sample, 6 for the residual and Huber
               # weight, 6 + 42 + 12 for Jw, H and g, 5 for cost and counts
               84.0 * terms, None,
               {"use": use, "a_b": [1.3, -7.0],
                "blocks": _build.load_library().svo_gn_blocks(N, P),
                "bit_reproducible": True, **(extra or {})})

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
    # loop-edge measurement at the keyframe thumbnail: B2 on the thumbnail,
    # the template (K=3) and inner passes (K=1) of B3 and the refresh
    # passes of B4 at the features' centres scaled to it, P = loop_patch
    t_img, t_uv, t_mask = thumb
    edge = {"thumbnail": True}
    gradients_case(t_img, "phase7", edge)
    patch_case(t_img, t_uv, 4, "phase7", "loop template", K=3, extra=edge)
    patch_case(t_img, t_uv, 4, "phase7", "loop inner passes", extra=edge)
    gn_case(t_img, t_uv.shape[0], "phase7", "loop refresh pass", uv_in=t_uv,
            feature_mask=t_mask, tol_rel=4e-7, extra=edge)
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


def count_syncs(fn):
    """fn() under CUDA sync debug mode ("warn"): (its result, the host
    syncs it made, {file:line: count} of where). Each synchronising call
    warns, a few µs of host time each."""
    import torch
    sites = {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    hits = [w for w in caught if "synchroniz" in str(w.message)]
    for w in hits:
        key = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
        sites[key] = sites.get(key, 0) + 1
    return out, len(hits), sites


def prof_stats(fn):
    """(CUDA launches, device ms) of ``fn()`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    ka = p.key_averages()
    launches = sum(e.count for e in ka if e.key in LAUNCH_KEYS)
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in ka
                 if str(getattr(e, "device_type", "")).endswith("CUDA"))
    return launches, dev_us / 1e3


def drive(cfg, lefts, rights, gt, counters, before_frame=None):
    """One run of StereoSvo over the frames with every launch counter set
    to 0 just before and read just after: gates' inputs and timings, and
    the StereoSvo. ``before_frame(i, svo)`` runs before frame i, outside
    the frame's timing and sync count. Host syncs are counted on every
    frame under CUDA sync debug mode."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.engine.runner import StereoSvo
    from stereo_svo_tpu_torch.eval import ate

    svo = StereoSvo(cfg, device="cuda")
    n = lefts.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    events, syncs, sync_sites = [], [], {}
    t_wall = time.perf_counter()
    for i in range(n):
        if before_frame is not None:
            before_frame(i, svo)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)

        def frame():
            a.record()
            svo.new_image(lefts[i], rights[i])
            b.record()

        _, count, sites = count_syncs(frame)
        events.append((a, b))
        syncs.append(count)
        for key, c in sites.items():
            sync_sites[key] = sync_sites.get(key, 0) + c
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
    return out, frame_ms, metrics, svo


def inject_world_offset(state, D):
    """tests/test_online_loop.py's drift event: the window (current and
    template poses, window keyframes and the bank slots they own) moves by
    D ((3,4), cam→world side), older bank poses stay where they were."""
    import torch
    from stereo_svo_tpu_torch.frontend import keyframe
    from stereo_svo_tpu_torch.geometry import se3
    M = state.mem_valid.shape[0]
    owns = state.kf_valid & (state.mem_stamp[state.kf_mem] == state.kf_stamp)
    owned = (keyframe._one_hot(state.kf_mem, M) & owns[None]).any(1)
    Dinv = se3.inverse(D)
    return state._replace(
        T_cw=se3.compose(state.T_cw, Dinv), T_pw=se3.compose(state.T_pw, Dinv),
        kf_T_wk=torch.where(state.kf_valid[:, None, None],
                            se3.compose(D, state.kf_T_wk), state.kf_T_wk),
        mem_T_wk=torch.where(owned[:, None, None],
                             se3.compose(D, state.mem_T_wk), state.mem_T_wk))


@contextlib.contextmanager
def watch_calls(module, name, counters):
    """While the block runs, ``module.<name>`` (looked up at each call by
    its callers) is wrapped: per call, the launches each kernel counter
    gained, the host ms to issue it (no sync: the call makes none) and a
    CUDA-event pair around it; the last call's arguments are kept."""
    import torch
    orig = getattr(module, name)
    calls = []

    def wrapped(*args, **kwargs):
        before = {k: v for c in counters for k, v in c.items()}
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out = orig(*args, **kwargs)
        b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        if calls:                        # only the last call's are kept
            del calls[-1]["args"], calls[-1]["kwargs"]
        calls.append({"launches": {k: v - before[k] for c in counters
                                   for k, v in c.items()},
                      "host_ms": host_ms, "events": (a, b), "args": args,
                      "kwargs": kwargs})
        return out

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def tail_err(traj, gt, k: int = 5) -> float:
    """Mean position error (m) over the last k frames."""
    import numpy as np
    return float(np.linalg.norm(traj[-k:, :, 3] - gt[-k:, :, 3],
                                axis=1).mean())


def loop_run(cfg, lefts, rights, gt, counters, device):
    """A phase-7 run: StereoSvo over the loop sequence with the drift
    injected before frame LOOP_INJECT_AT and every online-loop call
    watched (launches of each kernel, host ms to issue, event ms). Returns
    (result dict, the StereoSvo, the watched calls)."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.engine import step as step_mod
    from stereo_svo_tpu_torch.geometry import se3

    D = se3.exp(torch.tensor(LOOP_DRIFT, dtype=torch.float32, device=device))

    def inject(i, svo):
        if i == LOOP_INJECT_AT:
            svo.state = inject_world_offset(svo.state, D)

    with watch_calls(step_mod, "run_online_loop", counters) as calls:
        out, frame_ms, metrics, svo = drive(cfg, lefts, rights, gt, counters,
                                            before_frame=inject)
    traj, gt_np = svo.trajectory(), gt.cpu().numpy()
    n_frames = lefts.shape[0]
    out.update(kf_frames=np.nonzero(metrics["kf_inserted"])[0].tolist(),
               n_loop_closures=int(svo.state.n_loop_closures),
               tail_err_m=tail_err(traj, gt_np), loop_calls=len(calls),
               frame_ms_all=frame_ms)
    if calls:
        call_frames = [i for i in range(n_frames)
                       if metrics["kf_inserted"][i] and i > 0]
        out["loop_call"] = {
            "launches_per_call": {k: statistics.mean(
                c["launches"][k] for c in calls) for k in calls[0]["launches"]},
            "host_ms_median": statistics.median(c["host_ms"] for c in calls),
            "event_ms_median": statistics.median(
                a.elapsed_time(b) for a, b in (c["events"] for c in calls)),
            "kf_frame_ms_median": statistics.median(
                frame_ms[i] for i in call_frames)}
        missing = [k for k in ("gradients", "sample_patches",
                               "gn_accumulate")
                   if any(c["launches"][k] <= 0 for c in calls)]
        require(not missing, f"an online-loop call launched no {missing}")
    return out, svo, calls


def refine_run(cfg, svo, gt, counters):
    """refine_trajectory on a run's final state (host numpy at its end, so
    the host ms are its wall time): offline edges, launches of each
    kernel, host ms, and the refined trajectory's errors."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.backend import loop_closure
    from stereo_svo_tpu_torch.eval import ate

    traj, gt_np = svo.trajectory(), gt.cpu().numpy()
    before = {k: v for c in counters for k, v in c.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined, _, n_edges = loop_closure.refine_trajectory(cfg, svo.state, traj)
    host_ms = (time.perf_counter() - t0) * 1e3
    require(np.isfinite(refined).all(), "refine_trajectory: not finite")
    return {"offline_edges": n_edges, "host_ms": host_ms,
            "kernel_launches": {k: v - before[k] for c in counters
                                for k, v in c.items()},
            "tail_err_m": tail_err(refined, gt_np),
            "ate_m": ate.ate_rmse(ate.positions(refined),
                                  ate.positions(gt_np))}


def batched_run(cfg, counters, device, traj3):
    """Phase 8: BATCH sequences of the planes scene (seeds 0 to BATCH-1) on
    the arc trajectory, BATCH_FRAMES frames at DT, through
    run_sequence_batched, with the launch counters zeroed just before and
    the host syncs of every batched frame counted. ``traj3``: phase 3's
    trajectory, whose first frames sequence 0 repeats."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.engine import runner
    from stereo_svo_tpu_torch.eval import ate
    from stereo_svo_tpu_torch.io import synthetic

    t0 = time.perf_counter()
    seqs = [synthetic.make_sequence(cfg.camera, BATCH_FRAMES, DT, kind="arc",
                                    seed=b, device=device)
            for b in range(BATCH)]
    lefts = torch.stack([q[0] for q in seqs])
    rights = torch.stack([q[1] for q in seqs])
    gt = seqs[0][2].cpu().numpy()      # one trajectory for every scene
    del seqs
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0

    make = runner.make_batched_step     # run_sequence_batched looks it up
    syncs, sites = [], {}

    def counted(c):
        bstep = make(c)

        def step(*args):
            out, n, where = count_syncs(lambda: bstep(*args))
            syncs.append(n)
            for key, v in where.items():
                sites[key] = sites.get(key, 0) + v
            return out
        return step

    zero_counters(counters)
    runner.make_batched_step = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, outs = runner.run_sequence_batched(cfg, lefts, rights,
                                                   device=device)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        runner.make_batched_step = make
    launches = {k: v for counts in counters for k, v in counts.items()}
    traj = outs.T_wc.cpu().numpy()
    ok = outs.tracking_ok.cpu().numpy()
    ates = [ate.ate_rmse(ate.positions(traj[b]), ate.positions(gt))
            for b in range(BATCH)]
    out = {"config": "SvoConfig()", "batch": BATCH, "frames": BATCH_FRAMES,
           "scene": "planes", "traj": "arc", "seeds": list(range(BATCH)),
           "render_seconds": render_s, "wall_seconds": wall_s,
           "fps_aggregate": BATCH * BATCH_FRAMES / wall_s,
           "ate_m": ates, "ate_max_m": max(ates),
           "tracking_ok": ok.mean(1).tolist(),
           "keyframes": outs.kf_inserted.sum(1).tolist(),
           "host_syncs_per_batched_frame": {
               str(c): syncs.count(c) for c in sorted(set(syncs))},
           "sync_sites": sites, "launches": launches,
           "launches_per_batched_frame": {k: v / BATCH_FRAMES
                                          for k, v in launches.items()},
           "seq0_equals_phase3": bool(np.array_equal(
               traj[0], traj3[:BATCH_FRAMES]))}
    missing = [k for k, v in launches.items() if v <= 0]
    require(not missing, f"kernels never launched in the batch: {missing}")
    require(syncs[0] == 0 and all(c == 1 for c in syncs[1:]),
            f"host syncs per batched frame {syncs} (want 0 on the "
            f"bootstrap, 1 after): {sites}")
    require(max(ates) <= ATE_GATE_M, f"batched ATE {ates}")
    require(ok.mean(1).min() >= TRACK_GATE, f"batched tracking {ok.mean(1)}")
    require(out["seq0_equals_phase3"],
            "sequence 0 of the batch differs from phase 3's first frames")
    return out, states


def zero_counters(counters) -> None:
    for counts in counters:
        for k in counts:
            counts[k] = 0


def read_counters(counters, what: str, needs=None) -> dict:
    """The launch counts since zero_counters; every kernel (or those named
    in ``needs``) must have launched on the path ``what``."""
    launches = {k: v for counts in counters for k, v in counts.items()}
    missing = [k for k, v in launches.items()
               if v <= 0 and (needs is None or k in needs)]
    require(not missing, f"kernels never launched {what}: {missing}")
    return launches


def blackout_run(cfg, lefts, rights, gt, counters):
    """Phase 9: StereoSvo over the frames with the BLACKOUT ones replaced
    by zeros, every call of the rotated relocalisation variants watched.
    drive() holds every tracked frame, the failed ones included, to one
    host sync."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.backend import loop_closure

    lefts, rights = lefts.clone(), rights.clone()
    for i in BLACKOUT:
        lefts[i] = 0.0
        rights[i] = 0.0
    with watch_calls(loop_closure, "rotated_descriptors", counters) as calls:
        out, frame_ms, metrics, svo = drive(cfg, lefts, rights, gt, counters)
    ok = metrics["tracking_ok"]
    out.update(
        lost_frames=np.nonzero(~ok)[0].tolist(),
        kf_frames=np.nonzero(metrics["kf_inserted"])[0].tolist(),
        tail_err_m=tail_err(svo.trajectory(), gt.cpu().numpy()),
        rotated_variant_calls=len(calls),
        n_alive_end=int((svo.state.status > 0).sum()),
        failed_frame_ms=[frame_ms[i] for i in BLACKOUT],
        recovery_frame_ms=frame_ms[BLACKOUT[-1] + 1])
    return out, frame_ms


def cli_run(counters, device):
    """Phase 10, first half: the command-line app in-process on the card,
    its output files under build/. Host syncs are counted inside every
    new_image call of the frame loop (the rest of main renders, exports
    and reads metrics, which sync by nature)."""
    import io

    import numpy as np
    import torch
    from stereo_svo_tpu_torch import cli
    from stereo_svo_tpu_torch.engine.runner import StereoSvo
    from stereo_svo_tpu_torch.eval import ate
    from stereo_svo_tpu_torch.io import synthetic, trajectory

    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    traj_path = os.path.join(out_dir, "chip_smoke_cli.tum")
    metrics_path = os.path.join(out_dir, "chip_smoke_cli_metrics.json")
    syncs, sites = [], {}
    new_image = StereoSvo.new_image

    def counted(self, left, right):
        out, n, where = count_syncs(lambda: new_image(self, left, right))
        syncs.append(n)
        for key, v in where.items():
            sites[key] = sites.get(key, 0) + v
        return out

    zero_counters(counters)
    stdout, stderr = io.StringIO(), io.StringIO()
    StereoSvo.new_image = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(stderr):
            cli.main(["--dataset", "synthetic", "--frames", str(CLI_FRAMES),
                      "--loop-closure", "--metrics-out", metrics_path,
                      "--out", traj_path, "--device", "cuda"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        StereoSvo.new_image = new_image
    launches = read_counters(counters, "by the CLI")
    summary = json.loads(stdout.getvalue().strip().splitlines()[-1])
    require(set(summary) == CLI_SUMMARY_KEYS, f"summary keys {set(summary)}")
    with open(metrics_path) as f:
        doc = json.load(f)
    require(doc["summary"] == summary and
            len(doc["tracking_ok"]) == CLI_FRAMES,
            "the metrics file does not hold the summary and one entry per "
            "frame")
    lines = open(traj_path).read().splitlines()
    ts, pos = trajectory.load_tum(traj_path)
    gt = torch.stack([synthetic.trajectory_pose(
        torch.tensor(i * CLI_DT, dtype=torch.float32, device=device), "arc")
        for i in range(CLI_FRAMES)]).cpu().numpy()
    file_ate = ate.ate_rmse(pos, ate.positions(gt))
    out = {"argv": "--dataset synthetic --frames 60 --loop-closure "
                   "--metrics-out ... --out ... --device cuda",
           "summary": summary, "wall_seconds": wall_s,
           "progress_lines": stderr.getvalue().strip().splitlines(),
           "tum_lines": len(lines), "tum_ate_m": file_ate,
           "launches": launches,
           "launches_per_frame": {k: v / CLI_FRAMES
                                  for k, v in launches.items()},
           "host_syncs_per_frame": {str(c): syncs.count(c)
                                    for c in sorted(set(syncs))},
           "sync_sites": sites}
    require(summary["frames"] == CLI_FRAMES and len(syncs) == CLI_FRAMES,
            f"{summary['frames']} frames, {len(syncs)} new_image calls")
    require(syncs[0] == 0 and all(c == 1 for c in syncs[1:]),
            f"CLI host syncs per frame {syncs}: {sites}")
    require(summary["ate_rmse_m"] <= ATE_GATE_M,
            f"CLI ATE {summary['ate_rmse_m']} m above {ATE_GATE_M}")
    require(summary["tracking_ok_frac"] >= TRACK_GATE,
            f"CLI tracking_ok {summary['tracking_ok_frac']}")
    require(len(lines) == CLI_FRAMES and pos.shape == (CLI_FRAMES, 3)
            and np.allclose(ts, np.arange(CLI_FRAMES) * 0.1, atol=1e-6),
            "the TUM file does not hold one stamped line per frame")
    # the file keeps 6 decimals of each coordinate
    require(abs(file_ate - summary["ate_rmse_m"]) <= 2e-6,
            f"ATE of the TUM file {file_ate}, of the run "
            f"{summary['ate_rmse_m']}")
    return out


def resume_run(cfg, lefts, rights, traj3, counters):
    """Phase 10, second half: RESUME_AT frames, checkpoint.save, load into
    a fresh StereoSvo on the card, on to RESUME_FRAMES; the continued poses
    against the uninterrupted run's (phase 3's trajectory ``traj3``)."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.engine.runner import StereoSvo
    from stereo_svo_tpu_torch.utils import checkpoint, profiling

    path = os.path.join(ROOT, "build", "chip_smoke_checkpoint.npz")
    zero_counters(counters)
    first = StereoSvo(cfg, device="cuda")
    for i in range(RESUME_AT):
        first.new_image(lefts[i], rights[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save(path, first.state)
    save_ms = (time.perf_counter() - t0) * 1e3
    # the port's own harness on the card (CUDA events: the state is there)
    save_ms_time_fn = profiling.time_fn(checkpoint.save, path, first.state,
                                        iters=3, warmup=1) * 1e3
    resumed = StereoSvo(cfg, device="cuda")
    t0 = time.perf_counter()
    state = checkpoint.load(path, resumed.state)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    keys = checkpoint.key_paths(state)
    require(all(a.device.type == "cuda" and a.dtype == b.dtype
                and a.shape == b.shape
                for a, b in zip((v for _, v in checkpoint.flatten(state)),
                                (v for _, v in
                                 checkpoint.flatten(first.state)))),
            "the loaded state is not on the card with the saved dtypes")
    resumed.resume(state)
    for i in range(RESUME_AT, RESUME_FRAMES):
        resumed.new_image(lefts[i], rights[i])
    got = resumed.trajectory()
    launches = read_counters(counters, "by the checkpointed run")
    equal = bool(np.array_equal(got, traj3[RESUME_AT:RESUME_FRAMES]))
    out = {"frames_before": RESUME_AT, "frames_after":
           RESUME_FRAMES - RESUME_AT, "leaves": len(keys),
           "file_mb": os.path.getsize(path) / 2**20, "save_ms": save_ms,
           "save_ms_time_fn_median_of_3": save_ms_time_fn,
           "load_ms": load_ms, "launches": launches,
           "resumed_equals_phase3": equal,
           "max_abs_diff": float(np.abs(
               got - traj3[RESUME_AT:RESUME_FRAMES]).max())}
    require(equal, "the resumed run's poses differ from the uninterrupted "
                   f"run's (max {out['max_abs_diff']})")
    return out


def index_state(states, b: int):
    """Sequence b of a stacked (leading-B) state."""
    if isinstance(states, tuple):
        return type(states)(*(index_state(f, b) for f in states))
    return states[b]


def global_map_run(cfg, states, counters):
    """Phase 11: two sequences' final states as one global map, loop
    detection over it, then the pose graph and the sharded BA over an nccl
    process group of world size 1 on the card."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.backend import ba, pose_graph
    from stereo_svo_tpu_torch.geometry import se3
    from stereo_svo_tpu_torch.parallel import dist_ba, mapping
    from stereo_svo_tpu_torch.parallel import mesh as mesh_mod

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    zero_counters(counters)
    gmap = mapping.build_global_map(cfg, [index_state(states, b)
                                          for b in (0, 1)])
    K, N = cfg.max_keyframes, cfg.max_features
    require(tuple(gmap.kf_T_wk.shape) == (2 * K, 3, 4)
            and tuple(gmap.obs_uv.shape) == (2 * K, 2 * N, 2)
            and not bool(gmap.obs_mask[:K, N:].any())
            and not bool(gmap.obs_mask[K:, :N].any()),
            "the global map is not block-diagonal (20 poses, 384 landmarks)")
    (graph, meas), detect_ms = wall_ms(
        lambda: mapping.detect_loop_edges(cfg, gmap))
    detect_launches = {k: v for c in counters for k, v in c.items()}

    t0 = time.perf_counter()
    mesh_mod.initialize_multihost(device="cuda", world_size=1, rank=0)
    mesh = mesh_mod.make(1, axis_name="kf")
    init_ms = (time.perf_counter() - t0) * 1e3
    try:
        def optimize():
            return mapping.optimize_global_map(mesh, cfg.camera, cfg, gmap,
                                               loop_edges=graph)

        # the first call pays for the nccl communicator (made at the first
        # all-reduce) and the first jacfwd at this size; the second is warm
        (refined, pg_cost), first_ms = wall_ms(optimize)
        with watch_calls(pose_graph, "optimize", counters) as pg_calls, \
                watch_calls(dist_ba, "bundle_adjust_sharded",
                            counters) as ba_calls:
            (again, _), opt_ms = wall_ms(optimize)
            ba_args, ba_kwargs = ba_calls[-1]["args"], ba_calls[-1]["kwargs"]
        repeats = bool(torch.equal(again.kf_T_wk, refined.kf_T_wk)
                       and torch.equal(again.X, refined.X))
        # the map is built from stored thumbnails: no pyramid, so no B1
        launches = read_counters(counters, "by the global map",
                                 needs=("gradients", "sample_patches",
                                        "gn_accumulate"))
        opt_launches, opt_dev_ms = prof_stats(optimize)
        ba_launches, ba_dev_ms = prof_stats(
            lambda: dist_ba.bundle_adjust_sharded(*ba_args, **ba_kwargs))
        (T_ba, X_ba), ba_ms = wall_ms(
            lambda: dist_ba.bundle_adjust_sharded(*ba_args, **ba_kwargs))
    finally:
        mesh_mod.shutdown()

    # the same iterations in one process, no reduction
    _, cam, _, T_pg, valid, X, X_mask, obs_uv, obs_mask, disp, dmask = ba_args
    fixed = ba_kwargs["fixed_mask"]
    T_kw, X1 = se3.inverse(T_pg), X
    w_rows = ba.obs_weights(valid, X_mask, obs_mask, dmask)
    for _ in range(cfg.ba_iters):
        T_kw, X1, _ = ba.ba_iteration(cam, cfg, T_kw, X1, obs_uv,
                                      obs_uv[..., 0] - disp, w_rows, fixed,
                                      solver="direct")
    T_one = se3.inverse(T_kw)
    ba_diff = max(float((T_ba - T_one).abs().max()),
                  float((X_ba - X1).abs().max()))
    moved = [float(se3.distance(refined.kf_T_wk[k], gmap.kf_T_wk[k])[1])
             for k in torch.nonzero(gmap.kf_valid)[:, 0].tolist()]
    finite = bool(torch.isfinite(refined.kf_T_wk).all()
                  & torch.isfinite(refined.X).all()
                  & torch.isfinite(pg_cost))
    ev = lambda c: c["events"][0].elapsed_time(c["events"][1])  # noqa: E731
    out = {
        "sequences": [0, 1], "poses": 2 * K, "landmarks": 2 * N,
        "valid_keyframes": int(gmap.kf_valid.sum()),
        "live_landmarks": int(gmap.X_mask.sum()),
        "backend": "nccl", "world_size": 1,
        "multi_rank_nccl": "not run: this machine has one GPU; the "
                           "multi-rank check is the gloo CPU dry run of "
                           "tests/test_torch_parallel.py",
        "process_group_init_ms": init_ms,
        "loop_edges_accepted": int(graph.weight.sum()),
        "loop_edges_proposed": int(graph.weight.shape[0]),
        "detect_wall_ms": detect_ms, "detect_kernel_launches":
            detect_launches,
        "optimize_first_call_wall_ms": first_ms,
        "optimize_wall_ms": opt_ms, "optimize_repeats_bit_for_bit": repeats,
        "optimize_launches": opt_launches,
        "optimize_device_ms": opt_dev_ms,
        "pose_graph_host_ms": pg_calls[-1]["host_ms"],
        "pose_graph_event_ms": ev(pg_calls[-1]),
        "sharded_ba_host_ms": ba_calls[-1]["host_ms"],
        "sharded_ba_event_ms": ev(ba_calls[-1]),
        "sharded_ba_wall_ms": ba_ms, "sharded_ba_launches": ba_launches,
        "sharded_ba_device_ms": ba_dev_ms,
        "pose_graph_cost": float(pg_cost), "finite": finite,
        "max_keyframe_move_m": max(moved),
        "sharded_ba_vs_single_process_max_abs": ba_diff,
        "sharded_ba_bit_equal": bool(torch.equal(T_ba, T_one)
                                     and torch.equal(X_ba, X1)),
        "launches": launches}
    require(finite, "the refined map is not finite")
    require(max(moved) < MAP_MAX_MOVE_M,
            f"a keyframe moved {max(moved)} m (limit {MAP_MAX_MOVE_M})")
    require(ba_diff <= MAP_BA_TOL,
            f"sharded BA at world size 1 differs from the single-process "
            f"iterations by {ba_diff}")
    return out


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
        from stereo_svo_tpu_torch.engine import step as step_mod
        from stereo_svo_tpu_torch.engine.runner import StereoSvo
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
    seconds, clock = {}, [time.perf_counter(), "setup"]

    def mark(name):
        """Seconds since the previous mark go to the phase named then."""
        now = time.perf_counter()
        seconds[clock[1]] = now - clock[0]
        clock[:] = [now, name]

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

    # phase 7's sequence, and the keyframe thumbnail its edge measurements
    # align: the bootstrap keyframe's (level 2 of frame 0) with its
    # features' centres at thumbnail scale
    lcfg = SvoConfig(online_loop_every=1, **LOOP_KNOBS)
    t0 = time.perf_counter()
    l_lefts, l_rights, l_gt = synthetic.make_sequence(
        lcfg.camera, LOOP_FRAMES, LOOP_DT, kind="loop", seed=SEED,
        device=device)
    torch.cuda.synchronize()
    l_render_s = time.perf_counter() - t0
    boot = StereoSvo(lcfg, device="cuda")
    boot.new_image(l_lefts[0], l_rights[0])
    scale = 1.0 / 2 ** lcfg.thumb_level
    thumb = (boot.state.mem_thumb[0], boot.state.mem_uv[0] * scale,
             boot.state.mem_mask[0])
    require(tuple(thumb[0].shape) == (120, 188), f"{thumb[0].shape}")

    # ---- phase 2: kernels against plain versions ----
    mark("phase2")
    rows = check_kernels(device, lefts[0], k_lefts[0], thumb)

    # ---- phase 3: the main path, SvoConfig() as shipped ----
    mark("phase3")
    phase3, frame_ms, metrics, svo3 = drive(cfg, lefts, rights, gt,
                                            counters)
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
    mark("phase4")
    phase4, frame_ms, metrics, _ = drive(kcfg, k_lefts, k_rights, k_gt,
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
    mark("phase5")
    phase5, frame_ms, _, _ = drive(stress_config(), lefts, rights, gt,
                                   counters)
    phase5.update(config="stress_config()")
    emit("phase5", phase5)
    detail.update(phase5=phase5, phase5_frame_ms=frame_ms)
    require(phase5["ate_m"] <= ATE_GATE_M,
            f"stress ATE {phase5['ate_m']} m above {ATE_GATE_M}")
    require(phase5["tracking_ok"] >= TRACK_GATE,
            f"stress tracking_ok {phase5['tracking_ok']}")

    # ---- phase 6: affine-warped KLT templates ----
    mark("phase6")
    acfg = SvoConfig(klt_affine_warp=True)
    n6 = N_AFFINE_FRAMES
    phase6, frame_ms, _, _ = drive(acfg, lefts[:n6], rights[:n6], gt[:n6],
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

    # ---- phase 7: online and offline loop closure, EuRoC rig ----
    mark("phase7")
    phase7, svo7, calls = loop_run(lcfg, l_lefts, l_rights, l_gt, counters,
                                   device)
    phase7["refine"] = refine_run(lcfg, svo7, l_gt, counters)
    # one online-loop call (the last one's input) under torch.profiler:
    # CUDA launches and device ms; refine_trajectory's are profile_step.py's
    # "loop" line (a profile of its ~63,000 launches takes ~30 s)
    launches, dev_ms = prof_stats(
        lambda: step_mod.run_online_loop(lcfg, calls[-1]["args"][1]))
    phase7["loop_call"].update(profiled_launches=launches,
                               profiled_device_ms=dev_ms)
    phase7.update(config="SvoConfig(online_loop_every=1, kf_dist_ratio=0.05"
                         ", loop_min_gap=15, loop_min_score=0.75)",
                  scene="planes", traj="loop", dt=LOOP_DT,
                  inject_at=LOOP_INJECT_AT, drift=LOOP_DRIFT,
                  render_seconds=l_render_s, reference=PHASE7_REF,
                  tol_m=LOOP_TOL_M)
    detail["phase7_frame_ms"] = phase7.pop("frame_ms_all")
    emit("phase7", phase7)
    detail["phase7"] = phase7
    ref = PHASE7_REF
    require(phase7["kf_frames"] == ref["kf_frames"],
            f"keyframes {phase7['kf_frames']}, reference {ref['kf_frames']}")
    require(phase7["n_loop_closures"] == ref["n_loop_closures"],
            f"loop closures {phase7['n_loop_closures']}, reference "
            f"{ref['n_loop_closures']}")
    require(phase7["refine"]["offline_edges"] == ref["offline_edges"],
            f"offline edges {phase7['refine']['offline_edges']}, reference "
            f"{ref['offline_edges']}")
    for key in ("tail_err_m", "ate_m"):
        require(abs(phase7[key] - ref[key]) <= LOOP_TOL_M,
                f"{key} {phase7[key]}, reference {ref[key]}")
    require(phase7["tracking_ok"] == 1.0,
            f"tracking_ok {phase7['tracking_ok']}")
    require(phase7["loop_calls"] == len(ref["kf_frames"]) - 1,
            f"{phase7['loop_calls']} online-loop calls, want one per "
            f"keyframe after the bootstrap")

    # ---- phase 7b: a correction folded in, the test rig at 752x480 ----
    mark("phase7b")
    from stereo_svo_tpu_torch.config import CameraConfig
    rig = dict(camera=CameraConfig(**RIG_7B), max_keyframes=3,
               mem_keyframes=12, **LOOP_KNOBS)
    t0 = time.perf_counter()
    b_lefts, b_rights, b_gt = synthetic.make_sequence(
        rig["camera"], LOOP_FRAMES, LOOP_DT, kind="loop", seed=SEED,
        device=device)
    torch.cuda.synchronize()
    phase7b = {"render_seconds": time.perf_counter() - t0,
               "config": "SvoConfig(camera=CameraConfig(fx=760, fy=760, "
                         "cx=376, cy=240, baseline=0.25, width=752, "
                         "height=480), max_keyframes=3, mem_keyframes=12, "
                         "kf_dist_ratio=0.05, loop_min_gap=15, "
                         "loop_min_score=0.75)",
               "reference": PHASE7B_REF}
    for every, key in ((1, "online"), (0, "control")):
        bcfg = SvoConfig(online_loop_every=every, **rig)
        run, svo, _ = loop_run(bcfg, b_lefts, b_rights, b_gt, counters,
                               device)
        if every:
            run["refine"] = refine_run(bcfg, svo, b_gt, counters)
        detail[f"phase7b_{key}_frame_ms"] = run.pop("frame_ms_all")
        phase7b[key] = run
    emit("phase7b", phase7b)
    detail["phase7b"] = phase7b
    on, off = phase7b["online"], phase7b["control"]
    require(on["n_loop_closures"] == PHASE7B_REF["n_loop_closures"],
            f"loop closures {on['n_loop_closures']}, reference "
            f"{PHASE7B_REF['n_loop_closures']}")
    require(off["n_loop_closures"] == 0,
            f"{off['n_loop_closures']} loop closures in the control")
    require(on["tail_err_m"] < 0.75 * off["tail_err_m"],
            f"tail error {on['tail_err_m']} not below 0.75x the control's "
            f"{off['tail_err_m']}")
    require(on["refine"]["offline_edges"] == PHASE7B_REF["offline_edges"],
            f"offline edges {on['refine']['offline_edges']}, reference "
            f"{PHASE7B_REF['offline_edges']}")
    require(min(on["tracking_ok"], off["tracking_ok"]) >= TRACK_GATE,
            "phase 7b tracking_ok")
    del b_lefts, b_rights

    # ---- phase 8: batched-8 ----
    mark("phase8")
    phase8, states8 = batched_run(cfg, counters, device, svo3.trajectory())
    emit("phase8", phase8)
    detail["phase8"] = phase8

    # ---- phase 9: tracking loss and relocalisation ----
    mark("phase9")
    n9 = BLACKOUT_FRAMES
    phase9, frame_ms = blackout_run(SvoConfig(**BLACKOUT_KNOBS), l_lefts[:n9],
                                    l_rights[:n9], l_gt[:n9], counters)
    phase9.update(config="SvoConfig(kf_dist_ratio=0.05)", scene="planes",
                  traj="loop", dt=LOOP_DT, blackout=list(BLACKOUT),
                  reference=PHASE9_REF, tol_m=BLACKOUT_TOL_M)
    emit("phase9", phase9)
    detail.update(phase9=phase9, phase9_frame_ms=frame_ms)
    require(phase9["lost_frames"] == PHASE9_REF["lost_frames"]
            == list(BLACKOUT),
            f"tracking lost on {phase9['lost_frames']}, blacked out "
            f"{list(BLACKOUT)}")
    require(phase9["kf_frames"] == PHASE9_REF["kf_frames"],
            f"keyframes {phase9['kf_frames']}, reference "
            f"{PHASE9_REF['kf_frames']}")
    for key in ("tail_err_m", "ate_m"):
        require(abs(phase9[key] - PHASE9_REF[key]) <= BLACKOUT_TOL_M,
                f"{key} {phase9[key]}, reference {PHASE9_REF[key]}")
    # the variants are computed when the previous frame failed: on the
    # second and third blacked-out frames and on the recovery frame
    require(phase9["rotated_variant_calls"] == len(BLACKOUT),
            f"{phase9['rotated_variant_calls']} calls of the rotated "
            f"relocalisation variants, want {len(BLACKOUT)}")
    del l_lefts, l_rights

    # ---- phase 10: the CLI, then checkpoint and resume ----
    mark("phase10")
    phase10 = {"cli": cli_run(counters, device)}
    phase10["checkpoint"] = resume_run(cfg, lefts, rights,
                                       svo3.trajectory(), counters)
    emit("phase10", phase10)
    detail["phase10"] = phase10

    # ---- phase 11: the global map over an nccl group of one ----
    mark("phase11")
    phase11 = global_map_run(cfg, states8, counters)
    emit("phase11", phase11)
    detail["phase11"] = phase11
    mark("end")
    emit("seconds", seconds)
    detail["seconds"] = seconds

    # launches of each row's kernel on the path that gives it its shape
    paths = {"phase3": phase3, "phase4": phase4, "phase5": phase5,
             "phase6": phase6, "phase7": phase7}
    b1 = {k: p["launches_per_frame"]["halfsample"] for k, p in paths.items()}
    require(all(v == 1.0 for v in b1.values()),
            f"B1 launches per frame {b1}, not 1.0 (one per pyramid)")
    for row in rows:
        path = paths[row["path"]]
        row["launches"] = path["launches"][row["name"]]
        row["launches_per_frame"] = path["launches_per_frame"][row["name"]]
        if row.get("thumbnail"):
            row["launches_per_loop_call"] = \
                phase7["loop_call"]["launches_per_call"][row["name"]]
    emit("phase2_rows", {"rows": [
        {k: r.get(k) for k in ROW_SUMMARY} for r in rows]})
    detail["kernels"] = rows
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1)

    main_rows = {}
    for row in rows:                 # each kernel's first row: phase 3
        main_rows.setdefault(row["name"], row)
    by_path = {"phase3": phase3["launches"], "phase9": phase9["launches"],
               "phase10_cli": phase10["cli"]["launches"],
               "phase10_checkpoint": phase10["checkpoint"]["launches"],
               "phase11": phase11["launches"]}
    print(json.dumps({"kernels": [
        dict({k: r[k] for k in ("name", "route", "source", "replaces",
                                "launches", "max_abs_err", "max_rel_err",
                                "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "device_us", "host_us")},
             launches_by_path={p: v[r["name"]] for p, v in by_path.items()})
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
