#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stereo_svo_tpu_torch) once on one GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, one result line each, in order:
  0. device: CUDA required; card name, nvidia-smi name and power limit,
     torch/CUDA versions, the TF32 flags;
  1. build: the CUDA kernels from csrc/, timed;
  2. kernels: each of B1-B4 against its plain PyTorch version on the card
     at main-path shapes (752×480 pyramid, N=192 features), with errors and
     median CUDA-event times over 50+ runs;
  3. main path: the 100-frame synthetic arc sequence (752×480, dt 0.08,
     seed 0) rendered on the card, through StereoSvo(SvoConfig() with
     use_ba=False, device="cuda").new_image; launch counters, ATE and
     tracking gates, per-frame time, host syncs per frame.
Then the kernels JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure exits non-zero with no ok line.
Extra detail (build log, per-frame times) goes to build/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FRAMES, DT, SEED = 100, 0.08, 0
ATE_GATE_M, TRACK_GATE = 0.02, 0.99        # bench.py:54-55
N_TIMED = 60                               # kernel timing repetitions
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


class SmokeFailure(RuntimeError):
    pass


def emit(tag: str, payload: dict) -> None:
    print(f"{tag} {json.dumps(payload, sort_keys=True)}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, n: int = N_TIMED, warmup: int = 5) -> float:
    """Median milliseconds of ``fn()`` over ``n`` runs, by CUDA events."""
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


def check_kernels(device, frame):
    """Phase 2: each kernel against its plain version at main-path shapes.
    Returns the JSON rows (launches filled in later)."""
    import torch
    from stereo_svo_tpu_torch.ops.kernels import align_kernel as ak
    from stereo_svo_tpu_torch.ops.kernels import pyramid_kernel as pk

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    img = frame.contiguous()
    H, W = img.shape
    rows = []

    def record(name, kernel, plain, tol_abs, tol_rel, extra=None):
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err_abs, err_rel = _max_err(out, ref)
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        ok = err_abs <= tol_abs or err_rel <= tol_rel
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": TPU_KERNELS[name], "launches": None,
               "max_abs_err": err_abs, "max_rel_err": err_rel,
               "tol_abs": tol_abs, "tol_rel": tol_rel, "ms": ms,
               "plain_ms": plain_ms, **(extra or {})}
        emit("phase2", row)
        require(ok, f"{name}: kernel disagrees with its plain version "
                    f"(abs {err_abs}, rel {err_rel})")
        rows.append(row)

    # B1 / B2 over the whole 752x480 pyramid; timed at level 0
    lv = img
    for level in range(4):
        half = pk.halfsample(lv)
        for a, b in zip((half,) + pk.gradients(lv),
                        (pk.halfsample_plain(lv),) + pk.gradients_plain(lv)):
            e = _max_err(a, b)[0]
            require(e == 0.0, f"pyramid level {level}: max error {e}")
        lv = half
    # the same additions in the same order, no fused multiply-add: exact
    record("halfsample", lambda: pk.halfsample(img),
           lambda: pk.halfsample_plain(img), 0.0, 0.0,
           {"shape": [H, W], "all_levels_exact": True})
    record("gradients", lambda: pk.gradients(img),
           lambda: pk.gradients_plain(img), 0.0, 0.0, {"shape": [H, W]})

    # B3 at N=192 (interior and border centres), P=4 and P=8
    n_border = 48
    uv = torch.rand(192, 2, generator=gen) * torch.tensor([W - 1.0, H - 1.0])
    edge = torch.rand(n_border, 2, generator=gen) * 5.0 - 3.0
    uv[:n_border // 2] = edge[:n_border // 2]
    uv[n_border // 2:n_border] = (torch.tensor([W - 1.0, H - 1.0])
                                  + edge[n_border // 2:])
    uv = uv.to(device)
    p4 = _max_err(ak.sample_patches(img, uv, 4),
                  ak.sample_patches_plain(img, uv, 4))
    ms4 = cuda_ms(lambda: ak.sample_patches(img, uv, 4))
    # separate multiplies and adds on both sides (-fmad=false): a few ulp
    record("sample_patches", lambda: ak.sample_patches(img, uv, 8),
           lambda: ak.sample_patches_plain(img, uv, 8), 1e-3, 1e-5,
           {"N": 192, "P": 8, "border_centres": n_border,
            "P4_max_abs_err": p4[0], "P4_ms": ms4})

    # B4 at N=192, P=4 on level 0 with (a, b) != (1, 0), per-pixel mask
    P = 4
    uv_in = (torch.rand(192, 2, generator=gen)
             * torch.tensor([W - 8.0, H - 8.0]) + 4.0).to(device)
    cur = ak.sample_patches_plain(img, uv_in, P)
    ab = torch.tensor([1.3, -7.0], device=device)
    tmpl = ((cur - ab[1]) / ab[0]
            + 6.0 * torch.randn(cur.shape, generator=gen).to(device))
    jac = torch.randn(192, P * P, 6, generator=gen).to(device) * 50.0
    mask = (torch.rand(192, P * P, generator=gen) > 0.2).float().to(device)
    args = (img, uv_in, tmpl.contiguous(), jac, mask, P, 8.0, ab)
    kern = ak.gn_accumulate(*args)
    plain = ak.gn_accumulate_plain(*args)
    for a, b, name in zip(kern[3:], plain[3:], ("n_eff", "n_inl")):
        require(float(a) == float(b), f"gn_accumulate {name}: "
                                      f"{float(a)} vs {float(b)}")
    again = ak.gn_accumulate(*args)
    require(all(torch.equal(a, b) for a, b in zip(kern, again)),
            "gn_accumulate is not bit-reproducible")
    # H, g, cost: float32 sums of 3,072 terms in two orders, so the error
    # is judged relative to each output's largest entry
    record("gn_accumulate", lambda: ak.gn_accumulate(*args)[:3],
           lambda: ak.gn_accumulate_plain(*args)[:3], 0.0, 1e-4,
           {"N": 192, "P": P, "a_b": [1.3, -7.0], "bit_reproducible": True})
    return rows


def count_syncs(cfg, lefts, rights, n: int = 12):
    """Host syncs per frame over the first ``n`` frames (a separate run):
    every synchronising CUDA call warns under sync debug mode."""
    import torch
    from stereo_svo_tpu_torch.engine.runner import StereoSvo
    svo = StereoSvo(cfg, device="cuda")
    per_frame, sites = [], {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for i in range(n):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                svo.new_image(lefts[i], rights[i])
            hits = [w for w in caught if "synchroniz" in str(w.message)]
            per_frame.append(len(hits))
            for w in hits:
                key = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                sites[key] = sites.get(key, 0) + 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return per_frame, sites


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
        from stereo_svo_tpu_torch.config import SvoConfig
        from stereo_svo_tpu_torch.engine.runner import StereoSvo
        from stereo_svo_tpu_torch.eval import ate
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

    # ---- render the sequence on the card ----
    cfg = dataclasses.replace(SvoConfig(), use_ba=False)
    t0 = time.perf_counter()
    lefts, rights, gt = synthetic.make_sequence(cfg.camera, N_FRAMES, dt=DT,
                                                seed=SEED, device=device)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    require(tuple(lefts.shape) == (N_FRAMES, 480, 752), f"{lefts.shape}")

    # ---- phase 2: kernels against plain versions ----
    rows = check_kernels(device, lefts[0])

    # ---- phase 3: the main path ----
    syncs, sync_sites = count_syncs(cfg, lefts, rights)
    for counts in (pk.LAUNCHES, ak.LAUNCHES):
        for k in counts:
            counts[k] = 0
    svo = StereoSvo(cfg, device="cuda")
    frame_ms = []
    torch.cuda.synchronize()
    t_wall = time.perf_counter()
    for i in range(N_FRAMES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        svo.new_image(lefts[i], rights[i])
        b.record()
        frame_ms.append((a, b))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t_wall
    launches = {**pk.LAUNCHES, **ak.LAUNCHES}
    frame_ms = [a.elapsed_time(b) for a, b in frame_ms]

    traj, metrics = svo.trajectory(), svo.metrics()
    import numpy as np
    require(traj.shape == (N_FRAMES, 3, 4) and np.isfinite(traj).all(),
            "trajectory must be finite (N,3,4)")
    err = ate.ate_rmse(ate.positions(traj), ate.positions(gt.cpu().numpy()))
    track = float(np.mean(metrics["tracking_ok"]))
    steady = frame_ms[1:]
    q = statistics.quantiles(steady, n=10)
    phase3 = {
        "frames": N_FRAMES, "image": [480, 752], "config": "SvoConfig(), "
        "use_ba=False", "ate_m": err, "tracking_ok": track,
        "keyframes": int(metrics["kf_inserted"].sum()),
        "frame_ms_median": statistics.median(steady), "frame_ms_p90": q[8],
        "fps": 1000.0 * len(steady) / sum(steady),
        "fps_wall_incl_first": N_FRAMES / wall_s,
        "first_frame_ms": frame_ms[0],
        "host_syncs_per_frame": syncs, "sync_sites": sync_sites,
        "launches": launches,
        "launches_per_frame": {k: v / N_FRAMES for k, v in launches.items()},
        "render_seconds": render_s,
        "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2**20,
    }
    emit("phase3", phase3)
    detail.update(phase0=phase0, phase3=phase3, frame_ms=frame_ms,
                  n_tracked=metrics["n_tracked"].tolist())
    missing = [k for k, v in launches.items() if v <= 0]
    require(not missing, f"kernels never launched on the main path: {missing}")
    require(err <= ATE_GATE_M, f"ATE {err} m above {ATE_GATE_M}")
    require(track >= TRACK_GATE, f"tracking_ok {track} below {TRACK_GATE}")

    for row in rows:
        row["launches"] = launches[row["name"]]
    detail["kernels"] = rows
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1)

    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms")} for r in rows]}))
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
