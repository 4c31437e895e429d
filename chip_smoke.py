#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stereo_svo_tpu_torch) once on one GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, one result line each, in order:
  0. device: CUDA required; card name, nvidia-smi name and power limit,
     torch/CUDA versions, the TF32 flags;
  1. build: the CUDA kernels from csrc/, timed;
  2. kernels: each of B1-B4 against its plain PyTorch version on the card
     at main-path shapes (752×480 pyramid, N=192 features), with errors and
     median CUDA-event times over 60 runs; then at the other paths'
     shapes: B1/B2 on every level of a 1241×376 (KITTI) and a 5-level
     752×480 (stress) pyramid, exactly; B3 at the epipolar-search shape
     (3,840 centres, P=8, 620×188), the affine-KLT big-template shape
     (N=192, P=16) and the KLT shapes N=240 (KITTI) and N=2048 (stress),
     P=8; B4 at N=240 (KITTI level 0) and N=2048 (stress level 1), P=4;
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
Then the kernels JSON line (launches from phase 3), the nvidia-smi line,
and last
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


def check_kernels(device, frame, kitti_frame, detail):
    """Phase 2: each kernel against its plain version at main-path shapes
    (one row per kernel, returned), then at the variants' shapes (rows in
    ``detail["kernel_shapes"]``)."""
    import torch
    from stereo_svo_tpu_torch.ops.kernels import _build
    from stereo_svo_tpu_torch.ops.kernels import align_kernel as ak
    from stereo_svo_tpu_torch.ops.kernels import pyramid_kernel as pk

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    img = frame.contiguous()
    H, W = img.shape
    rows, shape_rows = [], []

    def record(name, kernel, plain, tol_abs, tol_rel, extra=None,
               main=True):
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
        require(ok, f"{name} {extra}: kernel disagrees with its plain "
                    f"version (abs {err_abs}, rel {err_rel})")
        (rows if main else shape_rows).append(row)

    def exact_pyramid(top, levels, what):
        """B1/B2 on every level of a pyramid: bit for bit."""
        lv, shapes = top.contiguous(), []
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
        return shapes

    # B1 / B2 over the whole 752x480 pyramid; timed at level 0
    exact_pyramid(img, 4, "752x480")
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

    def gn_case(image, N, extra, main=True):
        """B4 at N features, P=4, on ``image`` with (a, b) != (1, 0) and a
        per-pixel mask. The number of pass-1 blocks grows with N (up to
        128 at N=2048), so each path's N is checked."""
        P = 4
        h, w = image.shape
        uv_in = (torch.rand(N, 2, generator=gen)
                 * torch.tensor([w - 8.0, h - 8.0]) + 4.0).to(device)
        cur = ak.sample_patches_plain(image, uv_in, P)
        ab = torch.tensor([1.3, -7.0], device=device)
        tmpl = ((cur - ab[1]) / ab[0]
                + 6.0 * torch.randn(cur.shape, generator=gen).to(device))
        jac = torch.randn(N, P * P, 6, generator=gen).to(device) * 50.0
        mask = (torch.rand(N, P * P, generator=gen) > 0.2).float().to(device)
        args = (image, uv_in, tmpl.contiguous(), jac, mask, P, 8.0, ab)
        kern = ak.gn_accumulate(*args)
        plain = ak.gn_accumulate_plain(*args)
        for a, b, name in zip(kern[3:], plain[3:], ("n_eff", "n_inl")):
            require(float(a) == float(b), f"gn_accumulate N={N} {name}: "
                                          f"{float(a)} vs {float(b)}")
        again = ak.gn_accumulate(*args)
        require(all(torch.equal(a, b) for a, b in zip(kern, again)),
                f"gn_accumulate N={N} is not bit-reproducible")
        # H, g, cost: float32 sums of N·16 terms in two orders, so the
        # error is judged relative to each output's largest entry
        record("gn_accumulate", lambda: ak.gn_accumulate(*args)[:3],
               lambda: ak.gn_accumulate_plain(*args)[:3], 0.0, 1e-4,
               {"N": N, "P": P, "image": [h, w], "a_b": [1.3, -7.0],
                "pass1_blocks": _build.load_library().svo_gn_blocks(N, P),
                "bit_reproducible": True, **extra}, main=main)

    def patch_case(image, N, P, extra):
        """B3 at N centres spread over ``image`` and 2 px beyond it."""
        h, w = image.shape
        uv_n = (torch.rand(N, 2, generator=gen)
                * torch.tensor([w + 4.0, h + 4.0]) - 2.0).to(device)
        record("sample_patches", lambda: ak.sample_patches(image, uv_n, P),
               lambda: ak.sample_patches_plain(image, uv_n, P), 1e-3, 1e-5,
               {"N": N, "P": P, "image": [h, w], **extra}, main=False)

    # B4 at N=192 on level 0
    gn_case(img, 192, {})

    # ---- the variants' shapes ----
    kitti = kitti_frame.contiguous()
    kitti_levels = exact_pyramid(kitti, 4, "1241x376")
    stress_levels = exact_pyramid(img, 5, "752x480 5-level")
    emit("phase2_pyramids", {"kitti_levels": kitti_levels,
                             "stress_levels": stress_levels, "exact": True})
    kh, kw = kitti.shape
    record("halfsample", lambda: pk.halfsample(kitti),
           lambda: pk.halfsample_plain(kitti), 0.0, 0.0,
           {"shape": [kh, kw]}, main=False)
    record("gradients", lambda: pk.gradients(kitti),
           lambda: pk.gradients_plain(kitti), 0.0, 0.0,
           {"shape": [kh, kw]}, main=False)
    # epipolar search: 240 seeds x 16 probes on KITTI level 1 (620x188)
    patch_case(pk.halfsample(kitti), 240 * 16, 8, {"use": "epipolar probes"})
    # affine KLT: oversized 16x16 templates at N=192 on the 752x480 level
    record("sample_patches", lambda: ak.sample_patches(img, uv, 16),
           lambda: ak.sample_patches_plain(img, uv, 16), 1e-3, 1e-5,
           {"N": 192, "P": 16, "image": [H, W], "use": "big templates"},
           main=False)
    # KLT at the KITTI (240 slots) and stress (2048 slots) widths
    patch_case(kitti, 240, 8, {"use": "KITTI KLT"})
    patch_case(img, 2048, 8, {"use": "stress KLT"})
    # alignment's refresh pass at those widths: KITTI level 0, stress
    # level 1 (its finest alignment level)
    gn_case(kitti, 240, {"use": "KITTI alignment"}, main=False)
    gn_case(pk.halfsample(img), 2048, {"use": "stress alignment"},
            main=False)
    detail["kernel_shapes"] = shape_rows
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
    rows = check_kernels(device, lefts[0], k_lefts[0], detail)

    # ---- phase 3: the main path, SvoConfig() as shipped ----
    phase3, frame_ms, metrics = drive(cfg, lefts, rights, gt, counters)
    launches = phase3["launches"]
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
