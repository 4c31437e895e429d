#!/usr/bin/env python3
"""Per-configuration profile of the PyTorch/CUDA port's step on one GPU.

Run from the repository root:
    python3 profile_step.py [--out build/profile_step.json]

For each configuration that config.py ships (SvoConfig() with and without
window BA, kitti_config(), stress_config(), SvoConfig(klt_affine_warp=True)),
over the first 40 frames of chip_smoke.py's sequences (arc/planes at
752×480; road/kitti at 1241×376 with 2×2 anti-aliasing):

  pass 1, no profiler: host-timed ms of every frame (synchronised around
          each frame), the keyframe frames, and the ms of each window-BA
          call (synchronised around the call);
  pass 2, a fresh run: CUDA launches and device ms under torch.profiler of
          one tracking frame (the first non-keyframe frame from frame 5),
          one keyframe frame (the second keyframe after the bootstrap) and
          one window-BA call (the first keyframe after the bootstrap).

Prints one line per configuration, "<name> {json}", then writes all of
them to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 40          # two keyframes after the bootstrap on KITTI/stress
LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
               "cuLaunchKernelEx")


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "profile_step.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: profile_step.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    import stereo_svo_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from stereo_svo_tpu_torch.config import (SvoConfig, kitti_config,
                                             stress_config)
    from stereo_svo_tpu_torch.engine import runner
    from stereo_svo_tpu_torch.engine import step as step_mod
    from stereo_svo_tpu_torch.io import synthetic

    n, dev = N_FRAMES, torch.device("cuda")
    print(chip_smoke.nvidia_smi_line(), flush=True)
    lefts, rights, _ = synthetic.make_sequence(
        SvoConfig().camera, n, chip_smoke.DT, kind="arc",
        seed=chip_smoke.SEED, device=dev)
    k_lefts, k_rights, _ = chip_smoke.render_kitti_road(
        kitti_config().camera, n, dev)
    configs = (("default", SvoConfig(), lefts, rights),
               ("default_no_ba", SvoConfig(use_ba=False), lefts, rights),
               ("kitti", kitti_config(), k_lefts, k_rights),
               ("stress", stress_config(), lefts, rights),
               ("affine", SvoConfig(klt_affine_warp=True), lefts, rights))

    # kf_phase looks run_window_ba up in its module at each call
    run_window_ba = step_mod.run_window_ba
    ba = {"mode": "time", "ms": [], "prof": []}

    def timed_ba(cfg, st):
        if ba["mode"] == "time":
            torch.cuda.synchronize()
            t = time.perf_counter()
            st = run_window_ba(cfg, st)
            torch.cuda.synchronize()
            ba["ms"].append((time.perf_counter() - t) * 1e3)
            return st
        if ba["mode"] == "profile":
            box = []
            ba["prof"].append(prof_stats(
                lambda: box.append(run_window_ba(cfg, st))))
            return box[0]
        return run_window_ba(cfg, st)

    step_mod.run_window_ba = timed_ba
    results = {}
    try:
        for name, cfg, L, R in configs:     # pass 1: no profiler yet
            ba.update(mode="time", ms=[])
            svo = runner.StereoSvo(cfg, device="cuda")
            ms = []
            for i in range(n):
                torch.cuda.synchronize()
                t = time.perf_counter()
                svo.new_image(L[i], R[i])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            kf = svo.metrics()["kf_inserted"].tolist()
            results[name] = dict(
                track_ms_median=statistics.median(
                    [ms[i] for i in range(1, n) if not kf[i]]),
                kf_ms=[ms[i] for i in range(1, n) if kf[i]],
                ba_ms=list(ba["ms"]),
                kf_frames=[i for i in range(n) if kf[i]])
        for name, cfg, L, R in configs:     # pass 2: profiled frames
            r = results[name]
            kf_after = [i for i in r["kf_frames"] if i > 0]
            ba_frame = kf_after[0] if kf_after else None
            kf_frame = kf_after[1] if len(kf_after) > 1 else None
            t_frame = next(i for i in range(5, n) if i not in r["kf_frames"])
            ba.update(prof=[])
            svo = runner.StereoSvo(cfg, device="cuda")
            for i in range(n):
                ba["mode"] = "profile" if i == ba_frame else "plain"
                if i in (t_frame, kf_frame):
                    key = "track_frame" if i == t_frame else "kf_frame"
                    r[key] = (i,) + prof_stats(
                        lambda: svo.new_image(L[i], R[i]))
                else:
                    svo.new_image(L[i], R[i])
            r["ba_call"] = ba["prof"][0] if ba["prof"] else None
            print(name, json.dumps(r), flush=True)
    finally:
        step_mod.run_window_ba = run_window_ba
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
