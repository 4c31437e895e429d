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

Passes 1 and 2 run the eager step (engine/step.make_step, through
chip_smoke.EagerSvo). Then "graphed": the same frames through StereoSvo,
which launches the step's frame graph (engine/graphed.py) once a frame,
the bootstrap included: host-timed ms of the tracking and keyframe frames,
and for the same tracking frame and keyframe frame (each with the frame
before it in the profiler's warm-up step) the host's kernel launches,
graph launches and copies and the device ms under torch.profiler, with
the bodies' nodes by kind, body P's kernel nodes by kernel (the
pyramid: one B1 and one B2 node), the capture seconds and graph pool
MB; and "batched8": chip_smoke.py phase 8's eight sequences through the
graphed batched step (graphed.make_graphed_batched_step), host-timed
batched frames (synchronised around each), the aggregate frames/s of
their median, one batched frame under torch.profiler (the frame before
it in the warm-up step), the capture seconds and graph pool MB, graph
P's kernel nodes by kernel. Every profiled frame or call gives
chip_smoke.prof_launches' counts (host launches by kind, device ms,
device records of each hand-written kernel).

Then "loop": chip_smoke.py phase 7's run (online loop closure on the EuRoC
rig, the loop sequence, drift injected at frame 30) through the eager
step, so that each online-loop call is a Python call, and, on the input of
its last online-loop call and on its final state, the CUDA launches,
device ms and synchronised wall ms of one online-loop call and one
refine_trajectory call, and of their parts: the edge measurement
(loop_closure.measure_edges) and the pose graph (pose_graph.optimize).

Then "idle": StereoSvo (SvoConfig()) over phase 3's frames, 20 steady
frames from frame 40 with no sync between them, timed by CUDA events around
every graph launch and then under torch.profiler: per frame, the device's
busy time and its idle time inside graph windows (a launch's events) and
between them (chip_smoke.steady_split). ``--only idle`` runs that line alone;
``--tree DIR`` imports the package from another checkout (unpacked with
``git archive``), so the same measurement reads another commit's step:

    python3 profile_step.py --only idle --tree build/parent \
        --out build/idle_parent.json

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


def loop_profile(dev):
    """The "loop" line: an online-loop call and a refine_trajectory call,
    whole and in parts (see the module docstring)."""
    import torch
    import chip_smoke
    from stereo_svo_tpu_torch.backend import loop_closure, pose_graph
    from stereo_svo_tpu_torch.config import SvoConfig
    from stereo_svo_tpu_torch.engine import step as step_mod
    from stereo_svo_tpu_torch.geometry import se3
    from stereo_svo_tpu_torch.io import synthetic
    from stereo_svo_tpu_torch.ops.kernels import align_kernel, pyramid_kernel

    cfg = SvoConfig(online_loop_every=1, **chip_smoke.LOOP_KNOBS)
    lefts, rights, gt = synthetic.make_sequence(
        cfg.camera, chip_smoke.LOOP_FRAMES, chip_smoke.LOOP_DT, kind="loop",
        seed=chip_smoke.SEED, device=dev)
    D = se3.exp(torch.tensor(chip_smoke.LOOP_DRIFT, device=dev))

    def inject(i, svo):
        if i == chip_smoke.LOOP_INJECT_AT:
            svo.state = chip_smoke.inject_world_offset(svo.state, D)

    counters = (pyramid_kernel.LAUNCHES, align_kernel.LAUNCHES)
    with chip_smoke.watch_calls(step_mod, "run_online_loop",
                                counters) as calls:
        _, _, _, svo = chip_smoke.drive(cfg, lefts, rights, gt, counters,
                                        before_frame=inject,
                                        make_svo=chip_smoke.EagerSvo,
                                        want=(0, 1))
    st = calls[-1]["args"][1]
    traj = svo.trajectory()

    def parts(fn):
        """(fn's stats, {part: stats}) — each part's arguments captured
        from one call of fn, then the part profiled alone."""
        seen = {}
        originals = {"measure_edges": (loop_closure, loop_closure.measure_edges),
                     "optimize": (pose_graph, pose_graph.optimize)}

        def capture(name, f):
            def wrapped(*a, **k):
                seen[name] = (a, k)
                return f(*a, **k)
            return wrapped

        for name, (mod, f) in originals.items():
            setattr(mod, name, capture(name, f))
        try:
            fn()
        finally:
            for name, (mod, f) in originals.items():
                setattr(mod, name, f)
        out = {"whole": stats(fn)}
        for name, (mod, f) in originals.items():
            a, k = seen[name]
            out[name] = stats(lambda: f(*a, **k))
        return out

    def stats(fn):
        fn()                              # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        return dict(chip_smoke.prof_launches(fn), wall_ms=wall)

    return {"online_loop_call": parts(
                lambda: step_mod.run_online_loop(cfg, st)),
            "refine_trajectory": parts(
                lambda: loop_closure.refine_trajectory(cfg, svo.state,
                                                       traj)),
            "loop_calls": len(calls)}


def batched_profile(dev):
    """The "batched8" entry of the "graphed" line (see the module
    docstring)."""
    import torch
    import chip_smoke
    from stereo_svo_tpu_torch.config import SvoConfig
    from stereo_svo_tpu_torch.engine import graphed
    from stereo_svo_tpu_torch.io import synthetic

    cfg, B, T = SvoConfig(), chip_smoke.BATCH, chip_smoke.BATCH_FRAMES
    seqs = [synthetic.make_sequence(cfg.camera, T, chip_smoke.DT, kind="arc",
                                    seed=b, device=dev) for b in range(B)]
    lefts = torch.stack([q[0] for q in seqs])
    rights = torch.stack([q[1] for q in seqs])
    bstep = graphed.make_graphed_batched_step(cfg, B, dev)

    def frame(t):
        bstep(bstep.state, lefts[:, t], rights[:, t])

    t_prof = T // 2
    ms, out = [], {}
    for t in range(T):
        if t == t_prof - 1:
            continue                        # the profile's warm-up step
        if t == t_prof:
            out["batched_frame"] = (t, chip_smoke.prof_launches(
                lambda: frame(t), warmup=lambda: frame(t - 1)))
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame(t)
        torch.cuda.synchronize()
        ms.append((t, (time.perf_counter() - t0) * 1e3))
    steady = [m for t, m in ms if t > 0]
    out.update(batch=B, frames=T, batched_frame_ms=steady,
               batched_frame_ms_median=statistics.median(steady),
               fps_aggregate_of_median=B * 1e3 / statistics.median(steady),
               replays=bstep.replays, capture_seconds=bstep.capture_seconds,
               graph_pool_mb=bstep.pool_bytes / 2**20, nodes=bstep.nodes,
               graph_P_kernel_nodes=bstep.kernel_nodes["P"])
    return out


def idle_profile(dev, trace_path):
    """The "idle" line: StereoSvo over chip_smoke.py phase 3's frames up to
    frame chip_smoke.SCAN_PROFILE_AT, then SCAN_PROFILE_FRAMES steady
    frames with no sync between them, timed by CUDA events around every
    graph launch and then under torch.profiler: per frame, the frame's ms,
    the device's busy ms and idle ms inside graph windows and between
    them (chip_smoke.steady_split)."""
    import torch
    import chip_smoke
    from stereo_svo_tpu_torch.config import SvoConfig
    from stereo_svo_tpu_torch.engine import runner
    from stereo_svo_tpu_torch.io import synthetic

    cfg = SvoConfig()
    a0, n = chip_smoke.SCAN_PROFILE_AT, chip_smoke.SCAN_PROFILE_FRAMES
    lefts, rights, _ = synthetic.make_sequence(
        cfg.camera, a0 + n, chip_smoke.DT, kind="arc", seed=chip_smoke.SEED,
        device=dev)
    svo = {}

    def drive_to():
        svo["step"] = runner.StereoSvo(cfg, device="cuda")
        for t in range(a0 - 1):
            svo["step"].new_image(lefts[t], rights[t])

    def window():
        for t in range(a0, a0 + n):
            svo["step"].new_image(lefts[t], rights[t])
    out = chip_smoke.steady_split(
        drive_to, lambda: svo["step"].new_image(lefts[a0 - 1],
                                                rights[a0 - 1]),
        window, n, trace_path)
    kf = svo["step"].metrics()["kf_inserted"][a0:].tolist()
    return dict(out, first_frame=a0, keyframes_in_window=int(sum(kf)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "profile_step.json"))
    ap.add_argument("--only", choices=["idle"],
                    help="run only the named line")
    ap.add_argument("--tree", help="import stereo_svo_tpu_torch from this "
                                   "checkout (another commit's tree) "
                                   "instead of this one's")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: profile_step.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import bench_torch
    import chip_smoke
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    import stereo_svo_tpu_torch  # noqa: F401  (sets the TF32 flags)
    dev = torch.device("cuda")
    # the trace (tens of MB) goes to build/, beside the kernels
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    trace = os.path.join(ROOT, "build", "profile_step_idle_trace.json")
    if args.only == "idle":
        print(bench_torch.device_line(dev), flush=True)
        results = {"idle": dict(idle_profile(dev, trace),
                                package=stereo_svo_tpu_torch.__file__)}
        print("idle", json.dumps(results["idle"]), flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        return 0
    from stereo_svo_tpu_torch.config import (SvoConfig, kitti_config,
                                             stress_config)
    from stereo_svo_tpu_torch.engine import runner
    from stereo_svo_tpu_torch.engine import step as step_mod
    from stereo_svo_tpu_torch.io import synthetic

    n = N_FRAMES
    print(bench_torch.device_line(dev), flush=True)
    lefts, rights, _ = synthetic.make_sequence(
        SvoConfig().camera, n, chip_smoke.DT, kind="arc",
        seed=chip_smoke.SEED, device=dev)
    k_lefts, k_rights, _ = bench_torch.render_sequence(
        kitti_config().camera, n, "road", "kitti", seed=chip_smoke.SEED,
        dt=chip_smoke.DT, device=dev)
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
            ba["prof"].append(chip_smoke.prof_launches(
                lambda: box.append(run_window_ba(cfg, st))))
            return box[0]
        return run_window_ba(cfg, st)

    step_mod.run_window_ba = timed_ba
    results = {}
    try:
        for name, cfg, L, R in configs:     # pass 1: no profiler yet
            ba.update(mode="time", ms=[])
            svo = chip_smoke.EagerSvo(cfg, device="cuda")
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
            svo = chip_smoke.EagerSvo(cfg, device="cuda")
            for i in range(n):
                ba["mode"] = "profile" if i == ba_frame else "plain"
                if i in (t_frame, kf_frame):
                    key = "track_frame" if i == t_frame else "kf_frame"
                    r[key] = (i, chip_smoke.prof_launches(
                        lambda: svo.new_image(L[i], R[i])))
                else:
                    svo.new_image(L[i], R[i])
            r["ba_call"] = ba["prof"][0] if ba["prof"] else None
            print(name, json.dumps(r), flush=True)
        ba["mode"] = "plain"
        graphed = {}
        for name, cfg, L, R in configs:     # the graphed step
            r = results[name]
            prof_frames = {r["track_frame"][0]: "track_frame"}
            if r.get("kf_frame"):
                prof_frames[r["kf_frame"][0]] = "kf_frame"
            svo = runner.StereoSvo(cfg, device="cuda")
            ms, g = [], {}
            for i in range(n):
                if i + 1 in prof_frames and i not in prof_frames:
                    continue                # the profile's warm-up step
                if i in prof_frames:
                    warm = ((lambda i=i: svo.new_image(L[i - 1], R[i - 1]))
                            if i - 1 not in prof_frames else None)
                    g[prof_frames[i]] = (i, chip_smoke.prof_launches(
                        lambda i=i: svo.new_image(L[i], R[i]), warmup=warm))
                    continue
                torch.cuda.synchronize()
                t = time.perf_counter()
                svo.new_image(L[i], R[i])
                torch.cuda.synchronize()
                ms.append((i, (time.perf_counter() - t) * 1e3))
            kf = svo.metrics()["kf_inserted"].tolist()
            g.update(
                track_ms_median=statistics.median(
                    [m for i, m in ms if i > 0 and not kf[i]]),
                kf_ms=[m for i, m in ms if i > 0 and kf[i]],
                kf_frames=[i for i in range(n) if kf[i]],
                graph_nodes=svo._step.nodes,
                graph_P_kernel_nodes=svo._step.kernel_nodes["P"],
                capture_seconds=svo._step.capture_seconds,
                graph_pool_mb=svo._step.pool_bytes / 2**20)
            graphed[name] = g
        graphed["batched8"] = batched_profile(dev)
        results["graphed"] = graphed
        print("graphed", json.dumps(graphed), flush=True)
    finally:
        step_mod.run_window_ba = run_window_ba
    results["loop"] = loop_profile(dev)
    print("loop", json.dumps(results["loop"]), flush=True)
    results["idle"] = idle_profile(dev, trace)
    print("idle", json.dumps(results["idle"]), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
