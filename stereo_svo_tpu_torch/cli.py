"""Command-line app: run the SVO engine over a dataset, export trajectory.

Reference parity: the main CLI app — parse args, construct the input
reader, loop frames through the engine, export the trajectory, report fps
(SURVEY.md §2.1 "Main CLI app", §3.4; src/app/main.cpp [UNVERIFIED]).
The Qt viewer is intentionally replaced by optional overlay dumps
(SURVEY.md §5.5, §7.4).

Port of ``stereo_svo_tpu/cli.py``: the same flags and the same summary,
plus ``--device`` (``cuda`` by default; the CPU only when asked for). The
synthetic dataset is rendered on the chosen device. The EuRoC, KITTI and
video readers decode on the host with OpenCV (and PyYAML for calibration
files) and raise where those packages are missing.

Usage:
  python -m stereo_svo_tpu_torch.cli --dataset euroc --root <dir> --out traj.tum
  python -m stereo_svo_tpu_torch.cli --dataset kitti --root <dir> --seq 00
  python -m stereo_svo_tpu_torch.cli --dataset synthetic --frames 100
  python -m stereo_svo_tpu_torch.cli --dataset synthetic --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .config import SvoConfig, euroc_config, kitti_config
from .device import resolve
from .engine.runner import StereoSvo
from .eval import ate as ate_mod
from .io import calib, datasets, synthetic, trajectory


def _frame_source(args, cfg, device):
    """Returns (cfg, frame iterator, gt poses or None)."""
    if args.dataset == "euroc":
        rect = None
        if args.cam0_yaml and args.cam1_yaml:
            cfg, rect = calib.euroc_rectified_config(
                args.cam0_yaml, args.cam1_yaml, base=cfg)
        if args.native_loader:
            from .io import native_loader
            return cfg, native_loader.euroc_native(args.root, rect), None
        return cfg, datasets.euroc_frames(args.root, rect), None
    if args.dataset == "kitti":
        if args.native_loader:
            from .io import native_loader
            return cfg, native_loader.kitti_native(args.root, args.seq), None
        return cfg, datasets.kitti_frames(args.root, args.seq), None
    if args.dataset == "video":
        return cfg, datasets.video_frames(args.root, args.right), None
    if args.dataset == "synthetic":
        lefts, rights, gts = synthetic.make_sequence(
            cfg.camera, args.frames, kind="arc", seed=args.seed,
            scene_kind=args.scene, perturb=args.perturb, device=device)
        src = ((lefts[i], rights[i], i * 0.1) for i in range(args.frames))
        return cfg, src, gts.cpu().numpy()
    raise ValueError(args.dataset)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True,
                   choices=["euroc", "kitti", "video", "synthetic"])
    p.add_argument("--root", help="dataset root / video path")
    p.add_argument("--right", help="right video file (video mode)")
    p.add_argument("--seq", default="00", help="KITTI sequence id")
    p.add_argument("--calib", help="flat YAML calibration/config file")
    p.add_argument("--cam0-yaml", help="EuRoC cam0 sensor.yaml")
    p.add_argument("--cam1-yaml", help="EuRoC cam1 sensor.yaml")
    p.add_argument("--out", default="trajectory.tum")
    p.add_argument("--format", default="tum", choices=["tum", "kitti"])
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scene", default="planes", choices=["planes", "clutter"],
                   help="synthetic scene geometry")
    p.add_argument("--perturb", action="store_true",
                   help="synthetic: apply photometric nuisance model "
                        "(exposure gain/bias, vignette, sensor noise)")
    p.add_argument("--metrics-out", help="write per-frame metrics JSON")
    p.add_argument("--native-loader", action="store_true",
                   help="decode/prefetch frames with the C++ loader "
                        "(native/frameloader.cpp) instead of the Python "
                        "readers (euroc/kitti datasets)")
    p.add_argument("--loop-closure", action="store_true",
                   help="after the run, detect appearance-based loop "
                        "closures in the keyframe bank and refine the "
                        "exported trajectory by pose-graph optimization")
    p.add_argument("--online-loop", type=int, default=0, metavar="N",
                   help="close loops ONLINE: every N-th keyframe "
                        "insertion the live map is loop-checked against "
                        "the long-horizon memory bank and drift is "
                        "repaired during the run (0 = off; see "
                        "config.online_loop_every)")
    p.add_argument("--device", default="cuda",
                   help="where the engine runs: 'cuda' (the default; an "
                        "error without a card) or 'cpu'")
    args = p.parse_args(argv)
    device = resolve(args.device)

    if args.dataset == "euroc":
        cfg = euroc_config()
    elif args.dataset == "kitti":
        cfg = kitti_config()
    else:
        cfg = SvoConfig()
    if args.calib:
        cfg = calib.load_flat_yaml(args.calib, base=cfg)
    if args.online_loop > 0:
        cfg = dataclasses.replace(cfg, online_loop_every=args.online_loop)

    cfg, frames, gt_poses = _frame_source(args, cfg, device)
    svo = StereoSvo(cfg, device)

    # The progress line reads only what the host already holds (the
    # tracking flag of the step's one sync per frame): no device value is
    # fetched for it, so a frame that prints costs no extra sync.
    timestamps = []
    t0 = time.perf_counter()
    n = n_ok = 0
    for left, right, ts in frames:
        svo.new_image(left, right)
        timestamps.append(ts)
        n += 1
        n_ok += svo.tracking_ok
        if n % 50 == 0:
            fps = n / (time.perf_counter() - t0)
            print(f"frame {n}: {fps:.1f} fps, tracking ok on {n_ok}",
                  file=sys.stderr)
        if args.max_frames and n >= args.max_frames:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0

    traj = svo.trajectory()
    n_loop_edges = 0
    if args.loop_closure:
        from .backend import loop_closure
        traj, _, n_loop_edges = loop_closure.refine_trajectory(
            cfg, svo.state, traj)
        print(f"loop closure: {n_loop_edges} edge(s) accepted",
              file=sys.stderr)
    if args.format == "tum":
        trajectory.save_tum(args.out, traj, timestamps)
    else:
        trajectory.save_kitti(args.out, traj)

    metrics = svo.metrics()
    summary = {
        "frames": n,
        "fps": n / elapsed,
        "keyframes": int(metrics["kf_inserted"].sum()),
        "tracking_ok_frac": float(metrics["tracking_ok"].mean()),
        "mean_tracked": float(metrics["n_tracked"][1:].mean()) if n > 1 else 0,
        "loop_edges": n_loop_edges,
        "out": args.out,
    }
    if gt_poses is not None and n > 1:
        gt = np.asarray(gt_poses)[:n]
        summary["ate_rmse_m"] = float(ate_mod.ate_rmse(
            ate_mod.positions(traj), ate_mod.positions(gt)))
        rpe_t, rpe_r = ate_mod.rpe(traj, gt)
        summary["rpe_t_m"] = float(rpe_t)
        summary["rpe_r_rad"] = float(rpe_r)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({k: np.asarray(v).tolist() for k, v in
                       metrics.items()} | {"summary": summary}, f)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
