"""Entry points: the single-device step with example arguments, and a
multi-rank dry run — the port's counterpart of the repository's
``__graft_entry__.py``.

``entry()`` returns the flagship per-frame step (the SVO state machine at
the full EuRoC geometry) with example arguments on the chosen device: the
graph-captured step (``engine/graphed.py``), as the reference returns a
jitted function: ``step(state, left, right) -> (state, FrameOut)``.

``dryrun_multichip(n)`` starts n ranks of this machine, one a GPU in one
``nccl`` group (or, with ``device="cpu"``, n CPU ranks in one ``gloo``
group), and runs, on tiny shapes, the bootstrap step of the multi-sequence
pipeline on every rank (sequences spread over the ``data`` axis, which has
no collective), then one tracked step, and one distributed
Schur-complement bundle adjustment sharded over the ``kf``/landmark axis.

  python -m stereo_svo_tpu_torch.entry [n] [--device cpu]

runs ``torch.cuda.device_count()`` ranks on the cards by default, and 8
CPU ranks with ``--device cpu`` (the reference's 8 virtual CPU devices).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CameraConfig, SvoConfig
from .device import resolve


def _tiny_cfg(width=128, height=96) -> SvoConfig:
    return SvoConfig(
        camera=CameraConfig(fx=80.0, fy=80.0, cx=width / 2, cy=height / 2,
                            baseline=0.11, width=width, height=height),
        grid_rows=4, grid_cols=4, max_features=16, max_keyframes=4,
        num_levels=2, align_levels=2, align_max_iters=2, klt_levels=2,
        klt_max_iters=2, refine_max_iters=2, stereo_max_disp=16,
        stereo_patch=4, border_margin=6, kf_min_tracked=4, ba_iters=1)


def entry(device="cuda"):
    """(step, example_args): the single-device per-frame step for
    ``SvoConfig()`` (752×480), its frame graph captured on a CUDA device
    (one launch a frame, its branches on the device), and
    ``(state, left, right)`` for its first call, the frames seeded random
    noise."""
    from .engine.graphed import make_graphed_step
    from .engine.state import init_state

    device = resolve(device)
    cfg = SvoConfig()  # full EuRoC-geometry flagship config (752x480)
    fn = make_graphed_step(cfg, device)
    state = init_state(cfg, device)
    h, w = cfg.camera.height, cfg.camera.width
    rng = np.random.default_rng(0)
    left = torch.tensor(rng.uniform(0, 255, (h, w)), dtype=torch.float32,
                        device=device)
    right = torch.tensor(rng.uniform(0, 255, (h, w)), dtype=torch.float32,
                         device=device)
    return fn, (state, left, right)


def _dryrun_frames(cfg: SvoConfig, n: int, rank: int, device) -> tuple:
    """Rank ``rank``'s (1,H,W) left and right frames of the dry run over n
    ranks: seeded noise, one frame pair a rank."""
    h, w = cfg.camera.height, cfg.camera.width
    rng = np.random.default_rng(0)
    lefts = rng.uniform(0, 255, (n, h, w))
    rights = rng.uniform(0, 255, (n, h, w))
    return tuple(torch.tensor(a[rank:rank + 1], dtype=torch.float32,
                              device=device) for a in (lefts, rights))


def _dryrun_steps(cfg: SvoConfig, left, right, device):
    """The dry run's steps on one sequence: the bootstrap step, then one
    tracked step on the same frames (a bootstrap runs no alignment, no KLT
    and no pose refinement, so ``align_levels``, ``klt_track`` and
    ``refine_pose`` launch only there), through the eager batched step.
    Returns the tracked step's FrameOut."""
    from .engine.state import init_states
    from .engine.step import make_batched_step

    step = make_batched_step(cfg)
    states, outs, _ = step(init_states(cfg, 1, device), left, right)
    assert bool(outs.kf_inserted[0]), "bootstrap step must insert KFs"
    _, outs, _ = step(states, left, right)
    assert bool(torch.isfinite(outs.T_wc).all()), "tracked pose not finite"
    return outs


def _dryrun_rank(rank: int, n: int) -> dict:
    """One rank of the dry run, on the rank's device: the bootstrap and one
    tracked step on this rank's sequence (:func:`_dryrun_steps`), then the
    sharded BA over all ranks. Returns the rank's backend, device, kernel
    launch counts (0 on the CPU, where the kernels' plain versions run) and
    the tracked pose on the host."""
    import torch.distributed as dist

    from .ops import kernels
    from .parallel import dist_ba, mesh as mesh_mod

    cfg = _tiny_cfg()
    device = mesh_mod.rank_device()

    # --- axis 1: data-parallel batched odometry, one sequence a rank ---
    mesh_mod.make(n, axis_name="data")
    outs = _dryrun_steps(cfg, *_dryrun_frames(cfg, n, rank, device), device)

    # --- axis 2: distributed Schur-complement BA over the kf group ---
    dist_ba.dryrun_rank(mesh_mod.make(n, axis_name="kf"))
    return {"backend": dist.get_backend(), "device": str(device),
            "launches": kernels.launches(),
            "T_wc": outs.T_wc.cpu().numpy()}


def dryrun_multichip(n_devices: int, timeout_s: float = 180.0,
                     device="cuda") -> list:
    """The dry run over ``n_devices`` ranks: one a GPU over ``nccl``, or
    CPU ranks over ``gloo`` with ``device="cpu"``; raises RuntimeError
    before any process starts where the cards are missing
    (``parallel/mesh.spawn_local``). Returns each rank's report."""
    from .parallel import mesh as mesh_mod

    reports = mesh_mod.spawn_local(_dryrun_rank, n_devices,
                                   timeout_s=timeout_s, device=device)
    print(f"dryrun_multichip({n_devices}): OK")
    return reports


def parse_args(argv) -> tuple:
    """``[n] [--device cpu]`` → (n, device): n defaults to the cards'
    count on ``cuda`` and to 8 on the CPU."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m stereo_svo_tpu_torch.entry")
    ap.add_argument("n", type=int, nargs="?")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.n is not None:
        return args.n, args.device
    return (8 if args.device == "cpu" else torch.cuda.device_count(),
            args.device)


if __name__ == "__main__":
    import sys

    n, device = parse_args(sys.argv[1:])
    dryrun_multichip(n, device=device)
