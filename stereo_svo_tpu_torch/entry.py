"""Entry points: the single-device step with example arguments, and a
multi-rank dry run — the port's counterpart of the repository's
``__graft_entry__.py``.

``entry()`` returns the flagship per-frame step (the SVO state machine at
the full EuRoC geometry) with example arguments on the chosen device: the
graph-captured step (``engine/graphed.py``), as the reference returns a
jitted function: ``step(state, left, right) -> (state, FrameOut)``.

``dryrun_multichip(n)`` starts n CPU ranks of this machine in one ``gloo``
group and runs, on tiny shapes, ONE bootstrap step of the multi-sequence
pipeline on every rank (sequences spread over the ``data`` axis, which has
no collective) and one distributed Schur-complement bundle adjustment
sharded over the ``kf``/landmark axis.

  python -m stereo_svo_tpu_torch.entry [n]
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


def _dryrun_rank(rank: int, n: int) -> bool:
    """One rank of the dry run: a bootstrap step on this rank's sequence,
    then the sharded BA over all ranks."""
    from .engine.state import init_states
    from .engine.step import make_batched_step
    from .parallel import dist_ba, mesh as mesh_mod

    cfg = _tiny_cfg()
    h, w = cfg.camera.height, cfg.camera.width

    # --- axis 1: data-parallel batched odometry, one sequence a rank ---
    mesh_mod.make(n, axis_name="data")
    rng = np.random.default_rng(0)
    lefts = rng.uniform(0, 255, (n, h, w))
    rights = rng.uniform(0, 255, (n, h, w))
    img = lambda a: torch.tensor(a[rank:rank + 1],  # noqa: E731
                                 dtype=torch.float32)
    _, outs, _ = make_batched_step(cfg)(init_states(cfg, 1, "cpu"),
                                        img(lefts), img(rights))
    assert bool(outs.kf_inserted[0]), "bootstrap step must insert KFs"

    # --- axis 2: distributed Schur-complement BA over the kf group ---
    dist_ba.dryrun_rank(mesh_mod.make(n, axis_name="kf"))
    return True


def dryrun_multichip(n_devices: int, timeout_s: float = 180.0) -> None:
    from .parallel import mesh as mesh_mod

    done = mesh_mod.spawn_local(_dryrun_rank, n_devices, timeout_s=timeout_s)
    assert done == [True] * n_devices
    print(f"dryrun_multichip({n_devices}): OK")


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
