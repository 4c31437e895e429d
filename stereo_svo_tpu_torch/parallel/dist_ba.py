"""Distributed Schur-complement bundle adjustment over a process group —
port of ``stereo_svo_tpu/parallel/dist_ba.py``.

The map's landmark blocks shard across ranks on the ``kf`` mesh axis. Each
rank linearises its own landmarks' observation blocks and eliminates its
landmark 3×3 blocks locally (the landmark Hessian is block-diagonal, so
elimination is embarrassingly parallel); the reduced camera system's
pose-side blocks (Hpp, gp, the Schur product and its right-hand side) are
summed across ranks with an all-reduce and solved replicated (6K × 6K,
tiny); landmark back-substitution is again rank-local. Four all-reduces
per Gauss-Newton iteration are the entire communication: O(K²·36) floats,
independent of the number of landmarks.

Where the reference wraps the solver in ``shard_map`` over a device mesh,
this is SPMD: every rank calls :func:`bundle_adjust_sharded` with its own
landmark shard (:func:`shard` cuts one from the whole problem) and the
replicated poses. The math is ``backend/ba.py``'s — both solvers run the
same ``ba_iteration`` (``reduce_fn`` injection) — so they agree up to the
order of the float32 sums, and every rank solves the same reduced system
and holds the same poses bit for bit.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..backend import ba
from ..config import CameraConfig, SvoConfig
from ..geometry import camera as cam_mod
from ..geometry import se3
from . import mesh as mesh_mod


def all_reduce_sum(group) -> Callable[[torch.Tensor], torch.Tensor]:
    """``reduce_fn`` for ``ba.ba_iteration``: returns the sum of a tensor
    over ``group``. ``all_reduce`` works in place, so a copy is reduced and
    the caller's tensor is left as it was."""
    def reduce_fn(x: torch.Tensor) -> torch.Tensor:
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y
    return reduce_fn


def shard(index: int, n: int, X, X_mask, obs_uv, obs_mask, obs_disp=None,
          obs_dmask=None):
    """Shard ``index`` of ``n`` of a whole problem: the landmark axis cut
    into n equal runs (axis 0 of X and X_mask, axis 1 of the observation
    blocks). N must be a multiple of n."""
    N = X.shape[0]
    if N % n:
        raise ValueError(f"{N} landmarks do not divide over {n} shards")
    s = slice(index * (N // n), (index + 1) * (N // n))
    return (X[s], X_mask[s], obs_uv[:, s], obs_mask[:, s],
            None if obs_disp is None else obs_disp[:, s],
            None if obs_dmask is None else obs_dmask[:, s])


def bundle_adjust_sharded(mesh: mesh_mod.Mesh, cam: CameraConfig,
                          cfg: SvoConfig, kf_T_wk: torch.Tensor,
                          kf_valid: torch.Tensor, X: torch.Tensor,
                          X_mask: torch.Tensor, obs_uv: torch.Tensor,
                          obs_mask: torch.Tensor,
                          obs_disp: Optional[torch.Tensor] = None,
                          obs_dmask: Optional[torch.Tensor] = None,
                          axis: str = "kf",
                          fixed_mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window stereo BA with landmarks sharded over ``axis``.

    Called by every rank of the axis's group. kf_T_wk (K,3,4), kf_valid
    (K,) and fixed_mask (K,) are replicated; X (n,3), X_mask (n,) and the
    observation blocks (K,n,…) are this rank's landmark shard.
    ``fixed_mask`` optionally overrides the gauge (callers with several
    disconnected pose blocks — e.g. multi-sequence maps — must pin one
    keyframe PER block or the reduced system is singular).
    Returns (kf_T_wk', X') with X' this rank's shard.
    """
    K = kf_T_wk.shape[0]
    if obs_disp is None:
        obs_disp = torch.zeros(obs_mask.shape, dtype=torch.float32,
                               device=obs_mask.device)
        obs_dmask = torch.zeros_like(obs_mask)
    if fixed_mask is None:
        first_valid = torch.argmax(kf_valid.to(torch.int32))
        fixed_mask = ((torch.arange(K, device=kf_valid.device) == first_valid)
                      | ~kf_valid).to(torch.float32)

    T_kw = se3.inverse(kf_T_wk)
    w_rows = ba.obs_weights(kf_valid, X_mask, obs_mask, obs_dmask)
    obs_ur = obs_uv[..., 0] - obs_disp
    reduce_fn = all_reduce_sum(mesh.group(axis))
    for _ in range(cfg.ba_iters):
        # solver pinned: the reduced system is fully summed, so every rank
        # holds the complete 6K×6K system and the replicated direct
        # Cholesky is valid
        T_kw, X, _ = ba.ba_iteration(cam, cfg, T_kw, X, obs_uv, obs_ur,
                                     w_rows, fixed_mask,
                                     reduce_fn=reduce_fn, solver="direct")
    return se3.inverse(T_kw), X


def dryrun_problem(n: int):
    """The dry run's tiny seeded geometry for n shards, as numpy: (cam,
    cfg, kf_T_wk (4,3,4), X (8n,3) offset by 1 cm from the truth, obs_uv
    (4,8n,2)): landmarks in front of a slowly moving camera."""
    cam = CameraConfig(fx=100.0, fy=100.0, cx=64.0, cy=48.0,
                       baseline=0.1, width=128, height=96)
    cfg = SvoConfig(camera=cam, ba_iters=2, max_keyframes=4)
    K, N = 4, 8 * n
    rng = np.random.default_rng(0)
    z = rng.uniform(2, 6, N)
    uv0 = np.stack([rng.uniform(20, 108, N), rng.uniform(20, 76, N)], -1)
    X = cam_mod.backproject(cam, torch.tensor(uv0, dtype=torch.float32),
                            torch.tensor(z, dtype=torch.float32))
    T_wk = torch.stack([se3.exp(torch.tensor(
        [0.05 * k, 0.0, 0.02 * k, 0.0, 0.01 * k, 0.0], dtype=torch.float32))
        for k in range(K)])
    obs_uv = torch.stack([
        cam_mod.project(cam, se3.transform(se3.inverse(T_wk[k]), X))[0]
        for k in range(K)])                                  # (K,N,2)
    return cam, cfg, T_wk.numpy(), (X + 0.01).numpy(), obs_uv.numpy()


def _solve_shard(mesh: mesh_mod.Mesh, axis: str, cam, cfg, whole: dict
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cut this rank's shard from a whole problem (a dict of numpy arrays
    under :func:`bundle_adjust_sharded`'s argument names; the optional ones
    may be missing) and solve it with the other ranks of ``axis``."""
    def t(name):
        a = whole.get(name)
        return None if a is None else torch.from_numpy(np.array(a))
    X, X_mask, obs_uv, obs_mask, obs_disp, obs_dmask = shard(
        mesh.index(axis), mesh.size(axis), t("X"), t("X_mask"), t("obs_uv"),
        t("obs_mask"), t("obs_disp"), t("obs_dmask"))
    return bundle_adjust_sharded(
        mesh, cam, cfg, t("kf_T_wk"), t("kf_valid"), X, X_mask, obs_uv,
        obs_mask, obs_disp, obs_dmask, axis=axis, fixed_mask=t("fixed_mask"))


def dryrun_rank(mesh: mesh_mod.Mesh, axis: str = "kf") -> torch.Tensor:
    """One rank's part of the dry run, inside a live process group (CPU
    tensors, so ``gloo``): one sharded BA on the seeded geometry. Asserts finite results and that
    every rank of the axis holds the same poses bit for bit; returns the
    poses."""
    n = mesh.size(axis)
    cam, cfg, T_wk, X, obs_uv = dryrun_problem(n)
    K, N = T_wk.shape[0], X.shape[0]
    T_out, X_out = _solve_shard(mesh, axis, cam, cfg, dict(
        kf_T_wk=T_wk, kf_valid=np.ones(K, bool), X=X,
        X_mask=np.ones(N, bool), obs_uv=obs_uv,
        obs_mask=np.ones((K, N), bool)))
    assert bool(torch.isfinite(T_out).all() & torch.isfinite(X_out).all())
    everyone = [torch.empty_like(T_out) for _ in range(n)]
    dist.all_gather(everyone, T_out.contiguous(), group=mesh.group(axis))
    assert all(torch.equal(T_out, other) for other in everyone), \
        "ranks disagree on the poses"
    return T_out


def _dryrun_local_rank(rank: int, n: int) -> np.ndarray:
    return dryrun_rank(mesh_mod.make(n, axis_name="kf")).numpy()


def dryrun(n_devices: int, timeout_s: float = 180.0) -> None:
    """Execute one distributed BA on tiny synthetic geometry over
    ``n_devices`` CPU ranks of this machine (``gloo``)."""
    mesh_mod.spawn_local(_dryrun_local_rank, n_devices, timeout_s=timeout_s)


def _local_rank(rank: int, n: int, cam, cfg, whole: dict):
    T_out, X_out = _solve_shard(mesh_mod.make(n, axis_name="kf"), "kf", cam,
                                cfg, whole)
    return T_out.numpy(), X_out.numpy()


def bundle_adjust_local(n: int, cam: CameraConfig, cfg: SvoConfig,
                        timeout_s: float = 180.0, **whole):
    """The sharded solver on a whole problem over n CPU ranks of this
    machine (``gloo``), what a virtual CPU mesh is to the reference:
    ``whole`` holds numpy arrays under :func:`bundle_adjust_sharded`'s
    argument names. Returns every rank's (kf_T_wk', X' shard) as numpy, in
    rank order."""
    return mesh_mod.spawn_local(_local_rank, n, (cam, cfg, whole),
                                timeout_s=timeout_s)
