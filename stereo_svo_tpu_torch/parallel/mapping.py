"""Multi-sequence distributed mapping — port of
``stereo_svo_tpu/parallel/mapping.py``.

Merges the per-sequence keyframe maps produced by the odometry engine into
one global problem — poses from all sequences concatenated, landmarks
concatenated, observation blocks block-diagonal — then refines it with:

  1. pose-graph optimisation over all keyframe chains, with optional
     cross-sequence loop-closure edges (backend/pose_graph.py), and
  2. the distributed Schur-complement stereo BA (landmarks sharded over
     the ``kf`` mesh axis, the pose system all-reduced — dist_ba.py).

SPMD: every rank of the ``kf`` group calls :func:`optimize_global_map`
with the same whole map, works on its own landmark shard in the BA and
gathers the shards back, so each rank returns the whole refined map.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..backend import loop_closure, pose_graph
from ..config import CameraConfig, SvoConfig
from ..engine.state import STATUS_LANDMARK, SlamState
from ..engine.step import world_points
from ..geometry import se3
from . import dist_ba
from . import mesh as mesh_mod


class GlobalMap(NamedTuple):
    """Concatenated multi-sequence map (fixed capacity: B·K poses, B·N
    landmarks, observations block-diagonal)."""
    kf_T_wk: torch.Tensor    # (BK,3,4)
    kf_valid: torch.Tensor   # (BK,)
    kf_seq: torch.Tensor     # (BK,) sequence id of each keyframe
    X: torch.Tensor          # (BN,3)
    X_mask: torch.Tensor     # (BN,)
    obs_uv: torch.Tensor     # (BK,BN,2)
    obs_mask: torch.Tensor   # (BK,BN)
    obs_disp: torch.Tensor   # (BK,BN)
    obs_dmask: torch.Tensor  # (BK,BN)
    kf_stamp: torch.Tensor   # (BK,) frame index at KF creation
    kf_desc: torch.Tensor    # (BK,D) place-recognition descriptors
    kf_thumb: torch.Tensor   # (BK,Ht,Wt) coarse thumbnails


def build_global_map(cfg: SvoConfig, states: List[SlamState]) -> GlobalMap:
    """Concatenate per-sequence engine states into one global problem."""
    B = len(states)
    K = cfg.max_keyframes
    N = cfg.max_features
    dev = states[0].kf_T_wk.device

    def cat(name):
        return torch.cat([getattr(s, name) for s in states])

    def block_diagonal(name):
        """A sequence's keyframes observe its own landmarks only."""
        first = getattr(states[0], name)
        out = torch.zeros((B * K, B * N) + first.shape[2:], dtype=first.dtype,
                          device=dev)
        for b, s in enumerate(states):
            out[b * K:(b + 1) * K, b * N:(b + 1) * N] = getattr(s, name)
        return out

    kf_seq = torch.arange(B, dtype=torch.int32,
                          device=dev).repeat_interleave(K)
    X = torch.cat([world_points(cfg, s) for s in states])
    X_mask = torch.cat([s.status == STATUS_LANDMARK for s in states])
    return GlobalMap(
        cat("kf_T_wk"), cat("kf_valid"), kf_seq, X, X_mask,
        block_diagonal("obs_uv"), block_diagonal("obs_mask"),
        block_diagonal("obs_disp"), block_diagonal("obs_dmask"),
        cat("kf_stamp"), cat("kf_desc"), cat("kf_thumb"))


def detect_loop_edges(cfg: SvoConfig, gmap: GlobalMap
                      ) -> Tuple[pose_graph.PoseGraph,
                                 "loop_closure.LoopMeasurement"]:
    """Appearance-based loop-closure detection over the global keyframe
    bank (within and across sequences): descriptor match → thumbnail
    direct-alignment measurement → photometric gate
    (backend/loop_closure.close_loops). The returned graph's rejected
    edges carry weight 0, so it can be passed straight to
    ``optimize_global_map(loop_edges=...)``."""
    return loop_closure.close_loops(
        cfg, gmap.kf_T_wk, gmap.kf_valid, gmap.kf_desc, gmap.kf_thumb,
        gmap.kf_stamp, gmap.kf_seq, gmap.obs_uv, gmap.obs_mask,
        gmap.obs_disp, gmap.obs_dmask)


def optimize_global_map(mesh: mesh_mod.Mesh, cam: CameraConfig,
                        cfg: SvoConfig, gmap: GlobalMap,
                        loop_edges: Optional[pose_graph.PoseGraph] = None,
                        pg_iters: int = 10
                        ) -> Tuple[GlobalMap, torch.Tensor]:
    """Pose graph (with optional cross-sequence loop closures) then
    distributed Schur BA over the mesh's ``kf`` axis. Returns (refined
    map, pg cost)."""
    # --- 1. pose graph over all keyframe chains ---
    # chain edges only within a sequence: mask out cross-sequence pairs
    graph = pose_graph.chain_graph(gmap.kf_T_wk, gmap.kf_valid)
    e = graph.edges_ij.long()
    same_seq = gmap.kf_seq[e[:, 0]] == gmap.kf_seq[e[:, 1]]
    graph = graph._replace(weight=graph.weight * same_seq)
    if loop_edges is not None:
        graph = pose_graph.PoseGraph(
            edges_ij=torch.cat([graph.edges_ij, loop_edges.edges_ij]),
            Z=torch.cat([graph.Z, loop_edges.Z]),
            weight=torch.cat([graph.weight, loop_edges.weight]))
    T_pg, pg_cost = pose_graph.optimize(
        gmap.kf_T_wk, gmap.kf_valid, graph, n_iters=pg_iters)

    # carry landmarks with their (sequence-local) keyframe correction:
    # X' = T_new_wk · T_old_kw · X, approximated by the delta of the
    # sequence's first valid keyframe (rigid per sequence) before BA
    # re-polishes everything jointly. The sequence count is this offline
    # path's one host read; the first valid keyframes stay on the device.
    BK = gmap.kf_T_wk.shape[0]
    B = int(gmap.kf_seq.max()) + 1 if gmap.kf_seq.numel() else 1
    K = BK // max(B, 1)
    N = gmap.X.shape[0] // max(B, 1)
    dev = gmap.kf_T_wk.device
    k0 = (torch.arange(B, device=dev) * K
          + torch.argmax(gmap.kf_valid.view(B, K).to(torch.int32), 1))
    delta = se3.compose(T_pg[k0], se3.inverse(gmap.kf_T_wk[k0]))  # (B,3,4)
    X = se3.transform(delta[:, None], gmap.X.view(B, N, 3)).reshape(-1, 3)

    # --- 2. distributed stereo BA over the refined initialisation ---
    # Gauge: pin the first valid keyframe of EACH sequence — the sequences
    # share no observations, so each pose block needs its own anchor or
    # the reduced camera system is singular along that block's gauge.
    fixed = (~gmap.kf_valid).index_fill(0, k0, True)
    n, index = mesh.size("kf"), mesh.index("kf")
    T_ba, X_s = dist_ba.bundle_adjust_sharded(
        mesh, cam, cfg, T_pg, gmap.kf_valid,
        *dist_ba.shard(index, n, X, gmap.X_mask, gmap.obs_uv, gmap.obs_mask,
                       gmap.obs_disp, gmap.obs_dmask),
        fixed_mask=fixed.to(torch.float32))
    shards = [torch.empty_like(X_s) for _ in range(n)]
    dist.all_gather(shards, X_s.contiguous(), group=mesh.group("kf"))
    return gmap._replace(kf_T_wk=T_ba, X=torch.cat(shards)), pg_cost


def align_maps_umeyama(X_a, X_b) -> torch.Tensor:
    """SE(3) aligning landmark cloud b onto a (for loop-closure seeding
    between overlapping sequences). Returns a (3,4) pose on the host."""
    from ..eval.ate import align_umeyama

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    _, R, t = align_umeyama(host(X_b), host(X_a))
    return torch.from_numpy(
        np.concatenate([R, t[:, None]], axis=1).astype(np.float32))
