"""Appearance-based place recognition and loop-closure edges — port of
``stereo_svo_tpu/backend/loop_closure.py``.

1. Descriptors: a keyframe's coarse pyramid level average-pooled onto a
   tiny grid, zero-mean and unit-norm (dot product = ZNCC), with shifted
   and rotated query variants; ``relocalize`` searches the bank with them.
2. Proposals: ``propose_edges`` (offline, the K×K similarity matrix) and
   ``propose_online`` (the newest keyframe against the bank), masked by
   validity and temporal gap, top-k into a fixed-capacity edge list.
3. Measurement: ``measure_edges`` aligns each proposed pair's stored
   thumbnails in both directions (``ops/align`` at thumbnail scale, on
   kernels B2, B3 and B4) and gates each edge on inlier fraction and
   round-trip consistency.

The reference vmaps the alignment over the edge list; here each of the 2E
(edge, direction) problems is a Python iteration with its own launches.
Edge indices stay device tensors (``index_select``, never ``.item()``), so
the online path runs inside a keyframe frame without a host sync.
``torch.topk`` does not promise an order among equal scores where
``lax.top_k`` returns the lower index first; only edges below the score
gate can tie (they carry weight 0), so the results agree on valid edges.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import CameraConfig, SvoConfig
from ..device import index0
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..ops import align as align_ops
from ..ops.kernels import pyramid_kernel
from . import pose_graph


def _pooled_grid(img: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(rows+2, cols+2) average-pooled grid of the image."""
    H, W = img.shape
    R, C = rows + 2, cols + 2
    ch, cw = H // R, W // C
    x = img[: R * ch, : C * cw].to(torch.float32)
    return x.reshape(R, ch, C, cw).mean(dim=(1, 3))


def _normalized(sub: torch.Tensor) -> torch.Tensor:
    sub = sub - sub.mean(-1, keepdim=True)
    n = torch.sqrt(torch.sum(sub * sub, -1, keepdim=True))
    return sub / torch.clamp(n, min=1e-6)


def descriptor(img: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Tiny-thumbnail global descriptor: the centred (rows, cols) sub-grid
    of the pooled grid, zero-mean, unit-norm. (rows*cols,)"""
    grid = _pooled_grid(img, rows, cols)
    return _normalized(grid[1:1 + rows, 1:1 + cols].reshape(-1))


def similarity(desc: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """(D,) query vs (K, D) bank → (K,) ZNCC scores in [-1, 1]."""
    return bank @ desc


def shifted_descriptors(img: torch.Tensor, rows: int, cols: int
                        ) -> torch.Tensor:
    """(9, rows*cols) descriptors of the ±1-cell-shifted pooling grids."""
    grid = _pooled_grid(img, rows, cols)
    subs = [grid[dy:dy + rows, dx:dx + cols].reshape(-1)
            for dy in (0, 1, 2) for dx in (0, 1, 2)]
    return _normalized(torch.stack(subs))


def _bilinear_grid(grid: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor
                   ) -> torch.Tensor:
    """Bilinear sample of a small (R,C) grid at float coords, clamped."""
    R, C = grid.shape
    sy = torch.clamp(sy, 0.0, R - 1.0)
    sx = torch.clamp(sx, 0.0, C - 1.0)
    y0 = torch.clamp(torch.floor(sy).long(), 0, R - 2)
    x0 = torch.clamp(torch.floor(sx).long(), 0, C - 2)
    fy = sy - y0
    fx = sx - x0
    g00, g01 = grid[y0, x0], grid[y0, x0 + 1]
    g10, g11 = grid[y0 + 1, x0], grid[y0 + 1, x0 + 1]
    return ((1 - fy) * (1 - fx) * g00 + (1 - fy) * fx * g01
            + fy * (1 - fx) * g10 + fy * fx * g11)


def _rotate_image(img: torch.Tensor, angle: float) -> torch.Tensor:
    """Bilinear in-plane rotation about the image centre (border clamped)."""
    H, W = img.shape
    ca, sa = math.cos(float(angle)), math.sin(float(angle))
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=img.device),
        torch.arange(W, dtype=torch.float32, device=img.device),
        indexing="ij")
    dx = xx - cx
    dy = yy - cy
    sx = ca * dx - sa * dy + cx
    sy = sa * dx + ca * dy + cy
    return _bilinear_grid(img.to(torch.float32), sy, sx)


def rotated_descriptors(img: torch.Tensor, rows: int, cols: int,
                        angles) -> torch.Tensor:
    """(len(angles), rows*cols) descriptors of in-plane-rotated views."""
    return torch.stack([descriptor(_rotate_image(img, a), rows, cols)
                        for a in angles])


def query_descriptors(img: torch.Tensor, rows: int, cols: int,
                      n_rot: int = 0, rot_step: float = 0.15
                      ) -> torch.Tensor:
    """All query-side matching variants, (9 + 2·n_rot, rows*cols): the 9
    shifts, then the rotations. The bank stores only the centre
    descriptor; viewpoint tolerance lives on the query side."""
    ds = [shifted_descriptors(img, rows, cols)]
    if n_rot > 0:
        angles = [k * rot_step for k in range(-n_rot, n_rot + 1) if k != 0]
        ds.append(rotated_descriptors(img, rows, cols, angles))
    return torch.cat(ds, 0)


def relocalize(kf_desc: torch.Tensor, kf_valid: torch.Tensor,
               coarse_img: torch.Tensor, rows: int, cols: int,
               n_rot: int = 0, rot_step: float = 0.15,
               rot_gate: bool | None = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Appearance-nearest bank slot for a query frame: (slot, score);
    invalid slots score -2.

    rot_gate: host bool — compute the rotated query variants only when
    True (the engine passes "previous frame failed", which the host holds;
    the reference makes the same choice with ``lax.cond``).
    """
    if rot_gate is not None and not rot_gate:
        n_rot = 0
    q = query_descriptors(coarse_img, rows, cols, n_rot, rot_step)
    scores = torch.amax(kf_desc @ q.T, -1)
    scores = torch.where(kf_valid, scores, torch.full_like(scores, -2.0))
    return torch.argmax(scores).to(torch.int32), torch.amax(scores)


class LoopProposals(NamedTuple):
    edges_ij: torch.Tensor   # (E,2) int32 — keyframe indices (i, j)
    score: torch.Tensor      # (E,) descriptor ZNCC
    valid: torch.Tensor      # (E,) bool


def propose_edges(desc: torch.Tensor, valid: torch.Tensor,
                  stamp: torch.Tensor, seq: torch.Tensor,
                  min_score: float, min_gap: int, max_edges: int,
                  desc_shift: torch.Tensor | None = None) -> LoopProposals:
    """Top-``max_edges`` loop candidates from the descriptor bank.

    desc (K,D); valid (K,); stamp (K,) frame index at creation; seq (K,)
    sequence id (zeros for one sequence); desc_shift: optional (K,V,D)
    query variants of each keyframe — similarity becomes the max over
    variants, symmetrised."""
    K = desc.shape[0]
    if desc_shift is not None:
        S = torch.amax(torch.einsum("kd,msd->kms", desc, desc_shift), -1)
        S = torch.maximum(S, S.T)
    else:
        S = desc @ desc.T
    i = torch.arange(K, device=desc.device)
    pair_ok = valid[:, None] & valid[None, :] & (i[:, None] < i[None, :])
    gap_ok = torch.abs(stamp[:, None] - stamp[None, :]) >= min_gap
    pair_ok = pair_ok & (gap_ok | (seq[:, None] != seq[None, :]))
    S = torch.where(pair_ok, S, torch.full_like(S, -2.0))
    top, idx = torch.topk(S.reshape(-1), max_edges)
    return LoopProposals(
        edges_ij=torch.stack([idx // K, idx % K], -1).to(torch.int32),
        score=top, valid=top >= min_score)


def propose_online(cfg: SvoConfig, mem_desc: torch.Tensor,
                   mem_valid: torch.Tensor, mem_stamp: torch.Tensor,
                   m_new: torch.Tensor, thumb_new: torch.Tensor
                   ) -> LoopProposals:
    """Incremental proposals: the newest keyframe (bank slot ``m_new``, a
    0-dim tensor) queries every bank entry with its shift and roll
    variants. Edges are (matched older slot, m_new); the temporal gap also
    excludes m_new itself."""
    q = query_descriptors(thumb_new, cfg.loop_desc_rows, cfg.loop_desc_cols,
                          cfg.pr_rot_variants, cfg.pr_rot_step_rad)
    scores = torch.amax(mem_desc @ q.T, -1)                       # (M,)
    gap = torch.abs(mem_stamp - index0(mem_stamp, m_new)) >= cfg.loop_min_gap
    scores = torch.where(mem_valid & gap, scores,
                         torch.full_like(scores, -2.0))
    top, idx = torch.topk(scores, cfg.online_loop_edges)
    edges = torch.stack([idx.to(torch.int32),
                         m_new.to(torch.int32).expand(idx.shape[0])], -1)
    return LoopProposals(edges_ij=edges, score=top,
                         valid=top >= cfg.loop_min_score)


def _thumb_cfg(cfg: SvoConfig) -> Tuple[CameraConfig, SvoConfig]:
    """Camera and single-level align config at thumbnail resolution."""
    s = 1.0 / (2 ** cfg.thumb_level)
    cam = cfg.camera
    th, tw = cfg.thumb_shape
    cam_t = dataclasses.replace(
        cam, fx=cam.fx * s, fy=cam.fy * s, cx=cam.cx * s, cy=cam.cy * s,
        width=tw, height=th)
    cfg_t = dataclasses.replace(
        cfg, camera=cam_t, num_levels=1, align_levels=1, align_min_level=0,
        klt_levels=1, align_patch=cfg.loop_patch,
        align_max_iters=cfg.loop_align_iters,
        epi_samples=0,                 # no depth filter at thumbnail scale
        align_iters_per_level=None)    # one level, not the main schedule
    return cam_t, cfg_t


class LoopMeasurement(NamedTuple):
    Z: torch.Tensor            # (E,3,4) measured T_i←j
    inlier_frac: torch.Tensor  # (E,)
    cost: torch.Tensor         # (E,) final mean robust photometric cost
    accept: torch.Tensor       # (E,) bool
    rt_t: torch.Tensor         # (E,) round-trip translation error (m) and
    rt_r: torch.Tensor         # (E,) rotation (rad): ‖Z_ij ∘ Z_ji‖, the
                               # edge's own noise estimate


def measure_edges(cfg: SvoConfig, props: LoopProposals,
                  kf_T_wk: torch.Tensor, kf_thumb: torch.Tensor,
                  obs_uv: torch.Tensor, obs_mask: torch.Tensor,
                  obs_disp: torch.Tensor, obs_dmask: torch.Tensor
                  ) -> LoopMeasurement:
    """Relative poses of proposed edges by thumbnail alignment.

    For edge (i, j), keyframe i gives 3-D points (its stereo snapshot) and
    reference patches from its thumbnail, keyframe j the target thumbnail;
    single-level IC Gauss-Newton from the current pose estimates gives
    T_j←i. Each edge is measured in both directions, with independent
    templates; Z = T_i←j, and an edge is accepted only if both directions
    keep ``loop_accept_frac`` inliers and agree within the round-trip gate.
    Invalid proposals run on an all-false mask and return T_init."""
    cam_t, cfg_t = _thumb_cfg(cfg)
    s = 1.0 / (2 ** cfg.thumb_level)
    th, tw = cfg.thumb_shape

    def one(i, j, score_valid):
        # [image, gx, gy] of thumbnail i in one buffer: B2 writes the
        # gradients into it and the template's B3 launch samples all three
        buf = torch.empty((3, th, tw), dtype=kf_thumb.dtype,
                          device=kf_thumb.device)
        torch.index_select(kf_thumb, 0, i.reshape(1).long(), out=buf[:1])
        pyramid_kernel.gradients(buf[0], out=buf[1:])
        z_i = cam_mod.disparity_to_depth(cfg.camera, index0(obs_disp, i))
        m = (index0(obs_mask, i) & index0(obs_dmask, i) & (z_i > 0.1)
             & score_valid)
        tmpl = align_ops.make_template(
            (buf[0],), (buf[1],), (buf[2],), cam_t, cfg_t,
            index0(obs_uv, i) * s, torch.where(m, z_i, torch.ones_like(z_i)),
            m)
        T_init = se3.compose(se3.inverse(index0(kf_T_wk, j)),
                             index0(kf_T_wk, i))               # T_j←i
        T_ji, stats = align_ops.align((index0(kf_thumb, j),), tmpl, cam_t,
                                      cfg_t, T_init)
        return (se3.inverse(T_ji), stats["align_inlier_frac"],
                stats["align_cost"])

    def measure(first, second):
        runs = [one(props.edges_ij[e, first], props.edges_ij[e, second],
                    props.valid[e])
                for e in range(props.edges_ij.shape[0])]
        return [torch.stack(x) for x in zip(*runs)]

    Z, frac, cost = measure(0, 1)
    Z_rev, frac_r, _ = measure(1, 0)
    rt_r, rt_t = se3.distance(se3.compose(Z, Z_rev),
                              se3.identity(device=Z.device))
    accept = (props.valid & (frac >= cfg.loop_accept_frac)
              & (frac_r >= cfg.loop_accept_frac)
              & (rt_t < cfg.loop_rt_max_t) & (rt_r < cfg.loop_rt_max_r))
    return LoopMeasurement(Z=Z, inlier_frac=frac, cost=cost, accept=accept,
                           rt_t=rt_t, rt_r=rt_r)


def close_loops(cfg: SvoConfig, kf_T_wk: torch.Tensor,
                kf_valid: torch.Tensor, kf_desc: torch.Tensor,
                kf_thumb: torch.Tensor, kf_stamp: torch.Tensor,
                kf_seq: torch.Tensor, obs_uv: torch.Tensor,
                obs_mask: torch.Tensor, obs_disp: torch.Tensor,
                obs_dmask: torch.Tensor
                ) -> Tuple[pose_graph.PoseGraph, LoopMeasurement]:
    """Detect, measure and gate loop edges over a keyframe bank: a
    fixed-capacity PoseGraph of loop edges (rejected proposals weigh 0)
    and the raw measurements."""
    variants = torch.stack([
        query_descriptors(th, cfg.loop_desc_rows, cfg.loop_desc_cols,
                          cfg.pr_rot_variants, cfg.pr_rot_step_rad)
        for th in kf_thumb])
    props = propose_edges(kf_desc, kf_valid, kf_stamp, kf_seq,
                          cfg.loop_min_score, cfg.loop_min_gap,
                          cfg.loop_max_edges, desc_shift=variants)
    meas = measure_edges(cfg, props, kf_T_wk, kf_thumb,
                         obs_uv, obs_mask, obs_disp, obs_dmask)
    graph = pose_graph.PoseGraph(edges_ij=props.edges_ij, Z=meas.Z,
                                 weight=meas.accept.to(torch.float32))
    return graph, meas


def refine_trajectory(cfg: SvoConfig, state, traj_T_wc,
                      chain_weight: float = 1.0):
    """Offline loop closing over a finished single-sequence run.

    Detects loop edges in the long-horizon memory bank (every keyframe
    ever created), optimises the stamp-ordered odometry chain plus the
    loop edges as a pose graph with the oldest keyframe pinned, and moves
    every frame from each keyframe's stamp on by that keyframe's
    correction. ``state``: the final SlamState; ``traj_T_wc``: (T,3,4)
    camera→world poses. Returns numpy (traj_refined (T,3,4),
    mem_T_wk_refined (M,3,4), accepted edge count)."""
    graph_loop, _ = close_loops(
        cfg, state.mem_T_wk, state.mem_valid, state.mem_desc,
        state.mem_thumb, state.mem_stamp, torch.zeros_like(state.mem_stamp),
        state.mem_uv, state.mem_mask, state.mem_disp, state.mem_dmask)
    traj = (traj_T_wc.detach().cpu().numpy()
            if isinstance(traj_T_wc, torch.Tensor) else np.asarray(traj_T_wc))
    T_old = state.mem_T_wk.cpu().numpy()
    n_edges = int(graph_loop.weight.sum())
    if n_edges == 0:
        return traj.copy(), T_old, 0

    chain = pose_graph.chain_graph_stamped(state.mem_T_wk, state.mem_valid,
                                           state.mem_stamp)
    full = pose_graph.PoseGraph(
        edges_ij=torch.cat([chain.edges_ij, graph_loop.edges_ij]),
        Z=torch.cat([chain.Z, graph_loop.Z]),
        weight=torch.cat([chain.weight * chain_weight, graph_loop.weight]))
    stamp = state.mem_stamp.cpu().numpy()
    valid = state.mem_valid.cpu().numpy()
    oldest = int(np.argmin(np.where(valid, stamp, np.iinfo(np.int32).max)))
    T_opt, _ = pose_graph.optimize(state.mem_T_wk, state.mem_valid, full,
                                   n_iters=10, fixed=oldest)
    T_opt = T_opt.cpu().numpy()

    # frame t takes the correction of the latest keyframe with stamp <= t
    slots = np.where(valid)[0]
    out = traj.copy()
    for s in slots[np.argsort(stamp[slots])]:
        delta = se3.compose(torch.from_numpy(T_opt[s]),
                            se3.inverse(torch.from_numpy(T_old[s]))).numpy()
        sel = np.arange(traj.shape[0]) >= stamp[s]
        R, t = delta[:, :3], delta[:, 3]
        out[sel, :, :3] = np.einsum("ij,njk->nik", R, traj[sel, :, :3])
        out[sel, :, 3] = np.einsum("ij,nj->ni", R, traj[sel, :, 3]) + t
    return out, T_opt, n_edges
