"""SlamState: the whole SLAM system as fixed-capacity tensors — port of
``stereo_svo_tpu/engine/state.py``.

Field names and dtypes are the reference's (int32 indices and counters,
bool masks, float32 data).

Feature status codes: 0 = dead slot, 1 = depth-filter seed,
2 = converged landmark.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SvoConfig
from ..device import resolve
from ..geometry import se3
from ..ops import align as align_ops
from ..ops import klt as klt_ops

STATUS_DEAD = 0
STATUS_SEED = 1
STATUS_LANDMARK = 2


class SlamState(NamedTuple):
    # --- pose & motion ---
    T_cw: torch.Tensor        # (3,4) world→current-camera
    T_pw: torch.Tensor        # (3,4) world→previous-frame camera
    vel: torch.Tensor         # (6,) twist of last cur←prev motion
    frame_idx: torch.Tensor   # () int32
    tracking_ok: torch.Tensor  # () bool
    # --- features (N,) ---
    status: torch.Tensor      # int32
    feat_uv: torch.Tensor     # (N,2) current-frame level-0 position
    feat_level: torch.Tensor  # (N,) int32 detection pyramid level
    feat_corner: torch.Tensor  # (N,) bool — corner (True) vs edgelet
    feat_dir: torch.Tensor    # (N,2) unit gradient dir (edgelet normal)
    kf_id: torch.Tensor       # (N,) int32 owner keyframe slot
    kf_uv: torch.Tensor       # (N,2) anchor pixel in owner keyframe
    mu: torch.Tensor          # (N,) inverse-depth posterior mean
    sigma2: torch.Tensor      # (N,) inverse-depth posterior variance
    a_beta: torch.Tensor      # (N,) Beta inlier count
    b_beta: torch.Tensor      # (N,) Beta outlier count
    z_range: torch.Tensor     # (N,) inverse-depth range (outlier model)
    n_upd: torch.Tensor       # (N,) int32 filter update count
    # --- templates ---
    tmpl: align_ops.Template
    klt_tmpl: klt_ops.KltTemplate
    # --- keyframes (K,) ---
    kf_T_wk: torch.Tensor     # (K,3,4) keyframe→world poses
    kf_valid: torch.Tensor    # (K,) bool
    kf_next: torch.Tensor     # () int32
    last_kf: torch.Tensor     # () int32 slot of the most recent keyframe
    kf_stamp: torch.Tensor    # (K,) int32 frame index at KF creation
    kf_desc: torch.Tensor     # (K,D) place-recognition descriptors
    kf_thumb: torch.Tensor    # (K,Ht,Wt) coarse thumbnails
    kf_mem: torch.Tensor      # (K,) int32 memory-bank slot of each window KF
    # --- long-horizon keyframe memory (M,) ---
    mem_T_wk: torch.Tensor
    mem_valid: torch.Tensor
    mem_stamp: torch.Tensor
    mem_desc: torch.Tensor
    mem_thumb: torch.Tensor
    mem_uv: torch.Tensor
    mem_mask: torch.Tensor
    mem_disp: torch.Tensor
    mem_dmask: torch.Tensor
    mem_next: torch.Tensor
    n_loop_closures: torch.Tensor
    last_loop_mem: torch.Tensor
    # --- BA observation graph (K,N) ---
    obs_uv: torch.Tensor
    obs_mask: torch.Tensor
    obs_disp: torch.Tensor
    obs_dmask: torch.Tensor
    obs_sig: torch.Tensor
    # --- diagnostics ---
    ba_diag: torch.Tensor     # (7,) last window-BA call (zeros without BA)


class FrameOut(NamedTuple):
    """Per-frame output + structured metrics: the reference's fields, then
    ``n_warped``, the (feature, level) pairs KLT tracked on affine-warped
    templates (0 without ``klt_affine_warp``)."""
    T_wc: torch.Tensor
    tracking_ok: torch.Tensor
    kf_inserted: torch.Tensor
    n_tracked: torch.Tensor
    n_seeds: torch.Tensor
    n_landmarks: torch.Tensor
    align_cost: torch.Tensor
    align_inlier_frac: torch.Tensor
    refine_rms_px: torch.Tensor
    median_depth: torch.Tensor
    n_seed_deaths: torch.Tensor
    n_epi_recovered: torch.Tensor
    ba_diag: torch.Tensor
    n_warped: torch.Tensor


def init_state(cfg: SvoConfig, device="cuda") -> SlamState:
    device = resolve(device)
    N, K, M = cfg.max_features, cfg.max_keyframes, cfg.mem_keyframes
    L_align = cfg.align_levels - cfg.align_min_level
    P2a = cfg.align_patch ** 2
    Lk = cfg.klt_levels
    P2k = cfg.klt_patch ** 2
    f32, i32, b = torch.float32, torch.int32, torch.bool

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(value, *shape, dtype=f32):
        return torch.full(shape, value, dtype=dtype, device=device)

    eye = se3.identity(device=device)
    return SlamState(
        T_cw=eye, T_pw=eye.clone(), vel=z(6), frame_idx=z(dtype=i32),
        tracking_ok=full(True, dtype=b),
        status=z(N, dtype=i32), feat_uv=z(N, 2), feat_level=z(N, dtype=i32),
        feat_corner=full(True, N, dtype=b), feat_dir=z(N, 2),
        kf_id=z(N, dtype=i32), kf_uv=z(N, 2), mu=full(0.25, N),
        sigma2=full(1.0, N), a_beta=full(10.0, N), b_beta=full(10.0, N),
        z_range=full(1.0, N), n_upd=z(N, dtype=i32),
        tmpl=align_ops.Template(p_ref=z(N, 3), patches=z(L_align, N, P2a),
                                jac=z(L_align, N, P2a, 6),
                                mask=z(N, dtype=b)),
        klt_tmpl=klt_ops.KltTemplate(
            patches=z(Lk, N, P2k), jac=z(Lk, N, P2k, 2),
            hinv=z(Lk, N, 2, 2), mask=z(N, dtype=b),
            big=z(Lk, N, cfg.klt_big_patch ** 2), big_ok=z(Lk, N, dtype=b)),
        kf_T_wk=eye.expand(K, 3, 4).clone(), kf_valid=z(K, dtype=b),
        kf_next=z(dtype=i32), last_kf=z(dtype=i32), kf_stamp=z(K, dtype=i32),
        kf_desc=z(K, cfg.desc_dim), kf_thumb=z(K, *cfg.thumb_shape),
        kf_mem=z(K, dtype=i32),
        mem_T_wk=eye.expand(M, 3, 4).clone(), mem_valid=z(M, dtype=b),
        mem_stamp=z(M, dtype=i32), mem_desc=z(M, cfg.desc_dim),
        mem_thumb=z(M, *cfg.thumb_shape), mem_uv=z(M, N, 2),
        mem_mask=z(M, N, dtype=b), mem_disp=z(M, N),
        mem_dmask=z(M, N, dtype=b), mem_next=z(dtype=i32),
        n_loop_closures=z(dtype=i32),
        last_loop_mem=full(-(2 ** 20), dtype=i32),
        obs_uv=z(K, N, 2), obs_mask=z(K, N, dtype=b), obs_disp=z(K, N),
        obs_dmask=z(K, N, dtype=b), obs_sig=full(1.0, K, N),
        ba_diag=z(7),
    )
