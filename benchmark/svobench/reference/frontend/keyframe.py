"""Keyframe insertion: detection, stereo bootstrap, slot assignment — port
of ``stereo_svo_tpu/frontend/keyframe.py``.

The reference scatters with ``mode="drop"`` through an out-of-range index
on purpose; on CUDA an out-of-range index faults, so those writes go
through one-hot masks (small counts) or a target padded by one spare slot
that is sliced off (:func:`_put_drop`). Slot compaction uses stable sorts,
as the reference, so slot assignment matches it exactly.
"""

from __future__ import annotations

import torch

from ..backend import loop_closure
from ..config import SvoConfig
from ..engine.state import STATUS_DEAD, STATUS_SEED, SlamState
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..ops import depth_filter, klt as klt_ops, stereo_match
from . import detector


def cell_index(cfg: SvoConfig, uv: torch.Tensor) -> torch.Tensor:
    """Grid cell id of level-0 positions (N,2) → (N,) int64."""
    ch = cfg.camera.height // cfg.grid_rows
    cw = cfg.camera.width // cfg.grid_cols
    cy = torch.clamp(uv[:, 1].long() // ch, 0, cfg.grid_rows - 1)
    cx = torch.clamp(uv[:, 0].long() // cw, 0, cfg.grid_cols - 1)
    return cy * cfg.grid_cols + cx


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(n, len(idx)) bool: row j marks where idx == j (out-of-range → none)."""
    return idx[None, :] == torch.arange(n, device=idx.device)[:, None]


def _set_row(arr: torch.Tensor, i: torch.Tensor, val) -> torch.Tensor:
    """arr.at[i].set(val) for a 0-dim index tensor, without a host sync."""
    sel = (torch.arange(arr.shape[0], device=arr.device) == i)
    sel = sel.reshape((-1,) + (1,) * (arr.dim() - 1))
    if isinstance(val, torch.Tensor):
        val = val.to(arr.dtype)
    return torch.where(sel, val, arr)   # a Python scalar needs no copy


def _put_drop(arr: torch.Tensor, dst: torch.Tensor, vals: torch.Tensor
              ) -> torch.Tensor:
    """arr.at[dst].set(vals, mode="drop") for dst in [0, len(arr)]: the
    target gets one spare slot for the dropped writes, sliced off after."""
    pad = torch.cat([arr, arr[:1]])
    return pad.index_copy(0, dst, vals.to(arr.dtype))[:-1]


def mem_coverage_slot(mem_valid: torch.Tensor, mem_stamp: torch.Tensor,
                      protected: torch.Tensor) -> torch.Tensor:
    """Temporal-coverage retention: the memory-bank slot to (over)write.
    Empty slots first; when full, evict the slot whose removal least widens
    the retained coverage, never the oldest/newest or a protected slot."""
    M = mem_valid.shape[0]
    dev = mem_valid.device
    first_free = torch.argmin(mem_valid.to(torch.int32))
    all_full = torch.all(mem_valid)
    order = torch.argsort(torch.where(mem_valid, mem_stamp,
                                      torch.full_like(mem_stamp, 2 ** 30)),
                          stable=True)
    s = mem_stamp[order]
    nxt = torch.cat([s[1:], s[-1:]])
    prv = torch.cat([s[:1], s[:-1]])
    loss_sorted = (nxt - prv).to(torch.float32)
    idx = torch.arange(M, device=dev)
    inf = torch.full_like(loss_sorted, float("inf"))
    loss_sorted = torch.where((idx == 0) | (idx == M - 1), inf, loss_sorted)
    loss = torch.zeros(M, dtype=torch.float32, device=dev).scatter(
        0, order, loss_sorted)
    loss = torch.where(protected, inf, loss)
    fallback = torch.where(protected, inf, mem_stamp.to(torch.float32))
    loss = torch.where(torch.all(torch.isinf(loss)), fallback, loss)
    evict = torch.argmin(loss)
    return torch.where(all_full, evict, first_free).to(torch.int32)


def insert(cfg: SvoConfig, state: SlamState, pyr_l, gxs, gys,
           img_r: torch.Tensor, T_cw: torch.Tensor) -> SlamState:
    """Create a keyframe at pose T_cw from the current stereo pair."""
    cam = cfg.camera
    N = cfg.max_features
    K = cfg.max_keyframes
    n_cells = cfg.grid_rows * cfg.grid_cols
    dev = state.status.device
    i32 = torch.int32

    # --- slot: empty slots first, else the keyframe owning the fewest
    # active features (never the newest) ---
    owned = (_one_hot(state.kf_id, K) & (state.status > 0)[None]).sum(
        1).to(torch.float32)
    cost = torch.where(state.kf_valid, owned, torch.full_like(owned, -1.0))
    cost = torch.where(torch.arange(K, device=dev) == state.last_kf,
                       torch.full_like(cost, 1e9), cost)
    slot = torch.argmin(cost).to(i32)

    status = torch.where((state.kf_id == slot) & (state.status > 0),
                         torch.full_like(state.status, STATUS_DEAD),
                         state.status)
    active = status > 0

    # --- spatially free cells (no currently tracked feature) ---
    occupied = (_one_hot(cell_index(cfg, state.feat_uv), n_cells)
                & active[None]).any(1)
    free_cells = ~occupied

    # --- detect & stereo-bootstrap new candidates ---
    det = detector.detect(pyr_l, gxs[0], gys[0], cfg, free_cells)
    disp, _, st_ok = stereo_match.match(
        pyr_l[0], img_r, det.uv, cfg.stereo_max_disp, cfg.stereo_patch)
    z0 = cam_mod.disparity_to_depth(cam, disp)
    cand = det.valid & st_ok & (z0 > 0.3) & (z0 < 80.0)

    # --- pair valid candidates with free slots (stable sort compaction) ---
    dead = status == STATUS_DEAD
    free_order = torch.argsort((~dead).to(i32), stable=True)
    cand_order = torch.argsort((~cand).to(i32), stable=True)
    n_assign = torch.minimum(dead.sum(), cand.sum())
    assign = torch.arange(N, device=dev) < n_assign
    dst = torch.where(assign, free_order, torch.full_like(free_order, N))
    src = cand_order

    mu0, s20, a0, b0 = depth_filter.seed_from_stereo(
        cam, cfg, z0, px_scale=torch.exp2(det.level.to(torch.float32)))

    def put(arr, vals):
        return _put_drop(arr, dst, vals[src])

    status = put(status, torch.full((N,), STATUS_SEED, dtype=i32, device=dev))
    feat_uv = put(state.feat_uv, det.uv)
    feat_level = put(state.feat_level, det.level)
    feat_corner = put(state.feat_corner, det.is_corner)
    feat_dir = put(state.feat_dir, det.grad_dir)
    kf_id = put(state.kf_id, slot.expand(N))
    kf_uv = put(state.kf_uv, det.uv)
    mu = put(state.mu, mu0)
    sigma2 = put(state.sigma2, s20)
    a_beta = put(state.a_beta, a0)
    b_beta = put(state.b_beta, b0)
    z_range = put(state.z_range, torch.clamp(2.0 * mu0, 0.5, 4.0))
    n_upd = put(state.n_upd, torch.zeros(N, dtype=i32, device=dev))
    new_rows = _put_drop(torch.zeros(N, dtype=torch.bool, device=dev), dst,
                         assign)

    # --- KLT templates: new rows from this keyframe's pyramid ---
    fresh = klt_ops.make_template(pyr_l, gxs, gys, cfg, feat_uv, status > 0)

    def blend(old, new):
        return torch.where(new_rows.reshape((1, N) + (1,) * (new.dim() - 2)),
                           new, old)

    old = state.klt_tmpl
    klt_tmpl = klt_ops.KltTemplate(
        patches=blend(old.patches, fresh.patches),
        jac=blend(old.jac, fresh.jac), hinv=blend(old.hinv, fresh.hinv),
        mask=torch.where(new_rows, torch.ones_like(old.mask),
                         old.mask & (status > 0)),
        big=blend(old.big, fresh.big),
        big_ok=torch.where(new_rows[None, :], fresh.big_ok, old.big_ok))

    # --- keyframe ring buffer + place-recognition record ---
    T_wk = se3.inverse(T_cw)
    kf_T_wk = _set_row(state.kf_T_wk, slot, T_wk)
    kf_valid = _set_row(state.kf_valid, slot, True)
    desc = loop_closure.descriptor(pyr_l[cfg.num_levels - 1],
                                   cfg.loop_desc_rows, cfg.loop_desc_cols)
    thumb = pyr_l[cfg.thumb_level]
    kf_stamp = _set_row(state.kf_stamp, slot, state.frame_idx)
    kf_desc = _set_row(state.kf_desc, slot, desc)
    kf_thumb = _set_row(state.kf_thumb, slot, thumb)

    # --- observation snapshot for BA (every tracked feature, incl. new),
    # stereo re-matched and gated against the posterior's disparity ---
    disp_all, _, disp_ok = stereo_match.match(
        pyr_l[0], img_r, feat_uv, cfg.stereo_max_disp, cfg.stereo_patch,
        min_zncc=0.7)
    p_kf = cam_mod.backproject(cam, kf_uv, 1.0 / torch.clamp(mu, min=1e-4))
    X_w = se3.transform(kf_T_wk[kf_id], p_kf)
    z_cur = se3.transform(T_cw, X_w)[..., 2]
    disp_pred = cam.fx * cam.baseline / torch.clamp(z_cur, min=1e-3)
    window = torch.clamp(cfg.stereo_consist_rel * disp_all,
                         min=cfg.stereo_consist_px)
    consistent = torch.abs(disp_all - disp_pred) < window
    obs_uv = _set_row(state.obs_uv, slot, feat_uv)
    obs_mask = _set_row(state.obs_mask & ~new_rows[None, :], slot, status > 0)
    obs_disp = _set_row(state.obs_disp, slot, disp_all)
    obs_dmask = _set_row(state.obs_dmask & ~new_rows[None, :], slot,
                         disp_ok & consistent & (status > 0))
    obs_sig = _set_row(state.obs_sig, slot,
                       torch.exp2(feat_level.to(torch.float32)))

    # --- long-horizon memory bank (survives window eviction) ---
    M = cfg.mem_keyframes
    if cfg.mem_retention == "fifo":
        m = (state.mem_next % M).to(i32)
    else:
        owns = state.kf_valid & (state.mem_stamp[state.kf_mem]
                                 == state.kf_stamp)
        protected = (_one_hot(state.kf_mem, M) & owns[None]).any(1)
        m = mem_coverage_slot(state.mem_valid, state.mem_stamp, protected)
    mem = dict(
        mem_T_wk=_set_row(state.mem_T_wk, m, T_wk),
        mem_valid=_set_row(state.mem_valid, m, True),
        mem_stamp=_set_row(state.mem_stamp, m, state.frame_idx),
        mem_desc=_set_row(state.mem_desc, m, desc),
        mem_thumb=_set_row(state.mem_thumb, m, thumb),
        mem_uv=_set_row(state.mem_uv, m, feat_uv),
        mem_mask=_set_row(state.mem_mask, m, status > 0),
        mem_disp=_set_row(state.mem_disp, m, disp_all),
        mem_dmask=_set_row(state.mem_dmask, m, disp_ok & (status > 0)),
        mem_next=state.mem_next + 1,
        kf_mem=_set_row(state.kf_mem, slot, m))

    return state._replace(
        status=status, feat_uv=feat_uv, feat_level=feat_level,
        feat_corner=feat_corner, feat_dir=feat_dir, kf_id=kf_id,
        kf_uv=kf_uv, mu=mu, sigma2=sigma2, a_beta=a_beta, b_beta=b_beta,
        z_range=z_range, n_upd=n_upd, klt_tmpl=klt_tmpl,
        kf_T_wk=kf_T_wk, kf_valid=kf_valid,
        kf_next=state.kf_next + 1, last_kf=slot,
        kf_stamp=kf_stamp, kf_desc=kf_desc, kf_thumb=kf_thumb,
        obs_uv=obs_uv, obs_mask=obs_mask,
        obs_disp=obs_disp, obs_dmask=obs_dmask, obs_sig=obs_sig, **mem)
