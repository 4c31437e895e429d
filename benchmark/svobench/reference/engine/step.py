"""The per-frame SVO state machine — port of ``stereo_svo_tpu/engine/step.py``,
one sequence at a time, as far as the benchmark's configurations run it.

One frame: pyramid (kernels B1, B2) → relocalisation scoring → coarse-to-fine
alignment (B3, B4) → KLT (B3), optionally on affine-warped templates → stereo
re-measurement (B3) → pose refinement → depth filters, with the epipolar
search (B3) for lost seeds when ``epi_samples > 0`` → keyframe decision → on
keyframe frames ``keyframe.insert`` and window BA → template rebuild (B3).
The online loop closure (``online_loop_every > 0``) is not part of it:
:func:`make_step` refuses such a configuration.

Control flow. The reference keeps every branch on the device with
``lax.cond``; here the branches are host ``if``s:

* boot vs track: the host knows whether a keyframe exists (``HostFlags``);
* the rotated relocalisation variants: gated by the previous frame's
  ``tracking_ok``, which the host already holds;
* the keyframe branch: one ``.tolist()`` per tracked frame reads
  (need_kf, ok) — the step's only host sync. Window BA's acceptance stays
  on the device (``torch.where``), so a keyframe frame costs no more syncs.

``fori_loop``s with static trip counts are Python loops. No tensor of the
state is updated in place: each phase returns a new ``SlamState``, as in
the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..backend import ba as ba_mod
from ..backend import loop_closure
from ..config import SvoConfig
from ..device import index0
from ..frontend import keyframe, pose_refine
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..ops import align as align_ops
from ..ops import depth_filter, klt as klt_ops, pyramid, solve, stereo_match
from .state import (STATUS_DEAD, STATUS_LANDMARK, STATUS_SEED, FrameOut,
                    SlamState)

_I32 = torch.int32


def world_points(cfg: SvoConfig, state: SlamState) -> torch.Tensor:
    """(N,3) world positions from owner-KF anchor + inverse-depth mean."""
    z = 1.0 / torch.clamp(state.mu, min=1e-4)
    p_kf = cam_mod.backproject(cfg.camera, state.kf_uv, z)
    return se3.transform(state.kf_T_wk[state.kf_id], p_kf)


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    s = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf")))
                   ).values
    n = mask.sum()
    idx = torch.clamp((n - 1) // 2, 0, x.shape[0] - 1)
    # all-false mask (fully lost frame): a benign positive depth, not inf
    return torch.where(n > 0, index0(s, idx), torch.ones_like(s[0]))


def run_window_ba(cfg: SvoConfig, st: SlamState) -> SlamState:
    """Window stereo BA over the keyframe ring + converged landmarks,
    written back into the anchor parameterisation (seeds keep their
    filters). Accepted on the device only if the cost dropped and the
    newest keyframe stays within the trust region (or, with
    ``ba_trust_clamp``, as a partial step scaled to it)."""
    cam = cfg.camera
    X = world_points(cfg, st)
    X_mask = st.status == STATUS_LANDMARK
    kf_T_wk, X_new, stats = ba_mod.bundle_adjust(
        cam, cfg, st.kf_T_wk, st.kf_valid, X, X_mask,
        st.obs_uv, st.obs_mask, st.obs_disp, st.obs_dmask,
        obs_sig=st.obs_sig, kf_stamp=st.kf_stamp)

    T_last = index0(st.kf_T_wk, st.last_kf)
    dr, dt = se3.distance(index0(kf_T_wk, st.last_kf), T_last)
    if cfg.ba_trust_clamp:
        # a proposal beyond the trust region applies as a geodesic partial
        # step scaled to the trust radius (of the newest keyframe, as the
        # reference)
        s = torch.clamp(torch.minimum(
            cfg.ba_trust_t / torch.clamp(dt, min=1e-9),
            cfg.ba_trust_r / torch.clamp(dr, min=1e-9)), max=1.0)
        kf_T_wk = se3.compose(se3.exp(s * se3.log(se3.compose(
            kf_T_wk, se3.inverse(st.kf_T_wk)))), st.kf_T_wk)
        X_new = X + s * (X_new - X)
        ok = stats.cost_final < stats.cost_initial
    else:
        ok = ((stats.cost_final < stats.cost_initial)
              & (dt < cfg.ba_trust_t) & (dr < cfg.ba_trust_r))
    # signed forward component of the newest keyframe's proposed move, in
    # its own camera frame
    delta_c = se3.transform(se3.inverse(T_last), se3.translation(
        index0(kf_T_wk, st.last_kf)))
    ba_diag = torch.stack([dt, dr, delta_c[2], stats.cost_initial,
                           stats.cost_final, ok.to(torch.float32),
                           stats.n_obs.to(torch.float32)])
    kf_T_wk = torch.where(ok, kf_T_wk, st.kf_T_wk)
    X_new = torch.where(ok, X_new, X)

    # fold the refined point back along the anchor bearing (the anchor
    # pixel kf_uv is the feature's photometric identity and stays put)
    x_k = se3.transform(se3.inverse(kf_T_wk)[st.kf_id], X_new)
    z = x_k[..., 2]
    mu = torch.where(X_mask & (z > 0.1), 1.0 / torch.clamp(z, min=1e-3),
                     st.mu)
    # refresh the memory-bank poses of window keyframes that still own
    # their slot (its stamp is the keyframe's creation stamp)
    M = st.mem_T_wk.shape[0]
    owns = st.kf_valid & (st.mem_stamp[st.kf_mem] == st.kf_stamp)
    dst = torch.where(owns, st.kf_mem, torch.full_like(st.kf_mem, M))
    mem_T = keyframe._put_drop(st.mem_T_wk, dst.long(), kf_T_wk)
    return st._replace(kf_T_wk=kf_T_wk, mu=mu, mem_T_wk=mem_T,
                       ba_diag=ba_diag)


def _rebuild_template(cfg: SvoConfig, state: SlamState, pyr_l, gxs, gys,
                      T_cw: torch.Tensor, z_obs=None,
                      z_obs_ok=None) -> SlamState:
    """Anchor the next frame's alignment template at the current frame;
    ``z_obs``/``z_obs_ok`` override map depths with this frame's stereo."""
    z_cur = se3.transform(T_cw, world_points(cfg, state))[..., 2]
    if z_obs is not None:
        z_cur = torch.where(z_obs_ok & (z_obs > 0.1), z_obs, z_cur)
    mask = ((state.status > 0) & (z_cur > 0.1)
            & cam_mod.in_bounds(cfg.camera, state.feat_uv,
                                margin=cfg.align_patch))
    tmpl = align_ops.make_template(pyr_l, gxs, gys, cfg.camera, cfg,
                                   state.feat_uv, z_cur, mask)
    return state._replace(tmpl=tmpl)


class TrackCtx(NamedTuple):
    """Per-frame tracking context threaded between the step phases."""
    T_cw: torch.Tensor
    ok: torch.Tensor
    need_kf: torch.Tensor
    n_inl: torch.Tensor
    med_depth: torch.Tensor
    align_cost: torch.Tensor
    align_inlier_frac: torch.Tensor
    refine_rms_px: torch.Tensor
    n_seed_deaths: torch.Tensor
    n_epi_recovered: torch.Tensor
    n_warped: torch.Tensor
    tmpl_z_obs: torch.Tensor
    tmpl_z_ok: torch.Tensor


class HostFlags(NamedTuple):
    """What the host knows about the state without reading the device."""
    booted: bool        # a keyframe exists (the reference: any(kf_valid))
    tracking_ok: bool   # the previous frame tracked


def host_flags(state: SlamState) -> HostFlags:
    """Read HostFlags from a state (one host sync)."""
    booted, ok = torch.stack([state.kf_valid.any(),
                              state.tracking_ok]).tolist()
    return HostFlags(bool(booted), bool(ok))


def make_phases(cfg: SvoConfig):
    """The per-frame state machine as (boot, track_phase, kf_phase,
    post_phase), as the reference's ``make_phases``."""
    cam = cfg.camera

    def boot(st: SlamState, pyr_l, gxs, gys, img_r):
        """First frame: create the bootstrap keyframe."""
        dev = st.T_cw.device
        T_cw = st.T_cw
        st = keyframe.insert(cfg, st, pyr_l, gxs, gys, img_r, T_cw)
        st = _rebuild_template(cfg, st, pyr_l, gxs, gys, T_cw)
        true = torch.ones((), dtype=torch.bool, device=dev)
        st = st._replace(T_pw=T_cw, vel=torch.zeros(6, device=dev),
                         frame_idx=st.frame_idx + 1, tracking_ok=true)
        z = torch.zeros((), device=dev)
        zi = torch.zeros((), dtype=_I32, device=dev)
        out = FrameOut(
            T_wc=se3.inverse(T_cw), tracking_ok=true, kf_inserted=true,
            n_tracked=(st.status > 0).sum().to(_I32),
            n_seeds=(st.status == STATUS_SEED).sum().to(_I32),
            n_landmarks=(st.status == STATUS_LANDMARK).sum().to(_I32),
            align_cost=z, align_inlier_frac=z + 1.0, refine_rms_px=z,
            median_depth=_masked_median(
                1.0 / torch.clamp(st.mu, min=1e-4), st.status > 0),
            n_seed_deaths=zi, n_epi_recovered=zi, ba_diag=st.ba_diag,
            n_warped=zi)
        return st, out

    def track_phase(st: SlamState, pyr_l, gxs, gys, img_r,
                    prev_ok: bool = True
                    ) -> Tuple[SlamState, TrackCtx]:
        """``prev_ok``: the host's copy of the previous frame's
        tracking_ok (False computes the rotated relocalisation
        variants)."""
        # --- 1. sparse direct alignment vs previous frame, seeded from the
        # constant-velocity prior or, after a failure, the relocalisation
        # keyframe ---
        T_init_vel = se3.exp(st.vel)
        reloc, reloc_score = loop_closure.relocalize(
            st.mem_desc, st.mem_valid, pyr_l[cfg.num_levels - 1],
            cfg.loop_desc_rows, cfg.loop_desc_cols,
            n_rot=cfg.pr_rot_variants, rot_step=cfg.pr_rot_step_rad,
            rot_gate=not prev_ok)
        latest = torch.argmax(torch.where(
            st.mem_valid, st.mem_stamp, torch.full_like(st.mem_stamp, -1)))
        reloc = torch.where(reloc_score >= cfg.reloc_min_score,
                            reloc.long(), latest)
        T_reloc_wk = index0(st.mem_T_wk, reloc)
        T_kf_rel = se3.compose(se3.inverse(T_reloc_wk), se3.inverse(st.T_pw))
        T_init = torch.where(st.tracking_ok, T_init_vel, T_kf_rel)
        T_cp, align_stats = align_ops.align(pyr_l, st.tmpl, cam, cfg, T_init)
        T_cw_pred = se3.compose(T_cp, st.T_pw)

        # --- 2. KLT feature alignment vs keyframe templates ---
        active = st.status > 0
        X_w = world_points(cfg, st)
        x_c = se3.transform(T_cw_pred, X_w)
        uv_pred, front = cam_mod.project(cam, x_c)
        in_img = front & cam_mod.in_bounds(cam, uv_pred,
                                           margin=cfg.klt_patch + 2)
        klt_mask = active & in_img
        A_inv = None
        if cfg.klt_affine_warp:
            # pose-predicted affine template warp; degenerate or strongly
            # shrinking warps fall back to the identity
            z_ref = 1.0 / torch.clamp(st.mu, min=1e-4)
            T_ck_pred = se3.compose(T_cw_pred[None], st.kf_T_wk[st.kf_id])
            A = cam_mod.affine_warp_matrix(cam, st.kf_uv, z_ref, T_ck_pred)
            det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
            A = torch.where((det > 0.2)[:, None, None], A,
                            torch.eye(2, dtype=A.dtype, device=A.device))
            A_inv = solve.inv2x2(A)
        uv_ref, klt_ok, _, n_warped = klt_ops.track(
            pyr_l, st.klt_tmpl._replace(mask=st.klt_tmpl.mask & klt_mask),
            cfg, uv_pred, edge_dir=st.feat_dir, is_edgelet=~st.feat_corner,
            A_inv=A_inv)
        tracked = klt_mask & klt_ok

        # --- 3. per-frame stereo disparity at the tracked positions ---
        disp_m = ok_m = None
        if cfg.stereo_refresh_window > 0:
            z_pred = torch.clamp(x_c[..., 2], min=0.2)
            disp_m, _, ok_m = stereo_match.refine_disparity(
                pyr_l[0], img_r, uv_ref, cam.fx * cam.baseline / z_pred,
                cfg.stereo_refresh_window, cfg.stereo_patch)

        # --- 4. motion-only pose refinement ---
        obs_sigma = torch.exp2(st.feat_level.to(torch.float32))
        sig_reproj = sig_disp = obs_sigma
        if cfg.refine_whiten_depth:
            sd_mu = torch.sqrt(torch.clamp(st.sigma2, min=0.0))
            t_ck = se3.translation(se3.compose(T_cw_pred[None],
                                               st.kf_T_wk[st.kf_id]))
            t_ck_n = torch.sqrt(torch.sum(t_ck * t_ck, -1))
            sig_reproj = torch.sqrt(obs_sigma ** 2
                                    + (cam.fx * t_ck_n * sd_mu) ** 2)
            sig_disp = torch.sqrt(obs_sigma ** 2
                                  + (cam.fx * cam.baseline * sd_mu) ** 2)
        T_prior = se3.compose(T_init, st.T_pw)
        T_cw, inliers, refine_stats = pose_refine.refine(
            cam, cfg, T_cw_pred, X_w, uv_ref, tracked,
            obs_sigma=sig_reproj, T_prior=T_prior, disp_obs=disp_m,
            disp_mask=None if ok_m is None else (tracked & ok_m),
            obs_sigma_d=sig_disp)
        n_inl = refine_stats["refine_inliers"]
        ok = (n_inl >= 10) & torch.all(torch.isfinite(T_cw))
        # failed frame: anchor at the relocalisation keyframe instead
        T_cw = torch.where(ok, T_cw, se3.inverse(T_reloc_wk))

        # --- feature bookkeeping ---
        lost = ok & active & (~in_img | (tracked & ~inliers))
        status = torch.where(lost, torch.full_like(st.status, STATUS_DEAD),
                             st.status)
        feat_uv = torch.where((ok & tracked & inliers)[:, None], uv_ref,
                              uv_pred)

        # --- 5. recursive depth-filter updates ---
        T_ck = se3.compose(T_cw[None], st.kf_T_wk[st.kf_id])   # (N,3,4)
        seeds = ok & (status == STATUS_SEED) & inliers
        obs_uv_df, px_scale = feat_uv, obs_sigma
        n_epi = torch.zeros((), dtype=_I32, device=status.device)
        if cfg.epi_samples > 0:
            # seeds KLT lost this frame are still measured by a 1-D ZNCC
            # search along their epipolar segment; the hit feeds the depth
            # filter only, never the tracked position
            lv_e = cfg.epi_level
            lost_seed = (ok & (status == STATUS_SEED)
                         & ~(tracked & inliers) & st.klt_tmpl.mask)
            uv_epi, epi_ok, _ = depth_filter.epipolar_search(
                cam, cfg, T_ck, st.kf_uv, st.mu, st.sigma2,
                st.klt_tmpl.patches[lv_e], pyr_l[lv_e], lost_seed,
                level=lv_e)
            recovered = lost_seed & epi_ok
            n_epi = recovered.sum().to(_I32)
            seeds = seeds | recovered
            obs_uv_df = torch.where(recovered[:, None], uv_epi, feat_uv)
            px_scale = torch.where(
                recovered, torch.clamp(obs_sigma, min=float(2 ** lv_e)),
                obs_sigma)
        upd = depth_filter.observe_and_update(
            cam, cfg, T_ck, st.kf_uv, obs_uv_df, st.mu, st.sigma2,
            st.a_beta, st.b_beta, st.z_range, seeds, px_scale=px_scale)
        n_upd = st.n_upd + upd.updated.to(_I32)
        if cfg.stereo_refresh_window > 0:
            refresh_status = (status > 0) if cfg.stereo_refresh_landmarks \
                else (status == STATUS_SEED)
            upd2 = depth_filter.stereo_observe_and_update(
                cam, cfg, se3.inverse(T_ck), feat_uv, disp_m, ok_m,
                upd.mu, upd.sigma2, upd.a, upd.b, st.z_range,
                ok & refresh_status & tracked & inliers, px_scale=obs_sigma)
            upd = upd._replace(mu=upd2.mu, sigma2=upd2.sigma2, a=upd2.a,
                               b=upd2.b)
        conv = depth_filter.converged(cfg, upd.mu, upd.sigma2)
        div = depth_filter.diverged(cfg, upd.a, upd.b, n_upd)
        status = torch.where((status == STATUS_SEED) & conv,
                             torch.full_like(status, STATUS_LANDMARK), status)
        status = torch.where((status == STATUS_SEED) & div,
                             torch.full_like(status, STATUS_DEAD), status)
        n_seed_deaths = ((st.status == STATUS_SEED)
                         & (status == STATUS_DEAD)).sum().to(_I32)
        st = st._replace(status=status, feat_uv=feat_uv, mu=upd.mu,
                         sigma2=upd.sigma2, a_beta=upd.a, b_beta=upd.b,
                         n_upd=n_upd)

        # --- 6. keyframe decision, distance measured from the predicted
        # (constant-velocity) centre ---
        z_cur = se3.transform(T_cw, world_points(cfg, st))[..., 2]
        med_depth = _masked_median(z_cur, st.status > 0)
        c_cur = se3.translation(se3.inverse(T_prior))
        c_kf = se3.translation(index0(st.kf_T_wk, st.last_kf))
        kf_dist = torch.sqrt(torch.sum((c_cur - c_kf) ** 2))
        regular = ((n_inl < cfg.kf_min_tracked)
                   | (kf_dist > cfg.kf_dist_ratio * med_depth))
        if cfg.kf_every > 1:
            urgent = n_inl < max(10, cfg.kf_min_tracked // 2)
            eligible = (st.frame_idx % cfg.kf_every) == 0
            regular = urgent | (regular & eligible)
        need_kf = ok & st.tracking_ok & regular

        if cfg.align_tmpl_stereo and disp_m is not None:
            tmpl_z_obs = cam.fx * cam.baseline / torch.clamp(disp_m, min=0.25)
            tmpl_z_ok = tracked & inliers & ok_m
        else:
            tmpl_z_obs = torch.zeros_like(st.mu)
            tmpl_z_ok = torch.zeros_like(tracked)
        ctx = TrackCtx(
            T_cw=T_cw, ok=ok, need_kf=need_kf, n_inl=n_inl,
            med_depth=med_depth, align_cost=align_stats["align_cost"],
            align_inlier_frac=align_stats["align_inlier_frac"],
            refine_rms_px=refine_stats["refine_rms_px"],
            n_seed_deaths=n_seed_deaths, n_epi_recovered=n_epi,
            n_warped=n_warped, tmpl_z_obs=tmpl_z_obs, tmpl_z_ok=tmpl_z_ok)
        return st, ctx

    def kf_phase(st: SlamState, pyr_l, gxs, gys, img_r,
                 T_cw: torch.Tensor) -> SlamState:
        """Insert the keyframe, then run window BA."""
        st = keyframe.insert(cfg, st, pyr_l, gxs, gys, img_r, T_cw)
        if cfg.use_ba:
            st = run_window_ba(cfg, st)
        return st

    def post_phase(st: SlamState, pyr_l, gxs, gys, ctx: TrackCtx
                   ) -> Tuple[SlamState, FrameOut]:
        T_cw_kf = se3.inverse(index0(st.kf_T_wk, st.last_kf))
        T_cw = torch.where(ctx.need_kf, T_cw_kf, ctx.T_cw)
        # --- 7. re-anchor next frame's alignment template (the stereo
        # depth override holds only on non-keyframe frames) ---
        st = _rebuild_template(cfg, st, pyr_l, gxs, gys, T_cw,
                               z_obs=ctx.tmpl_z_obs,
                               z_obs_ok=ctx.tmpl_z_ok & ~ctx.need_kf)
        vel = se3.log(se3.compose(T_cw, se3.inverse(st.T_pw)))
        vel = torch.where(ctx.ok, vel, 0.5 * st.vel)
        st = st._replace(T_cw=T_cw, T_pw=T_cw, vel=vel,
                         frame_idx=st.frame_idx + 1, tracking_ok=ctx.ok)
        out = FrameOut(
            T_wc=se3.inverse(T_cw), tracking_ok=ctx.ok,
            kf_inserted=ctx.need_kf, n_tracked=ctx.n_inl.to(_I32),
            n_seeds=(st.status == STATUS_SEED).sum().to(_I32),
            n_landmarks=(st.status == STATUS_LANDMARK).sum().to(_I32),
            align_cost=ctx.align_cost,
            align_inlier_frac=ctx.align_inlier_frac,
            refine_rms_px=ctx.refine_rms_px, median_depth=ctx.med_depth,
            n_seed_deaths=ctx.n_seed_deaths,
            n_epi_recovered=ctx.n_epi_recovered, ba_diag=st.ba_diag,
            n_warped=ctx.n_warped)
        return st, out

    return boot, track_phase, kf_phase, post_phase


def _read_decisions(ctx: TrackCtx) -> Tuple[bool, bool]:
    """The step's one host sync: (need_kf, ok) of the tracked frame."""
    need_kf, ok = torch.stack([ctx.need_kf, ctx.ok]).tolist()
    return bool(need_kf), bool(ok)


def make_step(cfg: SvoConfig):
    """The per-frame step for a static config:
    ``step(state, img_l, img_r, flags=None) -> (state, FrameOut, flags)``.

    ``flags`` (``HostFlags``) carries what the host knows between frames;
    without it the step reads it from the state (one extra host sync).
    Images are contiguous float32 (H,W) tensors on the state's device.
    """
    if cfg.online_loop_every > 0:
        raise NotImplementedError(
            "the reference has no online loop closure (online_loop_every)")
    boot, track_phase, kf_phase, post_phase = make_phases(cfg)

    def step(state: SlamState, img_l: torch.Tensor, img_r: torch.Tensor,
             flags: Optional[HostFlags] = None
             ) -> Tuple[SlamState, FrameOut, HostFlags]:
        if flags is None:
            flags = host_flags(state)
        pyr = pyramid.build_with_gradients(img_l, cfg.num_levels)
        if not flags.booted:
            st, out = boot(state, *pyr, img_r)
            return st, out, HostFlags(booted=True, tracking_ok=True)
        st, ctx = track_phase(state, *pyr, img_r, prev_ok=flags.tracking_ok)
        need_kf, ok = _read_decisions(ctx)
        if need_kf:
            st = kf_phase(st, *pyr, img_r, ctx.T_cw)
        st, out = post_phase(st, *pyr, ctx)
        return st, out, HostFlags(booted=True, tracking_ok=ok)

    return step


__all__ = ["make_step", "make_phases", "run_window_ba", "world_points",
           "HostFlags", "host_flags"]
