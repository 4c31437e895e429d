"""The per-frame SVO state machine — port of ``stereo_svo_tpu/engine/step.py``.

One frame: pyramid (kernels B1, B2) → relocalisation scoring → coarse-to-fine
alignment (B3, B4) → KLT (B3), optionally on affine-warped templates → stereo
re-measurement (B3) → pose refinement → depth filters, with the epipolar
search (B3) for lost seeds when ``epi_samples > 0`` → keyframe decision → on
keyframe frames ``keyframe.insert``, window BA and, every
``online_loop_every``-th keyframe, the online loop closure (thumbnail
alignment on B2, B3, B4 and a pose graph) → template rebuild (B3).

Control flow. The reference keeps every branch on the device with
``lax.cond``. The graph-captured step (``engine/graphed.py``) does too: its
frame graph's conditional nodes branch on :func:`device_flags` and
:func:`device_decisions` (and their batched forms), with no host read.
The eager ``make_step`` and ``make_batched_step`` here are its plain
version, and in them the branches are host ``if``s:

* boot vs track: the host knows whether a keyframe exists (``HostFlags``);
* the rotated relocalisation variants: gated by the previous frame's
  ``tracking_ok``, which the host already holds;
* the keyframe branch and the online loop's cadence and cooldown: one
  ``.tolist()`` per tracked frame reads (need_kf, ok) and, with the online
  loop on, the bank's insertion count and last correction — the step's
  only host sync. Window BA's acceptance and the online loop's "any edge
  accepted" and trust guard stay on the device (``torch.where``), so a
  keyframe frame costs no more syncs.

``make_batched_step`` runs B sequences per call, as the reference's: each
phase ``torch.func.vmap``ped over a stacked state, so every operation and
every kernel launch takes the whole batch, with one such sync for the whole
batch and ``where`` keeping each sequence's own result where a phase runs
for some sequences only. ``fori_loop``s with static trip counts are Python
loops. No
tensor of the state is updated in place: each phase returns a new
``SlamState``, as in the reference.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ..backend import ba as ba_mod
from ..backend import loop_closure, pose_graph
from ..config import SvoConfig
from ..device import index0
from ..frontend import keyframe, pose_refine
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..ops import align as align_ops
from ..ops import depth_filter, klt as klt_ops, pyramid, solve, stereo_match
from ..utils import profiling
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


def run_online_loop(cfg: SvoConfig, st: SlamState) -> SlamState:
    """Online loop closure at keyframe insertion.

    1. the newest keyframe's descriptor variants query the memory bank
       (``loop_closure.propose_online``);
    2. the proposals are measured by thumbnail alignment in both
       directions (``loop_closure.measure_edges``);
    3. a pose graph over the bank (the stamp-ordered odometry chain plus
       the measured loop edges) is optimised with the oldest bank slot
       outside the window as gauge;
    4. the correction folds into the live state: the window (keyframes,
       current and template poses) moves rigidly by the newest keyframe's
       delta, bank slots outside the window take the optimum.

    Applied only if an edge was accepted, the correction of every valid
    bank slot is within the trust guard (online_loop_max_t/r), the newest
    keyframe moves more than the significance floor (the larger of the
    static floor and online_loop_noise_k × the worst accepted edge's
    round-trip error), a gauge exists outside the window, and the optimum
    is finite. The reference skips steps 3-4 with ``lax.cond`` when no edge
    is accepted; here they always run and ``torch.where`` keeps the state,
    so the call never syncs the host.
    """
    M = st.mem_valid.shape[0]
    m_new = index0(st.kf_mem, st.last_kf)
    props = loop_closure.propose_online(
        cfg, st.mem_desc, st.mem_valid, st.mem_stamp, m_new,
        index0(st.mem_thumb, m_new))
    meas = loop_closure.measure_edges(
        cfg, props, st.mem_T_wk, st.mem_thumb,
        st.mem_uv, st.mem_mask, st.mem_disp, st.mem_dmask)
    n_edges = meas.accept.sum().to(_I32)

    chain = pose_graph.chain_graph_stamped(st.mem_T_wk, st.mem_valid,
                                           st.mem_stamp)
    full = pose_graph.PoseGraph(
        edges_ij=torch.cat([chain.edges_ij, props.edges_ij]),
        Z=torch.cat([chain.Z, meas.Z]),
        weight=torch.cat([chain.weight, meas.accept.to(torch.float32)]))
    # gauge: the oldest bank slot not owned by the window (the fold below
    # moves owned slots rigidly with the window)
    owns = st.kf_valid & (st.mem_stamp[st.kf_mem] == st.kf_stamp)
    owned_mem = (keyframe._one_hot(st.kf_mem, M) & owns[None]).any(1)
    elig = st.mem_valid & ~owned_mem
    oldest = torch.argmin(torch.where(
        elig, st.mem_stamp, torch.full_like(st.mem_stamp,
                                            torch.iinfo(torch.int32).max)))
    T_opt, _ = pose_graph.optimize(st.mem_T_wk, st.mem_valid, full,
                                   n_iters=cfg.online_loop_iters,
                                   fixed=oldest)

    # trust guard over every valid slot's correction (owned slots move by
    # the newest keyframe's delta) and the adaptive significance floor
    T_new_opt = index0(T_opt, m_new)
    T_new_old = index0(st.mem_T_wk, m_new)
    dr, dt = se3.distance(T_new_opt, T_new_old)
    dr_all, dt_all = se3.distance(T_opt, st.mem_T_wk)
    zero = torch.zeros_like(dt_all)
    dt_max = torch.maximum(torch.where(elig, dt_all, zero).max(), dt)
    dr_max = torch.maximum(torch.where(elig, dr_all, zero).max(), dr)
    noise_t = torch.where(meas.accept, meas.rt_t,
                          torch.zeros_like(meas.rt_t)).max()
    noise_r = torch.where(meas.accept, meas.rt_r,
                          torch.zeros_like(meas.rt_r)).max()
    floor_t = torch.clamp(cfg.online_loop_noise_k * noise_t,
                          min=cfg.online_loop_min_t)
    floor_r = torch.clamp(cfg.online_loop_noise_k * noise_r,
                          min=cfg.online_loop_min_r)
    apply = ((n_edges > 0)
             & (dt_max < cfg.online_loop_max_t)
             & (dr_max < cfg.online_loop_max_r)
             & ((dt > floor_t) | (dr > floor_r))
             & elig.any() & torch.all(torch.isfinite(T_opt)))

    # the window moves rigidly by the newest keyframe's delta; the bank
    # outside it takes the optimum
    delta = se3.compose(T_new_opt, se3.inverse(T_new_old))
    kf_T_new = torch.where(st.kf_valid[:, None, None],
                           se3.compose(delta, st.kf_T_wk), st.kf_T_wk)
    mem_T_new = torch.where(
        owned_mem[:, None, None], se3.compose(delta, st.mem_T_wk),
        torch.where(st.mem_valid[:, None, None], T_opt, st.mem_T_wk))
    inv_d = se3.inverse(delta)
    return st._replace(
        kf_T_wk=torch.where(apply, kf_T_new, st.kf_T_wk),
        mem_T_wk=torch.where(apply, mem_T_new, st.mem_T_wk),
        T_cw=torch.where(apply, se3.compose(st.T_cw, inv_d), st.T_cw),
        T_pw=torch.where(apply, se3.compose(st.T_pw, inv_d), st.T_pw),
        n_loop_closures=torch.where(apply, st.n_loop_closures + n_edges,
                                    st.n_loop_closures),
        last_loop_mem=torch.where(apply, st.mem_next, st.last_loop_mem))


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
                    prev_ok: bool | torch.Tensor = True
                    ) -> Tuple[SlamState, TrackCtx]:
        """``prev_ok``: the host's copy of the previous frame's
        tracking_ok (False computes the rotated relocalisation variants),
        or a 0-dim bool tensor (the batched step): the variants are
        computed and count where it is False."""
        # --- 1. sparse direct alignment vs previous frame, seeded from the
        # constant-velocity prior or, after a failure, the relocalisation
        # keyframe ---
        T_init_vel = se3.exp(st.vel)
        reloc, reloc_score = loop_closure.relocalize(
            st.mem_desc, st.mem_valid, pyr_l[cfg.num_levels - 1],
            cfg.loop_desc_rows, cfg.loop_desc_cols,
            n_rot=cfg.pr_rot_variants, rot_step=cfg.pr_rot_step_rad,
            rot_gate=(~prev_ok if isinstance(prev_ok, torch.Tensor)
                      else not prev_ok))
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
            with profiling.stage("epi"):
                uv_epi, epi_ok, _ = depth_filter.epipolar_search(
                    cam, cfg, T_ck, st.kf_uv, st.mu, st.sigma2,
                    st.klt_tmpl.patches[lv_e], pyr_l[lv_e], lost_seed,
                    level=lv_e)
            recovered = lost_seed & epi_ok
            n_epi = recovered.sum().to(_I32)
            profiling.count("epi_recovered", lambda: n_epi)
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
                 T_cw: torch.Tensor, run_loop: bool = False) -> SlamState:
        """Insert the keyframe, run window BA, then the online loop closure
        when the host's ``run_loop`` (:func:`loop_due`) says it is due."""
        st = keyframe.insert(cfg, st, pyr_l, gxs, gys, img_r, T_cw)
        if cfg.use_ba:
            profiling.count("ba_keyframes", lambda: st.kf_valid.sum())
            with profiling.stage("ba"):
                st = run_window_ba(cfg, st)
        if run_loop:
            st = run_online_loop(cfg, st)
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


def loop_due(cfg: SvoConfig, mem_next, last_loop_mem):
    """The reference's online-loop cadence and cooldown, decided for the
    keyframe about to be inserted (the bank's ``mem_next`` before the
    insertion): every ``online_loop_every``-th keyframe created, and more
    than ``online_loop_cooldown`` keyframes after the last correction.
    Host ints give a bool, device tensors (with the loop on) a bool
    tensor."""
    if cfg.online_loop_every <= 0:
        return False
    n = mem_next + 1
    return ((n % cfg.online_loop_every == 0)
            & (n - last_loop_mem > cfg.online_loop_cooldown))


def _read_decisions(cfg: SvoConfig, st: SlamState, ctx: TrackCtx
                    ) -> List[Tuple[bool, bool, bool]]:
    """The step's one host sync: (need_kf, ok, run the online loop at this
    keyframe) of the tracked state and its TrackCtx, one sequence's or a
    batch's stacked ones, a tuple a sequence."""
    loop = cfg.online_loop_every > 0
    row = [ctx.need_kf, ctx.ok]
    if loop:
        row = [x.to(_I32) for x in row + [st.mem_next, st.last_loop_mem]]
    out = []
    for need_kf, ok, *counts in torch.stack(row, -1).reshape(
            -1, len(row)).tolist():
        need_kf, ok = bool(need_kf), bool(ok)
        out.append((need_kf, ok,
                    need_kf and loop and loop_due(cfg, *counts)))
    return out


def device_flags(state: SlamState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(booted, prev_ok): :func:`host_flags` as bool tensors on the state's
    device, with no read — 0-dim for one sequence, (B,) per sequence for a
    stacked state."""
    return state.kf_valid.any(-1), state.tracking_ok


def device_decisions(cfg: SvoConfig, st: SlamState, ctx: TrackCtx
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(need_kf, ok, run the online loop at this keyframe):
    :func:`_read_decisions` as bool tensors on the device, with no read —
    0-dim for one sequence, (B,) per sequence for a batch's stacked state
    and TrackCtx."""
    need_kf = ctx.need_kf
    if cfg.online_loop_every > 0:
        run_loop = need_kf & loop_due(cfg, st.mem_next, st.last_loop_mem)
    else:
        run_loop = torch.zeros_like(need_kf)
    return need_kf, ctx.ok, run_loop


def device_flags_batched(states: SlamState):
    """:func:`device_flags` of a stacked state, per sequence, with the
    batch's conds of the reference's batched step: (booted (B,),
    prev_ok (B,), any sequence to bootstrap — ``jnp.any(is_boot)`` —, any
    booted sequence whose last frame failed: the rotated relocalisation
    variants)."""
    booted, prev_ok = device_flags(states)
    return booted, prev_ok, (~booted).any(), (booted & ~prev_ok).any()


def device_decisions_batched(cfg: SvoConfig, sts: SlamState, ctx: TrackCtx,
                             booted: torch.Tensor):
    """:func:`device_decisions` of a batch, per sequence, with the batch's
    conds over its booted sequences: (need_kf, ok, run_loop, each (B,);
    any keyframe — ``jnp.any(need_kf)`` —, the online loop due in any)."""
    need_kf, ok, run_loop = device_decisions(cfg, sts, ctx)
    return (need_kf, ok, run_loop, (booted & need_kf).any(),
            (booted & run_loop).any())


def make_step(cfg: SvoConfig):
    """The per-frame step for a static config:
    ``step(state, img_l, img_r, flags=None) -> (state, FrameOut, flags)``.

    ``flags`` (``HostFlags``) carries what the host knows between frames;
    without it the step reads it from the state (one extra host sync).
    Images are contiguous float32 (H,W) tensors on the state's device.
    """
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
        (need_kf, ok, run_loop), = _read_decisions(cfg, st, ctx)
        if need_kf:
            st = kf_phase(st, *pyr, img_r, ctx.T_cw, run_loop)
        st, out = post_phase(st, *pyr, ctx)
        return st, out, HostFlags(booted=True, tracking_ok=ok)

    return step


def tree_where(cond: torch.Tensor, a, b):
    """``where(cond, a, b)`` leaf by leaf over two NamedTuple trees (nested
    ones too) of one structure; ``cond`` a 0-dim bool (per sequence under
    ``vmap``)."""
    return type(a)(*(tree_where(cond, x, y) if isinstance(x, tuple)
                     else torch.where(cond, x, y) for x, y in zip(a, b)))


class BatchedPhases(NamedTuple):
    """The per-frame phases over a batch of B sequences, each the
    ``torch.func.vmap`` of the single phase over a stacked state (every
    field with a leading B axis): every operation, and every kernel, runs
    once for the whole batch. What a phase keeps per sequence it keeps
    with ``where`` on device flags, as the reference's ``lax.cond`` under
    ``vmap`` does; the host picks a phase's variant for the whole batch.

    * ``pyramid(img_l)``: (B,H,W) → the batch's (levels, gxs, gys);
    * ``track(sts, pyr, img_r, any_failed)``: ``track_phase`` of every
      sequence; ``any_failed`` (host) computes the rotated relocalisation
      variants, which count for the sequences whose state says their last
      frame failed (``tracking_ok``);
    * ``kf(sts, pyr, img_r, ctx, run_loop)``: ``keyframe.insert`` and
      window BA, kept where ``ctx.need_kf``; ``run_loop`` (host: the loop
      is due in some sequence) adds the online loop, kept where it is due
      in that sequence (``loop_due`` of its counters);
    * ``post(sts, pyr, ctx)``: ``post_phase`` → (states, FrameOuts);
    * ``boot(sts, pyr, img_r, kept=None)``: ``boot`` of every sequence;
      with ``kept`` (the post phase's states and FrameOuts) a sequence
      keeps the bootstrap only where its state has no keyframe.
    """
    pyramid: object
    track: object
    kf: object
    post: object
    boot: object


def make_batched_phases(cfg: SvoConfig) -> BatchedPhases:
    """The :class:`BatchedPhases` of a configuration."""
    boot, track_phase, kf_phase, post_phase = make_phases(cfg)
    vmap = torch.func.vmap

    def pyr_b(img_l):
        return vmap(lambda im: pyramid.build_with_gradients(
            im, cfg.num_levels))(img_l)

    def track_b(sts, pyr, img_r, any_failed: bool):
        def one(st, p, r):
            return track_phase(st, *p, r, prev_ok=(
                st.tracking_ok if any_failed else True))
        return vmap(one)(sts, pyr, img_r)

    def kf_b(sts, pyr, img_r, ctx: TrackCtx, run_loop: bool):
        def one(st, p, r, T_cw, need_kf):
            new = kf_phase(st, *p, r, T_cw)
            if run_loop:
                due = loop_due(cfg, st.mem_next, st.last_loop_mem)
                new = tree_where(due, run_online_loop(cfg, new), new)
            return tree_where(need_kf, new, st)
        return vmap(one)(sts, pyr, img_r, ctx.T_cw, ctx.need_kf)

    def post_b(sts, pyr, ctx: TrackCtx):
        return vmap(lambda st, p, c: post_phase(st, *p, c))(sts, pyr, ctx)

    def boot_b(sts, pyr, img_r, kept=None):
        def one(st, p, r, *kept):
            booted = boot(st, *p, r)
            if not kept:
                return booted
            fresh = ~st.kf_valid.any()
            return tuple(tree_where(fresh, a, b)
                         for a, b in zip(booted, kept))
        return vmap(one)(sts, pyr, img_r, *(kept or ()))

    return BatchedPhases(pyr_b, track_b, kf_b, post_b, boot_b)


def host_flags_batched(states: SlamState) -> List[HostFlags]:
    """HostFlags of every sequence of a stacked state (one host sync)."""
    vals = torch.stack([states.kf_valid.any(-1),
                        states.tracking_ok], -1).tolist()
    return [HostFlags(bool(b), bool(ok)) for b, ok in vals]


def make_batched_step(cfg: SvoConfig):
    """The per-frame step over a batch of B sequences, as the reference's:
    ``bstep(states, img_l, img_r, flags=None) -> (states, outs, flags)``
    with a stacked state and FrameOut (every field with a leading B axis),
    (B,H,W) images and a list of B HostFlags.

    Each phase runs once over the whole batch (:class:`BatchedPhases`):
    the pyramid; ``track_phase`` (with the rotated variants when a booted
    sequence failed last frame); one host sync for the whole batch (every
    sequence's need_kf, ok and online-loop decision); the keyframe phase
    when a booted sequence needs a keyframe (with the online loop when it
    is due in one), kept per sequence with ``where``; the post phase; and
    the bootstrap when a sequence has no keyframe, kept per sequence with
    ``where``. A sequence's results are not bit for bit its single run's:
    batched reductions and batched linear algebra sum in another order
    (ROADMAP W7).
    """
    phases = make_batched_phases(cfg)

    def bstep(states: SlamState, img_l: torch.Tensor, img_r: torch.Tensor,
              flags: Optional[List[HostFlags]] = None
              ) -> Tuple[SlamState, FrameOut, List[HostFlags]]:
        if flags is None:
            flags = host_flags_batched(states)
        pyr = phases.pyramid(img_l)
        booted = [f.booted for f in flags]
        if not any(booted):
            sts, outs = phases.boot(states, pyr, img_r)
            return sts, outs, [HostFlags(True, True)] * len(flags)
        sts, ctx = phases.track(states, pyr, img_r, any_failed=not all(
            f.tracking_ok for f in flags if f.booted))
        decisions = _read_decisions(cfg, sts, ctx)
        ours = [d for d, b in zip(decisions, booted) if b]
        if any(need_kf for need_kf, _, _ in ours):
            sts = phases.kf(sts, pyr, img_r, ctx,
                            run_loop=any(loop for _, _, loop in ours))
        sts, outs = phases.post(sts, pyr, ctx)
        if not all(booted):
            sts, outs = phases.boot(states, pyr, img_r, (sts, outs))
        return sts, outs, [HostFlags(True, ok or not b)
                           for (_, ok, _), b in zip(decisions, booted)]

    return bstep


__all__ = ["make_step", "make_batched_step", "make_phases",
           "make_batched_phases", "BatchedPhases", "run_window_ba",
           "run_online_loop", "loop_due", "world_points", "HostFlags",
           "host_flags", "host_flags_batched", "device_flags",
           "device_decisions", "device_flags_batched",
           "device_decisions_batched", "tree_where"]
