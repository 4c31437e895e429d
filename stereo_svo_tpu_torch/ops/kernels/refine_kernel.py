"""Pose refinement in one launch, ``refine_pose_kernel``
(``svo::refine_pose``): the CUDA wrapper, its plain version and its launch
counter.

Source note. Replaces no Pallas kernel: it fuses the ``jnp`` chain of
``stereo_svo_tpu/frontend/pose_refine.py:refine`` (the chunked IRLS
Gauss-Newton of the motion-only pose refinement: every refresh pass, inner
pass and the last pass). Why: on the graphed main path that chain was
~2,050 kernel nodes a tracked frame (2.78 ms of a 5.9-ms frame on an
H100); it is one. What bounds it: the latency of its dependent passes (10
at the defaults), each a sweep over the N features (~100 flops a
feature), one reduction over the problem and, on a refresh pass, a 6×6
factorisation and solve; not bytes (~8 KB a pass) nor flops. Design: one thread block a problem, no
cluster (a pass is too little work to spread: a cluster barrier costs ~0.9
µs, a block's barrier and shuffle tree a fraction of that), one thread a
feature up to 1,024 threads; a warp shuffle tree and the warps in warp
order for every sum, no float atomics, so a call repeats bit for bit; the
refresh pass's camera points kept in shared memory, from which the inner
passes recompute its Jacobians; the 6×6 solve on the lanes of warp 0 by
``solve.chol_solve_small``'s rule, ``se3.exp``, ``se3.compose`` and
``se3.log`` (V⁻¹ as adjugate over determinant) on the device. Float32,
``-fmad=false``: the chain's arithmetic up to the order of its sums.
``csrc/pose_refine.cu`` gives the design in full.

The problem axis: B independent refinements in one launch (the batched
step's ``vmap`` over sequences), a block each; problem b equals its
one-problem launch bit for bit. On the CPU the op runs the plain version,
``frontend/pose_refine.refine_plain``, problem by problem; on CUDA the
kernel, with no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import _build
from .align_kernel import _check_lead
from .pyramid_kernel import _vmap_rule

# launches by counter (the kernels: ops.kernels.KERNELS)
LAUNCHES = {"refine_pose": 0}
REFINE_OUT = 13   # the op's float outputs a problem: T (12), RMS error


def _f32(x: float) -> float:
    return float(np.float32(x))


def _static(cam, cfg) -> Tuple[List[float], List[float], List[int]]:
    """The op's static arguments for ``cam`` and ``cfg``: the camera (fx,
    fy, cx, cy, baseline), the refiner's (Huber k, outlier threshold,
    stereo weight, prior sigmas of translation and rotation) and its
    schedule (refresh passes, inner passes after each)."""
    chunks = max(1, min(cfg.refine_irls_chunks, cfg.refine_max_iters))
    inner = max(cfg.refine_max_iters // chunks - 1, 0)
    return ([cam.fx, cam.fy, cam.cx, cam.cy, cam.baseline],
            [cfg.refine_huber_px, cfg.refine_outlier_px,
             cfg.refine_stereo_weight, cfg.refine_prior_t_sig,
             cfg.refine_prior_r_sig],
            [chunks, inner])


def _configs(camera: List[float], params: List[float], schedule: List[int]):
    """The (CameraConfig, SvoConfig) of the op's static arguments."""
    import dataclasses

    from ...config import CameraConfig, SvoConfig
    fx, fy, cx, cy, baseline = camera
    huber, outlier, stereo_w, t_sig, r_sig = params
    chunks, inner = schedule
    cam = CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy, baseline=baseline)
    cfg = dataclasses.replace(
        SvoConfig(camera=cam), refine_huber_px=huber,
        refine_outlier_px=outlier, refine_stereo_weight=stereo_w,
        refine_prior_t_sig=t_sig, refine_prior_r_sig=r_sig,
        refine_irls_chunks=chunks, refine_max_iters=chunks * (inner + 1))
    return cam, cfg


def refine_pose_plain(T_cw, X_world, uv_obs, mask, obs_sigma, T_prior,
                      disp_obs, disp_mask, obs_sigma_d, camera, params,
                      schedule):
    """Plain version of ``svo::refine_pose``: ``pose_refine.refine_plain``
    on each problem in turn; problem b exactly its call alone."""
    from ...frontend import pose_refine
    cam, cfg = _configs(camera, params, schedule)
    lead = T_cw.shape[:-2]
    n = T_cw[..., 0, 0].numel()
    N = X_world.shape[-2]

    def one(t):
        return None if t is None else t.reshape((n,) + t.shape[len(lead):])

    args = [one(t) for t in (T_cw, X_world, uv_obs, mask, obs_sigma,
                             T_prior, disp_obs, disp_mask, obs_sigma_d)]
    outs, counts, inliers = [], [], []
    for b in range(n):
        T, inl, stats = pose_refine.refine_plain(
            cam, cfg, *(a[b] for a in args[:4]),
            obs_sigma=None if args[4] is None else args[4][b],
            T_prior=None if args[5] is None else args[5][b],
            disp_obs=None if args[6] is None else args[6][b],
            disp_mask=None if args[7] is None else args[7][b],
            obs_sigma_d=None if args[8] is None else args[8][b])
        outs.append(torch.cat([T.reshape(12), stats["refine_rms_px"][None]]))
        counts.append(stats["refine_inliers"])
        inliers.append(inl)
    if n:
        out, cnt, inl = (torch.stack(outs), torch.stack(counts),
                         torch.stack(inliers))
    else:
        out = T_cw.new_empty((0, REFINE_OUT))
        cnt = T_cw.new_empty((0,), dtype=torch.int32)
        inl = mask.new_empty((0, N))
    return (out.reshape(lead + (REFINE_OUT,)), cnt.reshape(lead),
            inl.reshape(lead + (N,)))


@torch.library.custom_op("svo::refine_pose", mutates_args=())
def refine_pose_op(T_cw: torch.Tensor, X_world: torch.Tensor,
                   uv_obs: torch.Tensor, mask: torch.Tensor,
                   obs_sigma: Optional[torch.Tensor],
                   T_prior: Optional[torch.Tensor],
                   disp_obs: Optional[torch.Tensor],
                   disp_mask: Optional[torch.Tensor],
                   obs_sigma_d: Optional[torch.Tensor],
                   camera: List[float], params: List[float],
                   schedule: List[int]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B independent pose refinements: (*B,3,4) T_cw, (*B,N,3) world
    points, (*B,N,2) observations, (*B,N) bool mask; optional (*B,N)
    sigmas, (*B,3,4) motion prior (None: none), (*B,N) disparities with
    their (*B,N) bool mask (None: no disparity rows) and (*B,N) disparity
    sigmas; the static ``camera``, ``params`` and ``schedule`` of
    :func:`_static` → ((*B,13) [T row-major, RMS error], (*B,) int32
    inliers, (*B,N) bool inlier mask). On CUDA one ``refine_pose_kernel``
    launch for all of them."""
    if _build.plain(T_cw, X_world, uv_obs, mask, obs_sigma, T_prior,
                    disp_obs, disp_mask, obs_sigma_d):
        return refine_pose_plain(T_cw, X_world, uv_obs, mask, obs_sigma,
                                 T_prior, disp_obs, disp_mask, obs_sigma_d,
                                 camera, params, schedule)
    lead, N = T_cw.shape[:-2], X_world.shape[-2]
    f32, b8 = _build.F32, torch.bool
    huber, outlier, stereo_w, t_sig, r_sig = params
    if t_sig <= 0.0:   # refine_plain's predicates of the optional terms
        T_prior = None
    if disp_obs is None or disp_mask is None or stereo_w <= 0.0:
        disp_obs = disp_mask = None
    ptrs = []   # each array and its problem stride, in the C order
    for t, name, dtype, core in (
            (T_cw, "T_cw", f32, (3, 4)), (X_world, "X_world", f32, (N, 3)),
            (uv_obs, "uv_obs", f32, (N, 2)), (mask, "mask", b8, (N,)),
            (obs_sigma, "obs_sigma", f32, (N,)),
            (obs_sigma_d, "obs_sigma_d", f32, (N,)),
            (T_prior, "T_prior", f32, (3, 4)),
            (disp_obs, "disp_obs", f32, (N,)),
            (disp_mask, "disp_mask", b8, (N,))):
        if t is None:
            ptrs += [None, 0]
            continue
        if t.dtype != dtype:
            raise TypeError(f"{name}: {dtype} required, got {t.dtype}")
        _check_lead(lead, t, name, core)
        p, s = _build.problems(t, len(core))
        ptrs += [p.data_ptr(), s]
    n = T_cw[..., 0, 0].numel()
    if n > _build.MAX_PROBLEMS:
        raise ValueError(f"{n} problems: at most {_build.MAX_PROBLEMS}")
    fx, fy, cx, cy, baseline = camera
    intr = [_f32(fx), _f32(fy), _f32(cx), _f32(cy), _f32(fx * baseline)]
    par = [_f32(huber), _f32(outlier), _f32(stereo_w),
           _f32(1.0 / t_sig ** 2) if T_prior is not None else 0.0,
           _f32(1.0 / max(r_sig, 1e-6) ** 2)]
    dev = T_cw.device
    out = torch.empty((n, REFINE_OUT), dtype=f32, device=dev)
    cnt = torch.empty((n,), dtype=torch.int32, device=dev)
    inl = torch.empty((n, N), dtype=b8, device=dev)
    _build.raise_on_error(_build.load_library().svo_refine_pose(
        *ptrs, N, (ctypes.c_float * 5)(*intr), (ctypes.c_float * 5)(*par),
        int(schedule[0]), int(schedule[1]), out.data_ptr(), cnt.data_ptr(),
        inl.data_ptr(), n, _build.stream(dev)), "refine_pose")
    LAUNCHES["refine_pose"] += int(n > 0)
    return (out.reshape(lead + (REFINE_OUT,)), cnt.reshape(lead),
            inl.reshape(lead + (N,)))


@refine_pose_op.register_fake
def _(T_cw, X_world, uv_obs, mask, obs_sigma, T_prior, disp_obs, disp_mask,
      obs_sigma_d, camera, params, schedule):
    lead, N = T_cw.shape[:-2], X_world.shape[-2]
    return (T_cw.new_empty(lead + (REFINE_OUT,)),
            T_cw.new_empty(lead, dtype=torch.int32),
            mask.new_empty(lead + (N,)))


torch.library.register_vmap(refine_pose_op, _vmap_rule(refine_pose_op))


def refine_pose(cam, cfg, T_cw: torch.Tensor, X_world: torch.Tensor,
                uv_obs: torch.Tensor, mask: torch.Tensor,
                obs_sigma: torch.Tensor | None = None,
                T_prior: torch.Tensor | None = None,
                disp_obs: torch.Tensor | None = None,
                disp_mask: torch.Tensor | None = None,
                obs_sigma_d: torch.Tensor | None = None):
    """The whole of ``frontend/pose_refine.refine`` as one launch
    (``svo::refine_pose``; under ``vmap``, one launch for the batch), with
    its arguments and its return: (T_cw, inlier mask, stats)."""
    out, n_inl, inliers = refine_pose_op(
        T_cw, X_world, uv_obs, mask, obs_sigma, T_prior, disp_obs, disp_mask,
        obs_sigma_d, *_static(cam, cfg))
    return (out[..., :12].unflatten(-1, (3, 4)), inliers,
            {"refine_rms_px": out[..., 12], "refine_inliers": n_inl})
