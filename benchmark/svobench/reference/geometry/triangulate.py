"""Stereo and two-view triangulation — port of
``stereo_svo_tpu/geometry/triangulate.py``."""

from __future__ import annotations

import torch

from . import se3


def _rt_apply(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Rᵀ x for (…,3,3) and (…,3)."""
    return (R * x[..., :, None]).sum(-2)


def two_view_depth(T_cr: torch.Tensor, f_ref: torch.Tensor,
                   f_cur: torch.Tensor):
    """Depth along the reference bearing from a two-view correspondence
    (closed-form midpoint). Returns (depth_ref, valid)."""
    R = se3.rotation(T_cr)
    t = se3.translation(T_cr)
    Rt_f_cur = _rt_apply(R, f_cur)
    Rt_t = _rt_apply(R, t)
    A00 = torch.sum(f_ref * f_ref, -1)
    A01 = -torch.sum(f_ref * Rt_f_cur, -1)
    A11 = torch.sum(Rt_f_cur * Rt_f_cur, -1)
    b0 = -torch.sum(f_ref * Rt_t, -1)
    b1 = torch.sum(Rt_f_cur * Rt_t, -1)
    det = A00 * A11 - A01 * A01
    ok = torch.abs(det) > 1e-10
    det_s = torch.where(ok, det, torch.ones_like(det))
    d_ref = (A11 * b0 - A01 * b1) / det_s
    d_cur = (A00 * b1 - A01 * b0) / det_s
    valid = ok & (d_ref > 1e-3) & (d_cur > 1e-3)
    return torch.where(valid, d_ref, torch.ones_like(d_ref)), valid
