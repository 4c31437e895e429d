"""Trajectory evaluation, shared with the reference:
``stereo_svo_tpu/eval/ate.py`` loaded by path (numpy only)."""

from __future__ import annotations

from .._shared import load_reference_file

_ref = load_reference_file("eval/ate.py", "stereo_svo_tpu_torch._ref_ate")

align_umeyama = _ref.align_umeyama
ate_rmse = _ref.ate_rmse
rpe = _ref.rpe
positions = _ref.positions

__all__ = ["align_umeyama", "ate_rmse", "rpe", "positions"]
