"""Configuration, shared with the reference: ``stereo_svo_tpu/config.py``
loaded by path (it uses only dataclasses), so every knob has one source."""

from __future__ import annotations

from ._shared import load_reference_file

_ref = load_reference_file("config.py", "stereo_svo_tpu_torch._ref_config")

CameraConfig = _ref.CameraConfig
SvoConfig = _ref.SvoConfig
euroc_config = _ref.euroc_config
kitti_config = _ref.kitti_config
stress_config = _ref.stress_config

__all__ = ["CameraConfig", "SvoConfig", "euroc_config", "kitti_config",
           "stress_config"]
