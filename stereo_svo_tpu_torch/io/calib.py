"""Calibration loading: YAML (EuRoC/OpenCV style) → SvoConfig.

Reference parity: settings loader via cv::FileStorage into CameraSettings
(src/app/ [UNVERIFIED — SURVEY.md §0]; SURVEY.md §5.6). Supports both the
reference-style flat YAML (fx/fy/cx/cy/baseline keys) and EuRoC sensor.yaml
pairs (intrinsics + distortion + extrinsics, rectified via
datasets.StereoRectifier).

The port's own copy of ``stereo_svo_tpu/io/calib.py``. PyYAML is imported
inside the functions that read a file, so the package imports on a machine
without it and the readers raise a RuntimeError that names it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..config import CameraConfig, SvoConfig


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(
            "PyYAML (the 'yaml' package) is unavailable; cannot read "
            "calibration files") from e
    return yaml


def load_flat_yaml(path: str, base: Optional[SvoConfig] = None) -> SvoConfig:
    """Flat calibration file: fx, fy, cx, cy, baseline, width, height, plus
    optional algorithm knobs matching SvoConfig field names."""
    yaml = _yaml()
    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    base = base or SvoConfig()
    cam_fields = {f.name for f in dataclasses.fields(CameraConfig)}
    algo_fields = {f.name for f in dataclasses.fields(SvoConfig)} - {"camera"}
    cam_kwargs = {k: v for k, v in doc.items() if k in cam_fields}
    algo_kwargs = {k: v for k, v in doc.items() if k in algo_fields}
    cam = dataclasses.replace(base.camera, **cam_kwargs)
    return dataclasses.replace(base, camera=cam, **algo_kwargs)


def load_euroc_yaml_pair(path_cam0: str, path_cam1: str
                         ) -> Tuple[dict, dict]:
    """Parse the two EuRoC sensor.yaml files into raw calib dicts."""
    yaml = _yaml()
    out = []
    for p in (path_cam0, path_cam1):
        with open(p) as f:
            doc = yaml.safe_load(f)
        fu, fv, cu, cv_ = doc["intrinsics"]
        K = np.array([[fu, 0, cu], [0, fv, cv_], [0, 0, 1]], np.float64)
        D = np.asarray(doc["distortion_coefficients"], np.float64)
        T_BS = np.asarray(doc["T_BS"]["data"], np.float64).reshape(4, 4)
        w, h = doc["resolution"]
        out.append({"K": K, "D": D, "T_BS": T_BS, "size": (int(w), int(h))})
    return out[0], out[1]


def euroc_rectified_config(path_cam0: str, path_cam1: str,
                           base: Optional[SvoConfig] = None):
    """Build (SvoConfig, StereoRectifier) from EuRoC sensor.yaml files."""
    from .datasets import StereoRectifier

    c0, c1 = load_euroc_yaml_pair(path_cam0, path_cam1)
    # extrinsics cam1 ← cam0: T_c1_c0 = inv(T_B_c1) @ T_B_c0
    T = np.linalg.inv(c1["T_BS"]) @ c0["T_BS"]
    R, t = T[:3, :3], T[:3, 3]
    rect = StereoRectifier(c0["K"], c0["D"], c1["K"], c1["D"], R, t,
                           c0["size"])
    base = base or SvoConfig()
    cam = dataclasses.replace(
        base.camera, fx=rect.fx, fy=rect.fy, cx=rect.cx, cy=rect.cy,
        baseline=rect.baseline, width=c0["size"][0], height=c0["size"][1])
    return dataclasses.replace(base, camera=cam), rect
