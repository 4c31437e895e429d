"""Dataset ingestion: EuRoC, KITTI odometry, video files, image dirs.

Reference parity: the app layer's ``ImageInput`` interface with EuRoC /
KITTI / video / live-camera implementations (src/app/*input*
[UNVERIFIED — SURVEY.md §0]; SURVEY.md §2.1). Host-side only: decode +
rectify on CPU, feed float32 arrays to the device engine
(SURVEY.md §3.4). The live V4L2 camera input is intentionally out of scope
(SURVEY.md §7.4).

All readers yield (left, right, timestamp) with images as float32 (H, W)
in [0, 255].

The port's own copy of ``stereo_svo_tpu/io/datasets.py``. OpenCV is
imported inside the functions that decode or rectify, so the package
imports on a machine without it: there those functions raise a
RuntimeError that names the package, while the CSV, pose-file and
directory readers (``euroc_ground_truth``, ``kitti_poses``) work.
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, Optional, Tuple

import numpy as np

Frame = Tuple[np.ndarray, np.ndarray, float]


def _cv2(purpose: str):
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"OpenCV (the 'cv2' package) is unavailable; cannot {purpose}"
        ) from e
    return cv2


def _imread_gray(path: str) -> np.ndarray:
    cv2 = _cv2("decode images")
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32)


class StereoRectifier:
    """Optional rectification from full calibration (distortion + extrinsics).

    EuRoC raw images are distorted; the reference rectifies via OpenCV
    before the SLAM core sees them. Same here, once per sequence.
    """

    def __init__(self, K0, D0, K1, D1, R, T, size):
        cv2 = _cv2("rectify")
        T = np.asarray(T, np.float64).reshape(3, 1)
        R = np.asarray(R, np.float64)
        R0, R1, P0, P1, _, _, _ = cv2.stereoRectify(
            K0, np.asarray(D0, np.float64), K1, np.asarray(D1, np.float64),
            size, R, T, flags=cv2.CALIB_ZERO_DISPARITY, alpha=0)
        self.map0 = cv2.initUndistortRectifyMap(K0, D0, R0, P0, size,
                                                cv2.CV_32FC1)
        self.map1 = cv2.initUndistortRectifyMap(K1, D1, R1, P1, size,
                                                cv2.CV_32FC1)
        self.P0, self.P1 = P0, P1
        # rectified pinhole params for SvoConfig
        self.fx = float(P0[0, 0])
        self.fy = float(P0[1, 1])
        self.cx = float(P0[0, 2])
        self.cy = float(P0[1, 2])
        self.baseline = float(-P1[0, 3] / P1[0, 0])

    def __call__(self, left: np.ndarray, right: np.ndarray):
        cv2 = _cv2("rectify")
        l = cv2.remap(left, *self.map0, interpolation=cv2.INTER_LINEAR)
        r = cv2.remap(right, *self.map1, interpolation=cv2.INTER_LINEAR)
        return l, r


def euroc_frames(root: str, rectifier: Optional[StereoRectifier] = None
                 ) -> Iterator[Frame]:
    """EuRoC ASL layout: <root>/mav0/cam{0,1}/data.csv + data/*.png."""
    cam0 = os.path.join(root, "mav0", "cam0")
    cam1 = os.path.join(root, "mav0", "cam1")
    with open(os.path.join(cam0, "data.csv")) as f:
        rows = [r for r in csv.reader(f) if r and not r[0].startswith("#")]
    for ts, fname in rows:
        p0 = os.path.join(cam0, "data", fname.strip())
        p1 = os.path.join(cam1, "data", fname.strip())
        if not (os.path.exists(p0) and os.path.exists(p1)):
            continue
        l, r = _imread_gray(p0), _imread_gray(p1)
        if rectifier is not None:
            l, r = rectifier(l, r)
        yield l, r, float(ts) * 1e-9


def euroc_ground_truth(root: str) -> Tuple[np.ndarray, np.ndarray]:
    """EuRoC ground truth: (timestamps (N,), positions (N,3))."""
    path = os.path.join(root, "mav0", "state_groundtruth_estimate0",
                        "data.csv")
    ts, pos = [], []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            ts.append(float(row[0]) * 1e-9)
            pos.append([float(row[1]), float(row[2]), float(row[3])])
    return np.asarray(ts), np.asarray(pos)


def kitti_frames(root: str, seq: str) -> Iterator[Frame]:
    """KITTI odometry layout: <root>/sequences/<seq>/image_{0,1}/*.png."""
    base = os.path.join(root, "sequences", seq)
    times_path = os.path.join(base, "times.txt")
    times = None
    if os.path.exists(times_path):
        times = [float(x) for x in open(times_path)]
    d0 = os.path.join(base, "image_0")
    d1 = os.path.join(base, "image_1")
    names = sorted(os.listdir(d0))
    for i, name in enumerate(names):
        l = _imread_gray(os.path.join(d0, name))
        r = _imread_gray(os.path.join(d1, name))
        yield l, r, (times[i] if times else i * 0.1)


def kitti_poses(path: str) -> np.ndarray:
    """KITTI pose file: each line 12 floats row-major (3,4) cam→world."""
    rows = []
    for line in open(path):
        vals = [float(x) for x in line.split()]
        if len(vals) == 12:
            rows.append(np.asarray(vals).reshape(3, 4))
    return np.stack(rows)


def video_frames(path_left: str, path_right: Optional[str] = None,
                 fps_fallback: float = 30.0) -> Iterator[Frame]:
    """Generic video input: one side-by-side stereo file, or two files."""
    cv2 = _cv2("decode video")
    capL = cv2.VideoCapture(path_left)
    capR = cv2.VideoCapture(path_right) if path_right else None
    fps = capL.get(cv2.CAP_PROP_FPS) or fps_fallback
    idx = 0
    while True:
        okL, frameL = capL.read()
        if not okL:
            break
        grayL = cv2.cvtColor(frameL, cv2.COLOR_BGR2GRAY).astype(np.float32)
        if capR is not None:
            okR, frameR = capR.read()
            if not okR:
                break
            grayR = cv2.cvtColor(frameR, cv2.COLOR_BGR2GRAY).astype(np.float32)
        else:  # side-by-side stereo in one stream
            w = grayL.shape[1] // 2
            grayL, grayR = grayL[:, :w], grayL[:, w:]
        yield grayL, grayR, idx / fps
        idx += 1
    capL.release()
    if capR is not None:
        capR.release()
