"""Trajectory export in standard evaluation formats (TUM / KITTI).

Reference parity: trajectory export for the Python evaluation scripts
(SURVEY.md §2.1 "Main CLI app", §7.4 "keep trajectory-format compatibility
with standard evaluation tooling").

The port's own copy of ``stereo_svo_tpu/io/trajectory.py`` (numpy only):
the two packages write the same bytes for the same poses, which the tests
hold.
"""

from __future__ import annotations

import numpy as np


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → quaternion (x, y, z, w), TUM convention."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        x, y, z, w = q
    return np.asarray([x, y, z, w])


def save_tum(path: str, T_wc: np.ndarray, timestamps=None) -> None:
    """TUM format: 'ts tx ty tz qx qy qz qw' per line."""
    T_wc = np.asarray(T_wc)
    n = len(T_wc)
    ts = timestamps if timestamps is not None else np.arange(n, dtype=float)
    with open(path, "w") as f:
        for i in range(n):
            t = T_wc[i, :, 3]
            q = _rot_to_quat(T_wc[i, :, :3])
            f.write(f"{ts[i]:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def save_kitti(path: str, T_wc: np.ndarray) -> None:
    """KITTI format: 12 floats (row-major 3x4) per line."""
    with open(path, "w") as f:
        for T in np.asarray(T_wc):
            f.write(" ".join(f"{v:.9e}" for v in T.reshape(-1)) + "\n")


def load_tum(path: str):
    """Returns (timestamps (N,), positions (N,3))."""
    ts, pos = [], []
    for line in open(path):
        vals = line.split()
        if len(vals) >= 4 and not line.startswith("#"):
            ts.append(float(vals[0]))
            pos.append([float(v) for v in vals[1:4]])
    return np.asarray(ts), np.asarray(pos)
