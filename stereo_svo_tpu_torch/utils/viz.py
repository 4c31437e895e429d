"""Host-side visualization dumps — the reference's Qt viewer replacement.

SURVEY.md §5.5/§7.4: no GUI rebuild; instead, overlay renderers that dump
annotated frames (feature states, colors by type/convergence like the
reference's keypoint overlay) and trajectory plots to image files.

Port of ``stereo_svo_tpu/utils/viz.py``. OpenCV is imported inside the two
functions (a machine without it gets a RuntimeError that names it); the
state's tensors are moved to the host here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..engine.state import (STATUS_LANDMARK, STATUS_SEED, SlamState)

# BGR colors mirroring the reference viewer's semantics:
_COLOR = {
    STATUS_SEED: (0, 215, 255),      # amber: depth filter still converging
    STATUS_LANDMARK: (80, 220, 80),  # green: converged landmark
}


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "OpenCV (the 'cv2' package) is unavailable; cannot draw "
            "overlays") from e
    return cv2


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def draw_features(img: np.ndarray, state: SlamState,
                  path: Optional[str] = None) -> np.ndarray:
    """Overlay tracked features on a grayscale frame; returns BGR image."""
    cv2 = _cv2()
    vis = cv2.cvtColor(_host(img).astype(np.float32).astype(np.uint8),
                       cv2.COLOR_GRAY2BGR)
    uv = _host(state.feat_uv)
    status = _host(state.status)
    for i in range(len(uv)):
        if status[i] == 0:
            continue
        c = _COLOR.get(int(status[i]), (200, 200, 200))
        cv2.circle(vis, (int(uv[i, 0]), int(uv[i, 1])), 3, c, 1,
                   lineType=cv2.LINE_AA)
    if path:
        cv2.imwrite(path, vis)
    return vis


def draw_trajectory(T_wc: np.ndarray, gt: Optional[np.ndarray] = None,
                    path: Optional[str] = None, size: int = 600
                    ) -> np.ndarray:
    """Top-down (x,z) trajectory plot; optional ground truth in gray."""
    cv2 = _cv2()
    canvas = np.full((size, size, 3), 255, np.uint8)
    pts = _host(T_wc)[:, :, 3][:, [0, 2]]
    all_pts = pts if gt is None else np.concatenate(
        [pts, _host(gt)[:, :, 3][:, [0, 2]]])
    lo = all_pts.min(0) - 0.5
    hi = all_pts.max(0) + 0.5
    scale = (size - 40) / max(float((hi - lo).max()), 1e-6)

    def to_px(p):
        q = (p - lo) * scale + 20
        return int(q[0]), size - int(q[1])

    if gt is not None:
        g = _host(gt)[:, :, 3][:, [0, 2]]
        for i in range(1, len(g)):
            cv2.line(canvas, to_px(g[i - 1]), to_px(g[i]), (180, 180, 180),
                     2, cv2.LINE_AA)
    for i in range(1, len(pts)):
        cv2.line(canvas, to_px(pts[i - 1]), to_px(pts[i]), (180, 80, 20), 2,
                 cv2.LINE_AA)
    if path:
        cv2.imwrite(path, canvas)
    return canvas
