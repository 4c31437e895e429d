"""Rectified pinhole camera + projection Jacobians — port of
``stereo_svo_tpu/geometry/camera.py``. Twist layout (v, w)."""

from __future__ import annotations

import numpy as np
import torch

from ..config import CameraConfig
from . import se3


def intrinsics(cam: CameraConfig, level: int = 0):
    """(fx, fy, cx, cy) at a pyramid level (each level halves resolution).

    Python floats rounded through float32, as the reference's f32 scalars.
    """
    s = 1.0 / (2 ** level)
    return tuple(float(np.float32(x * s))
                 for x in (cam.fx, cam.fy, cam.cx, cam.cy))


def project(cam: CameraConfig, x_cam: torch.Tensor, level: int = 0):
    """Camera-frame points (…,3) -> (pixels (…,2), valid z > 1e-3)."""
    fx, fy, cx, cy = intrinsics(cam, level)
    z = x_cam[..., 2]
    valid = z > 1e-3
    zs = torch.where(valid, z, torch.ones_like(z))
    u = fx * x_cam[..., 0] / zs + cx
    v = fy * x_cam[..., 1] / zs + cy
    return torch.stack([u, v], -1), valid


def backproject(cam: CameraConfig, uv: torch.Tensor, depth: torch.Tensor,
                level: int = 0) -> torch.Tensor:
    """Pixels (…,2) + depth (…) -> camera-frame points (…,3)."""
    fx, fy, cx, cy = intrinsics(cam, level)
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth.expand_as(x)], -1)


def disparity_to_depth(cam: CameraConfig, disp: torch.Tensor) -> torch.Tensor:
    """Rectified stereo: z = fx * baseline / d."""
    return cam.fx * cam.baseline / torch.clamp(disp, min=1e-3)


def proj_jacobian(cam: CameraConfig, x_cam: torch.Tensor, level: int = 0):
    """d(u,v)/d(x_cam): (…,2,3) for camera-frame point (…,3)."""
    fx, fy, _, _ = intrinsics(cam, level)
    x, y, z = x_cam[..., 0], x_cam[..., 1], x_cam[..., 2]
    iz = 1.0 / torch.clamp(z, min=1e-3)
    iz2 = iz * iz
    zeros = torch.zeros_like(x)
    row_u = torch.stack([fx * iz, zeros, -fx * x * iz2], -1)
    row_v = torch.stack([zeros, fy * iz, -fy * y * iz2], -1)
    return torch.stack([row_u, row_v], -2)


def proj_pose_jacobian(cam: CameraConfig, x_cam: torch.Tensor,
                       level: int = 0):
    """d(u,v)/d(xi) for a left-multiplied twist on T_cw: (…,2,6)."""
    Jp = proj_jacobian(cam, x_cam, level)                  # (…,2,3)
    J_w = -(Jp[..., :, :, None] * se3.hat(x_cam)[..., None, :, :]).sum(-2)
    return torch.cat([Jp, J_w], -1)


def affine_warp_matrix(cam: CameraConfig, uv_ref: torch.Tensor,
                       z_ref: torch.Tensor, T_cr: torch.Tensor
                       ) -> torch.Tensor:
    """First-order pixel warp A = ∂uv_cur/∂uv_ref around a feature (…,2,2)
    under relative pose T_cr (ref→cur), assuming locally constant depth:
    A = J_proj(x_cur) · R_cr · J_backproj(z_ref)."""
    x_cur = se3.transform(T_cr, backproject(cam, uv_ref, z_ref))
    Jp = proj_jacobian(cam, x_cur)                        # (…,2,3)
    fx, fy, _, _ = intrinsics(cam, 0)
    zero = torch.zeros_like(z_ref)
    # d backproject / d uv at fixed depth: z · diag(1/fx, 1/fy), third row 0
    Jb = torch.stack([torch.stack([(1.0 / fx) * z_ref, zero, zero], -1),
                      torch.stack([zero, (1.0 / fy) * z_ref, zero], -1)],
                     -1)
    return Jp @ T_cr[..., :3, :3] @ Jb


def in_bounds(cam: CameraConfig, uv: torch.Tensor, level: int = 0,
              margin: float = 0.0) -> torch.Tensor:
    """Mask of pixels inside the level-l image with a margin."""
    h = cam.height // (2 ** level)
    w = cam.width // (2 ** level)
    u, v = uv[..., 0], uv[..., 1]
    return ((u >= margin) & (u <= w - 1 - margin)
            & (v >= margin) & (v <= h - 1 - margin))
