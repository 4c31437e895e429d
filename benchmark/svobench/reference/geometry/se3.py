"""SE(3) Lie-group operations on (…,3,4) pose tensors — port of
``stereo_svo_tpu/geometry/se3.py``.

Convention (as the reference): T = [R|t] maps local → parent,
x_parent = R x_local + t; ``T_cw`` is world→camera; twists are (v, w),
translation first. Batched over leading dims, Taylor fallbacks at θ→0.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity pose as a (3,4) matrix."""
    return torch.cat([torch.eye(3, dtype=dtype, device=device),
                      torch.zeros((3, 1), dtype=dtype, device=device)], -1)


def make(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack rotation (…,3,3) and translation (…,3) into a (…,3,4) pose."""
    return torch.cat([R, t[..., None]], -1)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :, 3]


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (…,3) -> (…,3,3) skew matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: so(3) (…,3) -> SO(3) (…,3,3), stable near 0."""
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    W = hat(w)
    return _eye_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """SO(3) (…,3,3) -> so(3) (…,3). Stable for θ in [0, π)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    small = cos_t > 1.0 - 1e-5
    cos_safe = torch.where(small, torch.zeros_like(cos_t), cos_t)
    theta = torch.arccos(cos_safe)
    sin_safe = torch.sqrt(torch.clamp(1.0 - cos_safe * cos_safe, min=1e-12))
    scale_big = theta / (2.0 * sin_safe)
    one_m_c = 1.0 - cos_t
    scale_small = 0.5 + one_m_c / 6.0 + one_m_c * one_m_c * 7.0 / 90.0
    scale = torch.where(small, scale_small, scale_big)
    return scale[..., None] * vee


def _V(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3): V s.t. exp_se3 translation = V @ v."""
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    W = hat(w)
    return _eye_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist (…,6) = (v,w) -> SE(3) pose (…,3,4)."""
    v, w = xi[..., :3], xi[..., 3:]
    return make(exp_so3(w), (_V(w) @ v[..., None])[..., 0])


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) (…,3,4) -> twist (…,6) = (v,w). Inverse of exp."""
    w = log_so3(rotation(T))
    # inv_ex: no error check, so no host sync on CUDA (V is ≈ I here)
    Vinv = torch.linalg.inv_ex(_V(w)).inverse
    v = (Vinv @ translation(T)[..., None])[..., 0]
    return torch.cat([v, w], -1)


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A ∘ B: apply B first, then A. (…,3,4) x (…,3,4) -> (…,3,4)."""
    Ra, ta = rotation(A), translation(A)
    Rb, tb = rotation(B), translation(B)
    return make(Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta)


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = rotation(T).transpose(-1, -2)
    return make(Rt, -(Rt @ translation(T)[..., None])[..., 0])


def transform(T: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply pose to points: (…,3,4) x (…,3) -> (…,3)."""
    R = rotation(T)
    # explicit products and sums (not a matmul): the same arithmetic on
    # CPU and CUDA, and broadcasting (3,4) against (N,3) like the einsum
    return (R * x[..., None, :]).sum(-1) + translation(T)


def distance(A: torch.Tensor, B: torch.Tensor):
    """(rotation angle, translation norm) between two poses."""
    rel = compose(inverse(A), B)
    w = log_so3(rotation(rel))
    return (torch.linalg.vector_norm(w, dim=-1),
            torch.linalg.vector_norm(translation(rel), dim=-1))
