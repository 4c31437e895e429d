"""Synthetic stereo sequences with exact ground truth — port of the
``planes`` scene and ``arc`` trajectory of ``stereo_svo_tpu/io/synthetic.py``
(textured planes ray-cast in closed form), so frames can be rendered on the
card without JAX. Other scenes, trajectories, anti-aliasing, photometric
perturbation and motion blur are not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import CameraConfig
from ..geometry import se3

_N_WAVES = 24


def _texture_params(seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Multi-octave plane-wave texture parameters (the reference's numpy
    generator, copied: its module imports jax)."""
    rng = np.random.default_rng(seed)
    freqs, amps, phases = [], [], []
    for octave in range(4):
        f0 = 0.7 * (2.2 ** octave)
        for _ in range(_N_WAVES // 4):
            ang = rng.uniform(0, 2 * math.pi)
            f = f0 * rng.uniform(0.7, 1.4)
            freqs.append([f * math.cos(ang), f * math.sin(ang)])
            amps.append(rng.uniform(0.5, 1.0) / (1.35 ** octave))
            phases.append(rng.uniform(0, 2 * math.pi))
    return (np.asarray(freqs, np.float32), np.asarray(amps, np.float32),
            np.asarray(phases, np.float32))


def _texture(p1: torch.Tensor, p2: torch.Tensor, params) -> torch.Tensor:
    freqs, amps, phases = params
    acc = torch.zeros_like(p1)
    for k in range(freqs.shape[0]):
        acc = acc + float(amps[k]) * torch.sin(
            2 * math.pi * (float(freqs[k, 0]) * p1 + float(freqs[k, 1]) * p2)
            + float(phases[k]))
    lo, hi = -float(np.sum(np.abs(amps))), float(np.sum(np.abs(amps)))
    return 10.0 + (acc - lo) / (hi - lo) * 235.0


class Plane(NamedTuple):
    normal: torch.Tensor   # (3,) world-frame unit normal
    d: torch.Tensor        # scalar: plane is n·x = d
    e1: torch.Tensor       # (3,) in-plane texture basis
    e2: torch.Tensor       # (3,)


def _intersect(prim: Plane, o: torch.Tensor, rays_w: torch.Tensor):
    """Ray-plane intersection for x = o + s·rays_w (s is camera z-depth).
    Returns (s, hit, p1, p2)."""
    if not isinstance(prim, Plane):
        raise TypeError(type(prim))
    denom = torch.sum(rays_w * prim.normal, -1)
    denom = torch.where(torch.abs(denom) < 1e-6,
                        torch.full_like(denom, 1e-6), denom)
    s = (prim.d - torch.sum(prim.normal * o)) / denom
    hit = s > 0.1
    x = o + s[..., None] * rays_w
    return s, hit, torch.sum(x * prim.e1, -1), torch.sum(x * prim.e2, -1)


def default_scene(seed: int = 0, device="cpu"):
    """Two tilted textured planes in front of the camera (z forward)."""
    def unit(v):
        v = np.asarray(v, np.float32)
        return v / np.linalg.norm(v)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    nA = unit([0.25, -0.15, -1.0])
    pA = Plane(t(nA), t(np.dot(nA, [0, 0, 4.0])),
               t(unit(np.cross(nA, [0, 1, 0]))),
               t(unit(np.cross(nA, np.cross(nA, [0, 1, 0])))))
    nB = unit([0.0, 0.0, -1.0])
    pB = Plane(t(nB), t(np.dot(nB, [0, 0, 14.0])), t([1.0, 0.0, 0.0]),
               t([0.0, 1.0, 0.0]))
    return (pA, pB), (_texture_params(seed), _texture_params(seed + 1))


def render_view(cam: CameraConfig, T_wc: torch.Tensor, scene) -> torch.Tensor:
    """Ray-cast one camera view (no anti-aliasing): (H, W) float32 in
    [0, 255]. T_wc: camera→world pose."""
    planes, textures = scene
    dev = T_wc.device
    u = torch.arange(cam.width, dtype=torch.float32, device=dev)
    v = torch.arange(cam.height, dtype=torch.float32, device=dev)
    uu, vv = torch.meshgrid(u, v, indexing="xy")            # (H, W)
    rx = (uu - cam.cx) / cam.fx
    ry = (vv - cam.cy) / cam.fy
    rays_c = torch.stack([rx, ry, torch.ones_like(rx)], -1)
    rays_w = torch.sum(rays_c[..., None, :] * se3.rotation(T_wc), -1)
    o = se3.translation(T_wc)
    img = torch.zeros((cam.height, cam.width), device=dev)
    depth = torch.full((cam.height, cam.width), float("inf"), device=dev)
    for prim, tex in zip(planes, textures):
        s, hit, p1, p2 = _intersect(prim, o, rays_w)
        closer = hit & (s < depth)                 # z-buffer → occlusion
        img = torch.where(closer, _texture(p1, p2, tex), img)
        depth = torch.where(closer, s, depth)
    return img


def right_camera_pose(cam: CameraConfig, T_wc_left: torch.Tensor
                      ) -> torch.Tensor:
    """Right camera pose: left shifted by +baseline along camera x."""
    t = torch.zeros(3, dtype=T_wc_left.dtype, device=T_wc_left.device)
    t[0] = cam.baseline
    offset = se3.make(torch.eye(3, dtype=T_wc_left.dtype,
                                device=T_wc_left.device), t)
    return se3.compose(T_wc_left, offset)


def render_stereo(cam: CameraConfig, T_wc: torch.Tensor, scene):
    return (render_view(cam, T_wc, scene),
            render_view(cam, right_camera_pose(cam, T_wc), scene))


def trajectory_pose(t: torch.Tensor, kind: str = "arc") -> torch.Tensor:
    """Ground-truth T_wc at time t: 'arc', gentle forward+sideways motion
    with yaw/roll."""
    if kind != "arc":
        raise ValueError(f"trajectory {kind!r} is not ported")
    xi = torch.stack([0.30 * torch.sin(0.7 * t),
                      0.10 * torch.sin(0.9 * t + 0.4), 0.25 * t,
                      0.03 * torch.sin(0.8 * t + 1.0),
                      0.06 * torch.sin(0.5 * t), 0.02 * torch.sin(1.1 * t)],
                     -1)
    return se3.exp(xi)


def make_sequence(cam: CameraConfig, n_frames: int, dt: float = 0.1,
                  kind: str = "arc", seed: int = 0,
                  scene_kind: str = "planes", device="cpu"):
    """Render a sequence on ``device``: tensors (N,H,W), (N,H,W), (N,3,4)
    of left images, right images and ground-truth T_wc."""
    if scene_kind not in ("planes", "default"):
        raise ValueError(f"scene {scene_kind!r} is not ported")
    scene = default_scene(seed, device)
    lefts, rights, poses = [], [], []
    for i in range(n_frames):
        T = trajectory_pose(torch.tensor(i * dt, dtype=torch.float32,
                                         device=device), kind)
        left, right = render_stereo(cam, T, scene)
        lefts.append(left)
        rights.append(right)
        poses.append(T)
    return torch.stack(lefts), torch.stack(rights), torch.stack(poses)
