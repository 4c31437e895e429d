"""The frozen renderer: textured planes ray-cast in closed form
(z-buffered), the known trajectories and the stereo rig — a copy of the
program's ``io/synthetic`` scenes ``planes`` and ``road`` as they stood when
the benchmark was written, so that a change to the program never moves the
inputs. Frames are rendered on the device in chunks of frames, each pixel
by the same arithmetic as the program's one-frame renderer (equal bit for
bit on the CPU: ``benchmark/tests/test_bench_render.py``)."""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .reference.geometry import se3

_N_WAVES = 24
CHUNK = 16          # frames rendered in one pass


def texture_params(seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Multi-octave plane-wave texture parameters of ``seed``."""
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
    d: torch.Tensor        # scalar: the plane is n·x = d
    e1: torch.Tensor       # (3,) in-plane texture basis
    e2: torch.Tensor       # (3,)


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v)


def _plane(n, point, e1, e2, device) -> Plane:
    return Plane(*(torch.as_tensor(np.asarray(a, np.float32), device=device)
                   for a in (n, np.dot(n, point), e1, e2)))


def _ground(normal, point, device) -> Plane:
    n = _unit(normal)
    return _plane(n, point, _unit(np.cross(n, [0, 0, 1.0])),
                  _unit(np.cross(n, np.cross(n, [0, 0, 1.0]))), device)


def _backdrop(z: float, device) -> Plane:
    return _plane(_unit([0.0, 0.0, -1.0]), [0, 0, z], [1.0, 0.0, 0.0],
                  [0.0, 1.0, 0.0], device)


def planes_scene(seed: int, device):
    """Two tilted textured planes in front of the camera (z forward)."""
    nA = _unit([0.25, -0.15, -1.0])
    pA = _plane(nA, [0, 0, 4.0], _unit(np.cross(nA, [0, 1, 0])),
                _unit(np.cross(nA, np.cross(nA, [0, 1, 0]))), device)
    return ((pA, _backdrop(14.0, device)),
            (texture_params(seed), texture_params(seed + 1)))


def road_scene(seed: int, device, length: float = 60.0,
               wall_tilt: float = 0.06):
    """KITTI-like deep scene: road plane, two building walls converging at
    x = 7/wall_tilt m, a backdrop at ``length`` m."""
    prims = [_ground([0.0, -1.0, -0.02], [0, 1.65, 0], device)]
    for sx in (-1.0, 1.0):
        nW = _unit([-sx, 0.0, -wall_tilt])
        prims.append(_plane(nW, [sx * 7.0, 0, 0],
                            _unit(np.cross(nW, [0, 1.0, 0])),
                            [0.0, 1.0, 0.0], device))
    prims.append(_backdrop(length, device))
    texs = tuple(texture_params(seed + 10 * k) for k in range(len(prims)))
    return tuple(prims), texs


SCENES = {"planes": planes_scene, "road": road_scene}

# (tx, ty, tz, wx, wy, wz) of each trajectory as (amplitude, frequency,
# phase) sine terms, or ("lin", rate) for a linear term
TRAJECTORIES = {
    "arc": ((0.30, 0.7, 0.0), (0.10, 0.9, 0.4), ("lin", 0.25),
            (0.03, 0.8, 1.0), (0.06, 0.5, 0.0), (0.02, 1.1, 0.0)),
    "loop": ((0.20, 0.5, 0.0), (0.05, 0.9, 0.0), (0.8, 0.35, 0.0),
             (0.02, 0.7, 0.0), (0.05, 0.45, 0.0), (0.015, 1.0, 0.0)),
    "kitti": ((0.08, 0.5, 0.0), (0.02, 0.9, 0.0), ("lin", 1.5),
              (0.01, 0.8, 0.0), (0.17, 0.18, 0.0), (0.008, 1.1, 0.0)),
}


def trajectory_pose(t: torch.Tensor, kind: str) -> torch.Tensor:
    """Ground-truth T_wc (3,4) at time t (a 0-dim tensor: frame index ·
    dt)."""
    terms = []
    for term in TRAJECTORIES[kind]:
        if term[0] == "lin":
            terms.append(term[1] * t)
        elif term[2] == 0.0:
            terms.append(term[0] * torch.sin(term[1] * t))
        else:
            terms.append(term[0] * torch.sin(term[1] * t + term[2]))
    return se3.exp(torch.stack(terms, -1))


def right_camera_pose(baseline: float, T_wc_left: torch.Tensor
                      ) -> torch.Tensor:
    """The right camera: the left shifted by +baseline along camera x."""
    t = torch.zeros(3, dtype=T_wc_left.dtype, device=T_wc_left.device)
    t[0] = baseline
    offset = se3.make(torch.eye(3, dtype=T_wc_left.dtype,
                                device=T_wc_left.device), t)
    return se3.compose(T_wc_left, offset)


def _render_pass(cam: dict, T_wc: torch.Tensor, scene, du: float,
                 dv: float) -> torch.Tensor:
    """Ray-cast the (F,3,4) poses at pixel centres + (du, dv): (F,H,W)."""
    prims, textures = scene
    dev = T_wc.device
    H, W = cam["height"], cam["width"]
    u = torch.arange(W, dtype=torch.float32, device=dev)
    v = torch.arange(H, dtype=torch.float32, device=dev)
    uu, vv = torch.meshgrid(u, v, indexing="xy")            # (H, W)
    rx = (uu + du - cam["cx"]) / cam["fx"]
    ry = (vv + dv - cam["cy"]) / cam["fy"]
    rays_c = torch.stack([rx, ry, torch.ones_like(rx)], -1)
    R = se3.rotation(T_wc)[:, None, None]                    # (F,1,1,3,3)
    rays_w = torch.sum(rays_c[None, ..., None, :] * R, -1)   # (F,H,W,3)
    o = se3.translation(T_wc)                                # (F,3)
    F = T_wc.shape[0]
    img = torch.zeros((F, H, W), device=dev)
    depth = torch.full((F, H, W), float("inf"), device=dev)
    for prim, tex in zip(prims, textures):
        denom = torch.sum(rays_w * prim.normal, -1)
        denom = torch.where(torch.abs(denom) < 1e-6,
                            torch.full_like(denom, 1e-6), denom)
        s = (prim.d - torch.sum(prim.normal * o, -1))[:, None, None] / denom
        hit = s > 0.1
        x = o[:, None, None, :] + s[..., None] * rays_w
        p1 = torch.sum(x * prim.e1, -1)
        p2 = torch.sum(x * prim.e2, -1)
        closer = hit & (s < depth)                 # z-buffer → occlusion
        img = torch.where(closer, _texture(p1, p2, tex), img)
        depth = torch.where(closer, s, depth)
    return img


def render_views(cam: dict, T_wc: torch.Tensor, scene,
                 aa: int = 1) -> torch.Tensor:
    """(F,H,W) float32 views in [0, 255] of the (F,3,4) camera→world
    poses; ``aa`` > 1 box-filters an aa×aa sub-pixel grid."""
    if aa == 1:
        return _render_pass(cam, T_wc, scene, 0.0, 0.0)
    offs = [(k + 0.5) / aa - 0.5 for k in range(aa)]
    acc = None
    for dv in offs:
        for du in offs:
            img = _render_pass(cam, T_wc, scene, du, dv)
            acc = img if acc is None else acc + img
    return acc / (aa * aa)


def render_sequence(cam: dict, n_frames: int, dt: float, trajectory: str,
                    scene: str, seed: int, aa: int = 1, device="cuda"):
    """A stereo sequence on ``device``: (T,H,W) left and right float32
    images and the (T,3,4) ground-truth camera→world poses, frame i at
    time i·dt. Float32 products with TF32 off, whatever the process's
    setting."""
    device = torch.device(device)
    built = SCENES[scene](seed, device)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        poses = torch.stack([
            trajectory_pose(torch.tensor(i * dt, dtype=torch.float32,
                                         device=device), trajectory)
            for i in range(n_frames)])
        rights_T = torch.stack([right_camera_pose(cam["baseline"], T)
                                for T in poses])
        lefts = torch.empty((n_frames, cam["height"], cam["width"]),
                            dtype=torch.float32, device=device)
        rights = torch.empty_like(lefts)
        for a in range(0, n_frames, CHUNK):
            b = min(a + CHUNK, n_frames)
            lefts[a:b] = render_views(cam, poses[a:b], built, aa)
            rights[a:b] = render_views(cam, rights_T[a:b], built, aa)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return lefts, rights, poses
