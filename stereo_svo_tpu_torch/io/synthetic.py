"""Synthetic stereo sequences with exact ground truth — port of
``stereo_svo_tpu/io/synthetic.py``: textured planes and spheres ray-cast in
closed form (z-buffered, so spheres occlude), known trajectories, and the
photometric nuisance model, so frames can be rendered on the card without
JAX.

Scenes and sequences are built on the card unless ``device="cpu"``.
``perturb_stereo`` draws from an explicit ``torch.Generator`` on the
images' device; its random draws cannot match the reference's JAX PRNG,
only its distribution and its deterministic part (vignette, clip).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import CameraConfig
from ..device import resolve
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


class Sphere(NamedTuple):
    center: torch.Tensor   # (3,) world-frame centre
    radius: torch.Tensor   # scalar
    e1: torch.Tensor       # (3,) texture projection basis
    e2: torch.Tensor       # (3,)


def _intersect(prim, o: torch.Tensor, rays_w: torch.Tensor):
    """Ray-primitive intersection for x = o + s·rays_w. The rays have unit
    z in the camera frame, so s is the camera z-depth for every primitive.
    Returns (s, hit, p1, p2): depth, hit mask, texture coordinates."""
    if isinstance(prim, Plane):
        denom = torch.sum(rays_w * prim.normal, -1)
        denom = torch.where(torch.abs(denom) < 1e-6,
                            torch.full_like(denom, 1e-6), denom)
        s = (prim.d - torch.sum(prim.normal * o)) / denom
        hit = s > 0.1
    elif isinstance(prim, Sphere):
        oc = o - prim.center
        a = torch.sum(rays_w * rays_w, -1)
        b = 2.0 * torch.sum(rays_w * oc, -1)
        c0 = torch.sum(oc * oc) - prim.radius ** 2
        disc = b * b - 4.0 * a * c0
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        s = (-b - sq) / (2.0 * a)                 # near intersection
        hit = (disc > 0.0) & (s > 0.1)
        s = torch.where(hit, s, torch.full_like(s, 1e9))
    else:
        raise TypeError(type(prim))
    x = o + s[..., None] * rays_w
    return s, hit, torch.sum(x * prim.e1, -1), torch.sum(x * prim.e2, -1)


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v)


def _plane(n, point, e1, e2, device) -> Plane:
    """Plane n·x = n·point for a unit normal ``n``."""
    return Plane(*(torch.as_tensor(np.asarray(a, np.float32), device=device)
                   for a in (n, np.dot(n, point), e1, e2)))


def _ground(normal, point, device) -> Plane:
    """A plane textured along its own axes (the reference's ground/road)."""
    n = _unit(normal)
    return _plane(n, point, _unit(np.cross(n, [0, 0, 1.0])),
                  _unit(np.cross(n, np.cross(n, [0, 0, 1.0]))), device)


def _backdrop(z: float, device) -> Plane:
    return _plane(_unit([0.0, 0.0, -1.0]), [0, 0, z], [1.0, 0.0, 0.0],
                  [0.0, 1.0, 0.0], device)


def default_scene(seed: int = 0, device="cuda"):
    """Two tilted textured planes in front of the camera (z forward)."""
    device = resolve(device)
    nA = _unit([0.25, -0.15, -1.0])
    pA = _plane(nA, [0, 0, 4.0], _unit(np.cross(nA, [0, 1, 0])),
                _unit(np.cross(nA, np.cross(nA, [0, 1, 0]))), device)
    return ((pA, _backdrop(14.0, device)),
            (_texture_params(seed), _texture_params(seed + 1)))


def cluttered_scene(seed: int = 0, n_spheres: int = 6, device="cuda"):
    """Non-planar scene: backdrop + ground plane + textured spheres at mixed
    depths (parallax layers and occlusion)."""
    device = resolve(device)
    rng = np.random.default_rng(1000 + seed)
    prims = [_backdrop(16.0, device),
             _ground([0.02, -1.0, -0.05], [0, 1.8, 0], device)]
    for _ in range(n_spheres):
        c = np.asarray([rng.uniform(-2.2, 2.2), rng.uniform(-1.0, 1.2),
                        rng.uniform(4.5, 9.0)], np.float32)
        r = np.float32(rng.uniform(0.45, 1.0))
        ang = rng.uniform(0, 2 * math.pi)
        e1 = _unit([math.cos(ang), math.sin(ang), 0.3])
        e2 = _unit(np.cross(e1, [0.2, 1.0, 0.1]))
        prims.append(Sphere(*(torch.as_tensor(a, device=device)
                              for a in (c, r, e1, e2))))
    texs = tuple(_texture_params(seed + 10 * k) for k in range(len(prims)))
    return tuple(prims), texs


def road_scene(seed: int = 0, length: float = 60.0, wall_tilt: float = 0.06,
               device="cuda"):
    """KITTI-like deep scene: road plane + two building walls converging
    at x = 7/wall_tilt m + a backdrop at ``length`` m."""
    device = resolve(device)
    prims = [_ground([0.0, -1.0, -0.02], [0, 1.65, 0], device)]
    for sx in (-1.0, 1.0):
        nW = _unit([-sx, 0.0, -wall_tilt])
        prims.append(_plane(nW, [sx * 7.0, 0, 0],
                            _unit(np.cross(nW, [0, 1.0, 0])),
                            [0.0, 1.0, 0.0], device))
    prims.append(_backdrop(length, device))
    texs = tuple(_texture_params(seed + 10 * k) for k in range(len(prims)))
    return tuple(prims), texs


def dynamic_scene(seed: int = 0, t=0.0, device="cuda"):
    """Cluttered scene with one sphere moving laterally (≈0.25 m per unit
    t): features on it violate the static-world assumption."""
    device = resolve(device)
    prims, texs = cluttered_scene(seed, n_spheres=5, device=device)
    t = torch.as_tensor(t, dtype=torch.float32, device=device)

    def vec(*v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    mover = Sphere(center=vec(-2.5, 0.1, 6.0) + t * vec(0.25, 0.0, 0.02),
                   radius=torch.tensor(0.8, device=device),
                   e1=vec(0.8, 0.0, 0.6), e2=vec(0.0, 1.0, 0.0))
    return prims + (mover,), texs + (_texture_params(seed + 999),)


def get_scene(kind: str, seed: int = 0, device="cuda"):
    """Scene factory: 'planes' (two-plane), 'clutter' (spheres+occlusion),
    'road' (KITTI-like corridor) or 'road_long' (a ~180 m corridor whose
    walls converge at 350 m). 'dynamic' is built per frame by
    ``dynamic_scene``."""
    if kind in ("planes", "default"):
        return default_scene(seed, device)
    if kind == "clutter":
        return cluttered_scene(seed, device=device)
    if kind == "road":
        return road_scene(seed, device=device)
    if kind == "road_long":
        return road_scene(seed, length=180.0, wall_tilt=0.02, device=device)
    raise ValueError(kind)


def perturb_stereo(left: torch.Tensor, right: torch.Tensor,
                   generator: torch.Generator, gain_jitter: float = 0.15,
                   bias_jitter: float = 12.0, noise_sigma: float = 2.0,
                   vignette: float = 0.30):
    """Photometric nuisance model: a global exposure gain ~ U(1±gain_jitter)
    and bias ~ U(±bias_jitter) shared by both eyes, static vignetting
    1 − v·(r/r_max)², iid Gaussian sensor noise per eye; clipped to
    [0, 255]. ``generator`` lives on the images' device."""
    dev = left.device

    def uniform():
        return torch.rand((), generator=generator, device=dev)

    g = 1.0 + gain_jitter * (2.0 * uniform() - 1.0)
    b = bias_jitter * (2.0 * uniform() - 1.0)
    H, W = left.shape
    u = (torch.arange(W, dtype=torch.float32, device=dev) - (W - 1) / 2) / (
        W / 2)
    v = (torch.arange(H, dtype=torch.float32, device=dev) - (H - 1) / 2) / (
        W / 2)
    r2 = u[None, :] ** 2 + v[:, None] ** 2
    vig = 1.0 - vignette * r2 / torch.max(r2)

    def apply(img):
        out = vig * (g * img + b)
        out = out + noise_sigma * torch.randn(img.shape, generator=generator,
                                              device=dev)
        return torch.clamp(out, 0.0, 255.0)

    return apply(left), apply(right)


def _render_pass(cam: CameraConfig, T_wc: torch.Tensor, scene, du: float,
                 dv: float) -> torch.Tensor:
    """Ray-cast at pixel centres + a (du, dv) sub-pixel offset."""
    prims, textures = scene
    dev = T_wc.device
    u = torch.arange(cam.width, dtype=torch.float32, device=dev)
    v = torch.arange(cam.height, dtype=torch.float32, device=dev)
    uu, vv = torch.meshgrid(u, v, indexing="xy")            # (H, W)
    rx = (uu + du - cam.cx) / cam.fx
    ry = (vv + dv - cam.cy) / cam.fy
    rays_c = torch.stack([rx, ry, torch.ones_like(rx)], -1)
    rays_w = torch.sum(rays_c[..., None, :] * se3.rotation(T_wc), -1)
    o = se3.translation(T_wc)
    img = torch.zeros((cam.height, cam.width), device=dev)
    depth = torch.full((cam.height, cam.width), float("inf"), device=dev)
    for prim, tex in zip(prims, textures):
        s, hit, p1, p2 = _intersect(prim, o, rays_w)
        closer = hit & (s < depth)                 # z-buffer → occlusion
        img = torch.where(closer, _texture(p1, p2, tex), img)
        depth = torch.where(closer, s, depth)
    return img


def render_view(cam: CameraConfig, T_wc: torch.Tensor, scene,
                aa: int = 1) -> torch.Tensor:
    """Ray-cast one camera view: (H, W) float32 in [0, 255]. T_wc:
    camera→world pose. ``aa`` > 1 box-filters an aa×aa sub-pixel grid
    (anti-aliasing of distant texture), one pass at a time to bound memory
    at KITTI size."""
    if aa == 1:
        return _render_pass(cam, T_wc, scene, 0.0, 0.0)
    offs = [(k + 0.5) / aa - 0.5 for k in range(aa)]
    acc = None
    for dv in offs:                 # row-major over (dv, du), as the
        for du in offs:             # reference's meshgrid
            img = _render_pass(cam, T_wc, scene, du, dv)
            acc = img if acc is None else acc + img
    return acc / (aa * aa)


def gt_depth(cam: CameraConfig, T_wc: torch.Tensor, uv: torch.Tensor,
             scene) -> torch.Tensor:
    """Exact camera z-depth of the scene at pixels uv (…,2)."""
    rx = (uv[..., 0] - cam.cx) / cam.fx
    ry = (uv[..., 1] - cam.cy) / cam.fy
    rays_c = torch.stack([rx, ry, torch.ones_like(rx)], -1)
    rays_w = torch.sum(rays_c[..., None, :] * se3.rotation(T_wc), -1)
    o = se3.translation(T_wc)
    inf = torch.full(uv.shape[:-1], float("inf"), device=uv.device)
    best = inf
    for prim in scene[0]:
        s, hit, _, _ = _intersect(prim, o, rays_w)
        best = torch.minimum(best, torch.where(hit, s, inf))
    return best


def right_camera_pose(cam: CameraConfig, T_wc_left: torch.Tensor
                      ) -> torch.Tensor:
    """Right camera pose: left shifted by +baseline along camera x."""
    t = torch.zeros(3, dtype=T_wc_left.dtype, device=T_wc_left.device)
    t[0] = cam.baseline
    offset = se3.make(torch.eye(3, dtype=T_wc_left.dtype,
                                device=T_wc_left.device), t)
    return se3.compose(T_wc_left, offset)


def render_stereo(cam: CameraConfig, T_wc: torch.Tensor, scene,
                  aa: int = 1):
    return (render_view(cam, T_wc, scene, aa),
            render_view(cam, right_camera_pose(cam, T_wc), scene, aa))


# (tx, ty, tz, wx, wy, wz) of each trajectory as (amplitude, frequency,
# phase) sine terms, or ("lin", rate) for a linear term
_TRAJECTORIES = {
    # gentle forward+sideways motion with yaw/roll (all six DoF)
    "arc": ((0.30, 0.7, 0.0), (0.10, 0.9, 0.4), ("lin", 0.25),
            (0.03, 0.8, 1.0), (0.06, 0.5, 0.0), (0.02, 1.1, 0.0)),
    # out-and-back: forward then return near the start
    "loop": ((0.20, 0.5, 0.0), (0.05, 0.9, 0.0), (0.8, 0.35, 0.0),
             (0.02, 0.7, 0.0), (0.05, 0.45, 0.0), (0.015, 1.0, 0.0)),
    # forward-dominant driving with a sustained yaw turn
    "kitti": ((0.08, 0.5, 0.0), (0.02, 0.9, 0.0), ("lin", 1.5),
              (0.01, 0.8, 0.0), (0.17, 0.18, 0.0), (0.008, 1.1, 0.0)),
    # in-plane rotation stressor: roll to ±0.25 rad
    "spin": ((0.15, 0.6, 0.0), (0.05, 0.9, 0.4), ("lin", 0.15),
             (0.02, 0.8, 1.0), (0.03, 0.5, 0.0), (0.25, 0.45, 0.0)),
    # large out-and-back: ~3x the 'loop' amplitudes
    "loop_far": ((0.4, 0.5, 0.0), (0.08, 0.9, 0.0), (2.1, 0.35, 0.0),
                 (0.02, 0.7, 0.0), (0.08, 0.45, 0.0), (0.015, 1.0, 0.0)),
}


def trajectory_pose(t: torch.Tensor, kind: str = "arc") -> torch.Tensor:
    """Ground-truth T_wc at time t (frame index · dt): 'arc', 'loop',
    'kitti', 'spin', 'loop_far' or 'still'."""
    if kind == "still":
        return se3.exp(torch.zeros(t.shape + (6,), dtype=t.dtype,
                                   device=t.device))
    if kind not in _TRAJECTORIES:
        raise ValueError(kind)
    terms = []
    for term in _TRAJECTORIES[kind]:
        if term[0] == "lin":
            terms.append(term[1] * t)
        elif term[2] == 0.0:
            terms.append(term[0] * torch.sin(term[1] * t))
        else:
            terms.append(term[0] * torch.sin(term[1] * t + term[2]))
    return se3.exp(torch.stack(terms, -1))


def make_sequence(cam: CameraConfig, n_frames: int, dt: float = 0.1,
                  kind: str = "arc", seed: int = 0,
                  scene_kind: str = "planes", perturb: bool = False,
                  motion_blur: float = 0.0, device="cuda"):
    """Render a sequence on ``device``: tensors (N,H,W), (N,H,W), (N,3,4)
    of left images, right images and ground-truth T_wc.

    ``scene_kind``: see ``get_scene``, or 'dynamic' (rebuilt per frame);
    ``perturb``: the photometric nuisance model per frame, from a
    generator seeded with ``seed``; ``motion_blur`` > 0 averages 3
    sub-exposures spread over that fraction of the inter-frame motion.
    """
    device = resolve(device)
    if scene_kind == "dynamic":
        def render(T, t):
            return render_stereo(cam, T, dynamic_scene(seed, t, device))
    else:
        scene = get_scene(scene_kind, seed, device)

        def render(T, t):
            return render_stereo(cam, T, scene)
    if motion_blur > 0.0:
        base = render

        def render(T, t):  # noqa: F811 — blur wraps the base renderer
            taps = [base(trajectory_pose(t + frac * dt, kind), t)
                    for frac in (-motion_blur, 0.0, motion_blur)]
            return (sum(tp[0] for tp in taps) / len(taps),
                    sum(tp[1] for tp in taps) / len(taps))
    gen = torch.Generator(device=device).manual_seed(seed) if perturb \
        else None
    lefts, rights, poses = [], [], []
    for i in range(n_frames):
        t = torch.tensor(i * dt, dtype=torch.float32, device=device)
        T = trajectory_pose(t, kind)
        left, right = render(T, t)
        if perturb:
            left, right = perturb_stereo(left, right, gen)
        lefts.append(left)
        rights.append(right)
        poses.append(T)
    return torch.stack(lefts), torch.stack(rights), torch.stack(poses)
