"""Static configuration of the stereo SVO engine — the port's own copy of
``stereo_svo_tpu/config.py``: the same dataclasses, field names, types,
defaults and docstrings (``tests/test_torch_config.py`` holds the two
equal). The measured history behind each default is in the reference's
comments; the comments here say only what each knob does.

A config instance is frozen and hashable: capacities (``max_features``,
``max_keyframes``, ``mem_keyframes``) fix every tensor shape of the state.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole + baseline stereo camera model (rectified).

    Reference parity: CameraSettings{fx,fy,cx,cy,baseline,...}
    (src/lib/stereo_slam_types.hpp [UNVERIFIED]). Distortion is handled at
    ingest (host-side rectification); the device-side model is rectified
    pinhole, as in the reference's core pipeline.
    """

    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    baseline: float = 0.11  # meters
    width: int = 752
    height: int = 480

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)


@dataclasses.dataclass(frozen=True)
class SvoConfig:
    """Algorithm + capacity configuration (all static / trace-shaping)."""

    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)

    # --- pyramid ---
    num_levels: int = 4            # intensity pyramid levels
    # --- detector / grid bucketing ---
    grid_rows: int = 12
    grid_cols: int = 16
    detect_levels: int = 4         # pyramid levels scanned for corners
                                   # (clipped to num_levels)
    fast_threshold: float = 12.0   # intensity contrast for FAST arc test (u8 scale)
    edgelet_threshold: float = 16.0  # gradient-magnitude threshold for edgelets
    min_score: float = 1.0         # minimum cell score to activate a feature
    border_margin: int = 16        # keep features away from image border

    # --- capacities (fixed; liveness via masks) ---
    max_features: int = 192        # feature, seed and BA-landmark slots
    max_keyframes: int = 10        # sliding window size

    # --- stereo matching ---
    stereo_max_disp: int = 96      # disparity search range in px at level 0
    stereo_patch: int = 8          # ZNCC window for stereo matching

    # --- sparse direct alignment ---
    align_patch: int = 4           # photometric patch
    align_max_iters: int = 10      # GN iterations per level (when no
                                   # per-level schedule is set)
    align_iters_per_level: tuple | None = (2, 3, 4, 8)
                                   # per-level GN iteration schedule,
                                   # coarse→fine; None = flat
                                   # align_max_iters
    align_levels: int = 4          # coarse-to-fine levels used for alignment
    align_min_level: int = 0       # finest level in alignment
    align_huber: float = 8.0       # Huber k on intensity residuals (u8 scale)
    align_irls_chunks: int = 3     # Huber-weight/Hessian refreshes per
                                   # level; each refresh takes an exact GN
                                   # step, iterations in between reuse H⁻¹
                                   # as one matvec

    align_tmpl_stereo: bool = False  # template depths from the current
                                   # frame's stereo disparity instead of
                                   # the map (off: measured worse)
    illum_affine: bool = True      # photometric affine compensation: a
                                   # global gain/bias in alignment, a
                                   # per-feature affine fit in KLT

    # --- KLT feature alignment ---
    klt_patch: int = 8             # inverse-compositional LK window
    klt_max_iters: int = 6
    klt_levels: int = 3
    klt_conv_eps: float = 0.03     # px; squared-step convergence threshold
    klt_affine_warp: bool = False  # resample templates through the pose-
                                   # predicted affine warp

    # --- pose refinement ---
    refine_max_iters: int = 10
    refine_huber_px: float = 2.0   # Huber k on reprojection residuals (px)
    refine_outlier_px: float = 4.0 # reprojection error to kill a feature
    refine_irls_chunks: int = 3    # Jacobian/weight refreshes
    refine_prior_t_sig: float = 0.05  # constant-velocity motion prior in
                                   # the refiner (m, rad; 0 disables)
    refine_prior_r_sig: float = 0.02
    refine_whiten_depth: bool = False  # fold the depth posterior's
                                   # uncertainty into the refiner's row
                                   # noise (off: measured worse)
    refine_stereo_weight: float = 1.0  # weight of the per-frame stereo
                                   # disparity rows in the pose refiner
                                   # (0 disables)

    # --- depth filter ---
    seed_sigma_ratio: float = 0.05  # convergence: sigma < ratio * depth_range
    seed_sigma_floor: float = 0.0  # posterior σ floor as a ratio of μ
                                   # (0 disables; measured harmful)
    seed_max_updates: int = 60
    px_noise: float = 1.0          # 1-px measurement noise assumption
    stereo_refresh_window: int = 10  # per-frame stereo re-observation:
                                   # disparity search (pred ± window px)
                                   # in the current stereo pair; 0
                                   # disables
    stereo_refresh_landmarks: bool = True  # include converged landmarks
                                   # in the per-frame stereo refresh
    # per-seed epipolar search for KLT-lost seeds
    epi_samples: int = 0           # ZNCC probes along the μ±3σ segment
                                   # (0 disables the epipolar path)
    epi_min_zncc: float = 0.7      # acceptance threshold on the peak
    epi_level: int = 1             # pyramid level searched (cheaper coarse)

    # --- keyframe policy ---
    kf_min_tracked: int = 60       # insert KF if tracked features drop below
    kf_dist_ratio: float = 0.12    # or translation / median scene depth above
    kf_every: int = 1              # regular-KF cadence quantization (> 1
                                   # restricts non-urgent insertions to
                                   # every kf_every-th frame)

    # --- stereo observation consistency gate (keyframe snapshots) ---
    stereo_consist_px: float = 2.0   # accept a stereo re-match into the BA
                                     # observation graph only within
                                     # max(px, rel·disp) of the predicted
                                     # disparity: absolute floor…
    stereo_consist_rel: float = 0.15  # …and relative window

    # --- bundle adjustment (backend) ---
    use_ba: bool = True            # run window BA at each KF insertion
    ba_iters: int = 5              # GN/LM outer iterations
    ba_huber_px: float = 2.0
    ba_trust_t: float = 0.10       # divergence guard: max translation /
    ba_trust_r: float = 0.05       # rotation the BA may move the newest
                                   # keyframe (reject the step beyond it)
    ba_trust_clamp: bool = False   # True: apply an out-of-trust proposal
                                   # as a geodesic partial step scaled to
                                   # the trust radius instead of
                                   # rejecting it

    # --- place recognition / loop closure ---
    loop_desc_rows: int = 6        # descriptor pooling grid (rows x cols)
    loop_desc_cols: int = 8
    loop_thumb_level: int = 2      # pyramid level stored as KF thumbnail
    loop_patch: int = 4            # photometric patch for edge measurement
    loop_align_iters: int = 20     # GN iterations for edge measurement
    loop_min_score: float = 0.60   # descriptor ZNCC to propose an edge
    loop_min_gap: int = 20         # min |frame stamp| separation (same seq)
    pr_rot_variants: int = 2       # rotated query variants per side for
                                   # place recognition (0 disables)
    pr_rot_step_rad: float = 0.15
    reloc_min_score: float = 0.3   # descriptor-score floor for the
                                   # relocalization seed; below it, the
                                   # most recent keyframe
    loop_max_edges: int = 8        # fixed loop-edge capacity (masked)
    loop_accept_frac: float = 0.6  # min photometric inlier frac to accept
    loop_rt_max_t: float = 0.30    # round-trip consistency gate (m, rad)
    loop_rt_max_r: float = 0.15
    online_loop_noise_k: float = 2.0  # apply an online correction only if
                                   # it exceeds k × the worst accepted
                                   # edge's round-trip error
    # --- online loop closure ---
    online_loop_every: int = 0     # run every N-th KF insertion (0 = off)
    online_loop_edges: int = 2     # top-k bank matches measured per query
    online_loop_iters: int = 8     # pose-graph GN iterations
    online_loop_max_t: float = 2.0  # trust guard on the correction of the
    online_loop_max_r: float = 1.0  # newest KF (m, rad)
    online_loop_min_t: float = 0.02  # significance floor of a correction
    online_loop_min_r: float = 0.01  # (m, rad)
    online_loop_cooldown: int = 2  # KF insertions to wait after an
                                   # applied correction
    mem_keyframes: int = 48        # long-horizon keyframe memory bank
    mem_retention: str = "coverage"  # bank eviction policy when full:
                                   # "coverage" or "fifo"

    # --- numerics ---
    dtype: str = "float32"         # image/compute dtype ("float32"|"bfloat16")

    def __post_init__(self):
        assert self.align_levels <= self.num_levels
        assert self.klt_levels <= self.num_levels
        assert self.max_features >= 1 and self.max_keyframes >= 2
        if self.epi_samples > 0 and self.epi_level > self.klt_levels - 1:
            # the epipolar search reuses the KLT template patches, which
            # exist only for levels < klt_levels
            raise ValueError(
                f"epi_level={self.epi_level} needs klt_levels >= "
                f"{self.epi_level + 1} (the search reuses KLT template "
                f"patches); got klt_levels={self.klt_levels}")

    @property
    def thumb_level(self) -> int:
        """Pyramid level stored as the keyframe thumbnail (clamped so tiny
        test configs with few levels stay valid)."""
        return min(self.loop_thumb_level, self.num_levels - 1)

    @property
    def thumb_shape(self) -> Tuple[int, int]:
        h, w = self.camera.height, self.camera.width
        for _ in range(self.thumb_level):
            h, w = h // 2, w // 2
        return (h, w)

    @property
    def desc_dim(self) -> int:
        return self.loop_desc_rows * self.loop_desc_cols

    @property
    def klt_big_patch(self) -> int:
        """Oversized KLT template size for affine warping (1 = disabled —
        the template tuple keeps a static dummy shape)."""
        return 2 * self.klt_patch if self.klt_affine_warp else 1


DEFAULT_CONFIG = SvoConfig()


def euroc_config() -> SvoConfig:
    """EuRoC MAV stereo (cam0) geometry, rectified."""
    return SvoConfig(camera=CameraConfig(
        fx=458.654, fy=457.296, cx=367.215, cy=248.375,
        baseline=0.110078, width=752, height=480))


def kitti_config() -> SvoConfig:
    """KITTI odometry grayscale stereo (seq 00 geometry)."""
    return SvoConfig(camera=CameraConfig(
        fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
        baseline=0.5371657, width=1241, height=376),
        grid_rows=10, grid_cols=24, max_features=240,
        stereo_max_disp=128,
        # driving-scale scenes (5-60 m): let BA move a mis-anchored
        # keyframe far enough to matter
        ba_trust_t=0.40, ba_trust_r=0.05,
        # in the deep road corridor far seeds are KLT-marginal and the
        # epipolar recoveries keep them measured
        epi_samples=16)


def stress_config() -> SvoConfig:
    """North-star config #3: aggressive-motion stress — 5-level pyramids,
    >2k active depth-filter seeds (grid 32x64 = 2048 cells)."""
    return SvoConfig(camera=CameraConfig(),
                     num_levels=5, align_levels=4, align_min_level=1,
                     grid_rows=32, grid_cols=64, max_features=2048,
                     kf_min_tracked=600, klt_levels=3)


__all__ = ["CameraConfig", "SvoConfig", "DEFAULT_CONFIG", "euroc_config",
           "kitti_config", "stress_config"]
