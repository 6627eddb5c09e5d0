"""SLAM state as fixed-capacity masked tables of tensors — counterpart of
``zenslam_tpu/pipeline/state.py``.

``SlamConfig`` keeps the reference's field names and defaults, so
``SlamConfig(**jax_cfg._asdict())`` converts a config. In this package
``use_pallas_lk`` means "hand-kernel path": None resolves to True when the
state lives on CUDA and False on the CPU, and the pyramid is stored in bf16
on the kernel path, f32 otherwise.

The state carries the reference's keyline tables (``LineTable``,
``Line3dMap``, ``next_line_id``) whether or not ``use_keylines`` is set, so
its tree mirrors the reference's for ``convert.py`` and checkpoints, and
its ``VioState`` (velocity, gravity estimate and ring, biases, 3-pose
history) as ``vio``. The reference's JAX PRNG key becomes ``rng_seed`` and
``rng_step`` (plain ints): frame k's draws come from a ``torch.Generator``
seeded from that pair.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from zenslam_tpu_torch.utils.device import resolve_device  # noqa: F401  (re-exported)
from zenslam_tpu_torch.utils.graphs import Program


class SlamConfig(NamedTuple):
    """Static configuration; same fields and defaults as the reference's
    ``SlamConfig`` (see its comments for the meaning of each)."""

    max_keypoints: int = 512
    max_landmarks: int = 8192
    pyramid_levels: int = 3
    use_clahe: bool = False
    clahe_clip: float = 4.0
    cell_size: int = 16
    fast_threshold: float = 10.0 / 255.0
    subpixel_detect: bool = True
    describe_refresh: int = 1
    detect_border: int = 16
    klt_radius: int = 10
    klt_iters: int = 5
    klt_coarse_iters: int = 3
    klt_bwd_levels: int = 1
    fb_threshold: float = 1.0
    epipolar_threshold: float = 2.0
    landmark_match_distance: int = 64
    orb_backend: str = "auto"
    landmark_search_radius: float = 50.0
    frustum_margin: float = 20.0
    use_temporal_rematch: bool = True
    temporal_match_epipolar: float = 3.0
    min_depth: float = 0.5
    max_depth: float = 50.0
    reprojection_threshold: float = 1.0
    min_disparity: float = 2.0
    pnp_threshold: float = 3.0
    pnp_iters: int = 128
    rigid_threshold: float = 0.05
    rigid_iters: int = 128
    min_inliers: int = 4
    use_essential_fallback: bool = True
    essential_threshold: float = 1.5
    essential_iters: int = 128
    use_pose_fusion: bool = False
    kf_min_frames: int = 5
    kf_max_frames: int = 30
    kf_min_translation: float = 0.15
    kf_min_rotation_deg: float = 10.0
    kf_min_tracked_ratio: float = 0.6
    kf_min_inliers: int = 20
    landmark_ema: float = 0.0
    detector: str = "fast"
    descriptor: str = "orb"
    harris_threshold: float = 1e-7
    dog_threshold: float = 0.008
    float_match_distance: float = 0.55
    imu_method: str = "basalt"
    imu_gyro_noise: float = 1.6e-4
    imu_accel_noise: float = 2.8e-3
    imu_gyro_bias_walk: float = 1.9e-5
    imu_accel_bias_walk: float = 8.6e-4
    use_pallas_lk: bool | None = None
    use_keylines: bool = False
    max_keylines: int = 64
    max_line_landmarks: int = 1024
    line_min_length: float = 16.0
    line_max_length: float = 200.0
    line_match_distance: int = 96
    line_mag_threshold: float = 0.06
    line_epipolar_min_deg: float = 45.0


class FeatureTable(NamedTuple):
    """Left-canonical per-frame feature table (capacity N = max_keypoints)."""

    xy: torch.Tensor         # (N, 2) float32 left-image pixels
    uv_r: torch.Tensor       # (N, 2) float32 right-image pixels
    stereo_ok: torch.Tensor  # (N,) bool
    desc: torch.Tensor       # (N, 8) int32 packed words (uint32 bit patterns), or
                             # (N, 128) float32 for descriptor='sift'
    lm_idx: torch.Tensor     # (N,) int32 landmark slot, -1 = none
    track_id: torch.Tensor   # (N,) int32 stable feature id
    age: torch.Tensor        # (N,) int32 frames tracked
    valid: torch.Tensor      # (N,) bool


class LineTable(NamedTuple):
    """Left-canonical per-frame keyline table (capacity L = max_keylines)."""

    ep: torch.Tensor         # (L, 2, 2) float32 endpoints in the left image
    ep_r: torch.Tensor       # (L, 2, 2) float32 right-image endpoints
    stereo_ok: torch.Tensor  # (L,) bool
    desc: torch.Tensor       # (L, 8) int32 packed line-BRIEF (uint32 bit patterns)
    lm_idx: torch.Tensor     # (L,) int32 slot into Line3dMap, -1 = none
    track_id: torch.Tensor   # (L,) int32
    age: torch.Tensor        # (L,) int32
    valid: torch.Tensor      # (L,) bool


class Line3dMap(NamedTuple):
    """World 3D line-segment table (capacity M = max_line_landmarks)."""

    xyz: torch.Tensor        # (M, 2, 3) float32 world endpoint pair
    desc: torch.Tensor       # (M, 8) int32
    valid: torch.Tensor      # (M,) bool
    last_seen: torch.Tensor  # (M,) int32
    n_obs: torch.Tensor      # (M,) int32


class LandmarkMap(NamedTuple):
    """World landmark table (capacity M = max_landmarks)."""

    xyz: torch.Tensor        # (M, 3) float32
    desc: torch.Tensor       # (M, 8) int32, or (M, 128) float32 (``empty_desc``)
    valid: torch.Tensor      # (M,) bool
    last_seen: torch.Tensor  # (M,) int32
    n_obs: torch.Tensor      # (M,) int32
    generation: torch.Tensor  # (M,) int32 slot reuse counter
    color: torch.Tensor      # (M,) float32 intensity at triangulation


class MotionModel(NamedTuple):
    """Constant-acceleration model with EMA smoothing (see the reference)."""

    vel: torch.Tensor
    acc: torch.Tensor
    vel_ang: torch.Tensor
    acc_ang: torch.Tensor
    n_updates: torch.Tensor  # () int32


class VioState(NamedTuple):
    """Visual-inertial state carried across frames (see the reference)."""

    v_world: torch.Tensor       # (3,) body velocity in world frame
    gravity_w: torch.Tensor     # (3,) current gravity estimate (world)
    gravity_ok: torch.Tensor    # () bool: enough samples accepted
    bias_gyro: torch.Tensor     # (3,)
    bias_accel: torch.Tensor    # (3,)
    grav_samples: torch.Tensor  # (C, 3) gravity-estimator sample ring
    grav_valid: torch.Tensor    # (C,) bool
    grav_next: torch.Tensor     # () int32
    hist_p: torch.Tensor        # (3, 3) oldest-first body positions
    hist_R_wb: torch.Tensor     # (3, 3, 3)
    hist_dt: torch.Tensor       # (2,) dt between consecutive history poses
    hist_f: torch.Tensor        # (2, 3) mean specific force per interval
    hist_n: torch.Tensor        # () int32 valid history poses


def init_vio(gravity_capacity: int = 64, device=None) -> VioState:
    f32 = torch.float32

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return VioState(
        v_world=z(3), gravity_w=z(3), gravity_ok=z(dtype=torch.bool), bias_gyro=z(3),
        bias_accel=z(3), grav_samples=z(gravity_capacity, 3),
        grav_valid=z(gravity_capacity, dtype=torch.bool), grav_next=z(dtype=torch.int32),
        hist_p=z(3, 3),
        hist_R_wb=torch.eye(3, dtype=f32, device=device).expand(3, 3, 3).clone(),
        hist_dt=z(2), hist_f=z(2, 3), hist_n=z(dtype=torch.int32))


class SlamState(NamedTuple):
    features: FeatureTable
    lmap: LandmarkMap
    lines: LineTable
    line_map: Line3dMap
    R_cw: torch.Tensor
    t_cw: torch.Tensor
    motion: MotionModel
    last_kf_R: torch.Tensor
    last_kf_t: torch.Tensor
    frames_since_kf: torch.Tensor  # () int32
    frame_idx: torch.Tensor        # () int32
    next_track_id: torch.Tensor    # () int32
    next_line_id: torch.Tensor     # () int32
    prev_pyr_l: tuple              # ragged levels at true size
    rng_seed: int                  # per-state seed
    rng_step: int                  # frames drawn so far
    vio: VioState


class FrameTelemetry(NamedTuple):
    n_tracked: torch.Tensor
    n_detected: torch.Tensor
    n_stereo: torch.Tensor
    n_triangulated: torch.Tensor
    n_pose_inliers: torch.Tensor
    pose_method: torch.Tensor
    pose_ok: torch.Tensor
    tracked_ratio: torch.Tensor
    is_keyframe: torch.Tensor
    map_size: torch.Tensor
    n_lines: torch.Tensor
    n_line_triangulated: torch.Tensor
    line_map_size: torch.Tensor
    R_cw: torch.Tensor
    t_cw: torch.Tensor


_TEL_N_SCALARS = 13  # fields before R_cw/t_cw


@functools.partial(Program, copy_outputs=True)
def pack_telemetry(tel: FrameTelemetry) -> torch.Tensor:
    """Flatten a FrameTelemetry to one (25,) f32 tensor on its device: the 13
    scalars, then R_cw row-major, then t_cw. The host reads a frame with one
    copy instead of one per field."""
    scalars = torch.stack([f.to(torch.float32).reshape(()) for f in tel[:_TEL_N_SCALARS]])
    return torch.cat([scalars, tel.R_cw.reshape(-1).to(torch.float32),
                      tel.t_cw.to(torch.float32)])


def split_telemetry(vec: torch.Tensor) -> FrameTelemetry:
    """A FrameTelemetry of views into a packed (25,) tensor on its device:
    float32 scalars, R_cw (3, 3), t_cw (3,)."""
    k = _TEL_N_SCALARS
    return FrameTelemetry(*vec[:k], R_cw=vec[k:k + 9].reshape(3, 3), t_cw=vec[k + 9:k + 12])


def unpack_telemetry(vec) -> FrameTelemetry:
    """Host inverse of ``pack_telemetry``: a FrameTelemetry of numpy values
    from a (25,) numpy array or CPU tensor."""
    import numpy as np

    v = vec.numpy() if isinstance(vec, torch.Tensor) else np.asarray(vec)
    k = _TEL_N_SCALARS
    return FrameTelemetry(*v[:k], R_cw=v[k:k + 9].reshape(3, 3), t_cw=v[k + 9:k + 12])


def empty_desc(cfg: SlamConfig, n: int, device=None):
    """Descriptor storage of the configured family: (n, 128) float32 for
    ``sift``, (n, 8) int32 packed words otherwise."""
    if cfg.descriptor == "sift":
        return torch.zeros((n, 128), dtype=torch.float32, device=device)
    return torch.zeros((n, 8), dtype=torch.int32, device=device)


def empty_features(cfg: SlamConfig, device=None) -> FeatureTable:
    """An empty keypoint table of ``cfg.max_keypoints`` slots on ``device``
    (default CUDA, raising when absent)."""
    dev = resolve_device(device)
    n = cfg.max_keypoints
    f32, i32 = torch.float32, torch.int32
    return FeatureTable(
        xy=torch.zeros((n, 2), dtype=f32, device=dev),
        uv_r=torch.zeros((n, 2), dtype=f32, device=dev),
        stereo_ok=torch.zeros(n, dtype=torch.bool, device=dev),
        desc=empty_desc(cfg, n, dev),
        lm_idx=torch.full((n,), -1, dtype=i32, device=dev),
        track_id=torch.full((n,), -1, dtype=i32, device=dev),
        age=torch.zeros(n, dtype=i32, device=dev),
        valid=torch.zeros(n, dtype=torch.bool, device=dev))


def empty_landmarks(cfg: SlamConfig, device=None) -> LandmarkMap:
    """An empty landmark map of ``cfg.max_landmarks`` slots on ``device``
    (default CUDA, raising when absent)."""
    dev = resolve_device(device)
    m = cfg.max_landmarks
    f32, i32 = torch.float32, torch.int32
    return LandmarkMap(
        xyz=torch.zeros((m, 3), dtype=f32, device=dev),
        desc=empty_desc(cfg, m, dev),
        valid=torch.zeros(m, dtype=torch.bool, device=dev),
        last_seen=torch.full((m,), -1, dtype=i32, device=dev),
        n_obs=torch.zeros(m, dtype=i32, device=dev),
        generation=torch.zeros(m, dtype=i32, device=dev),
        color=torch.zeros(m, dtype=f32, device=dev))


def empty_lines(cfg: SlamConfig, device=None) -> LineTable:
    n = cfg.max_keylines
    f32, i32 = torch.float32, torch.int32
    return LineTable(
        ep=torch.zeros((n, 2, 2), dtype=f32, device=device),
        ep_r=torch.zeros((n, 2, 2), dtype=f32, device=device),
        stereo_ok=torch.zeros(n, dtype=torch.bool, device=device),
        desc=torch.zeros((n, 8), dtype=i32, device=device),
        lm_idx=torch.full((n,), -1, dtype=i32, device=device),
        track_id=torch.full((n,), -1, dtype=i32, device=device),
        age=torch.zeros(n, dtype=i32, device=device),
        valid=torch.zeros(n, dtype=torch.bool, device=device))


def empty_line_map(cfg: SlamConfig, device=None) -> Line3dMap:
    m = cfg.max_line_landmarks
    return Line3dMap(
        xyz=torch.zeros((m, 2, 3), dtype=torch.float32, device=device),
        desc=torch.zeros((m, 8), dtype=torch.int32, device=device),
        valid=torch.zeros(m, dtype=torch.bool, device=device),
        last_seen=torch.full((m,), -1, dtype=torch.int32, device=device),
        n_obs=torch.zeros(m, dtype=torch.int32, device=device))


def resolve_use_kernels(cfg: SlamConfig, device) -> bool:
    """Whether the hand-kernel path runs (None = auto: CUDA yes, CPU no)."""
    if cfg.use_pallas_lk is None:
        return torch.device(device).type == "cuda"
    return bool(cfg.use_pallas_lk)


def pyramid_dtype(cfg: SlamConfig, device):
    return torch.bfloat16 if resolve_use_kernels(cfg, device) else torch.float32


def frame_generator(state: SlamState, device) -> torch.Generator:
    """The generator for the state's next frame, seeded from (seed, step)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(state.rng_seed) * 1_000_003 + int(state.rng_step)) % (2 ** 63))
    return g


def init_state(cfg: SlamConfig, image_shape, seed: int = 0, device=None) -> SlamState:
    """Empty state for (H, W) images on ``device`` (default: CUDA, raising
    when absent)."""
    from zenslam_tpu_torch.ops.lk import empty_ragged_pyramid

    dev = resolve_device(device)
    H, W = image_shape
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    eye = torch.eye(3, dtype=f32, device=dev)
    return SlamState(
        features=empty_features(cfg, dev), lmap=empty_landmarks(cfg, dev),
        lines=empty_lines(cfg, dev), line_map=empty_line_map(cfg, dev),
        R_cw=eye.clone(), t_cw=z(3),
        motion=MotionModel(vel=z(3), acc=z(3), vel_ang=z(3), acc_ang=z(3),
                           n_updates=z(dtype=i32)),
        last_kf_R=eye.clone(), last_kf_t=z(3),
        frames_since_kf=z(dtype=i32), frame_idx=z(dtype=i32),
        next_track_id=z(dtype=i32), next_line_id=z(dtype=i32),
        prev_pyr_l=empty_ragged_pyramid(H, W, cfg.pyramid_levels,
                                        pyramid_dtype(cfg, dev), device=dev),
        rng_seed=int(seed), rng_step=0,
        vio=init_vio(device=dev),
    )
