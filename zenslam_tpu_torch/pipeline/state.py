"""SLAM state as fixed-capacity masked tables of tensors — counterpart of
``zenslam_tpu/pipeline/state.py``.

``SlamConfig`` keeps the reference's field names and defaults, so
``SlamConfig(**jax_cfg._asdict())`` converts a config. In this package
``use_pallas_lk`` means "hand-kernel path": None resolves to True when the
state lives on CUDA and False on the CPU, and the pyramid is stored in bf16
on the kernel path, f32 otherwise.

The state carries no keyline or IMU tables: those subsystems are not ported
(``check_supported``). The reference's JAX PRNG key becomes ``rng_seed`` and
``rng_step`` (plain ints): frame k's draws come from a ``torch.Generator``
seeded from that pair.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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


def check_supported(cfg: SlamConfig, imu=None) -> None:
    """Raise NotImplementedError for configurations this port does not run
    yet, naming the ROADMAP.md item that will port them."""
    todo = []
    if cfg.use_keylines:
        todo.append("use_keylines (Queue 1 item 13: keylines, ops/lines.py + "
                    "pipeline/lines_step.py)")
    if imu is not None:
        todo.append("imu (Queue 1 item 11: IMU/VIO)")
    if cfg.descriptor != "orb":
        todo.append(f"descriptor={cfg.descriptor!r} (Queue 1 item 12: other detector/"
                    "descriptor families)")
    if cfg.detector != "fast":
        todo.append(f"detector={cfg.detector!r} (Queue 1 item 12: other detector/"
                    "descriptor families)")
    if cfg.describe_refresh > 1:
        todo.append("describe_refresh > 1 (Queue 1 item 12: the describe_refresh merge)")
    if cfg.use_pose_fusion:
        todo.append("use_pose_fusion (Queue 1 item 10: estimation/fusion.py)")
    if todo:
        raise NotImplementedError(
            "not ported to zenslam_tpu_torch yet, see ROADMAP.md: " + "; ".join(todo))


class FeatureTable(NamedTuple):
    """Left-canonical per-frame feature table (capacity N = max_keypoints)."""

    xy: torch.Tensor         # (N, 2) float32 left-image pixels
    uv_r: torch.Tensor       # (N, 2) float32 right-image pixels
    stereo_ok: torch.Tensor  # (N,) bool
    desc: torch.Tensor       # (N, 8) int32 packed ORB-256 (uint32 bit patterns)
    lm_idx: torch.Tensor     # (N,) int32 landmark slot, -1 = none
    track_id: torch.Tensor   # (N,) int32 stable feature id
    age: torch.Tensor        # (N,) int32 frames tracked
    valid: torch.Tensor      # (N,) bool


class LandmarkMap(NamedTuple):
    """World landmark table (capacity M = max_landmarks)."""

    xyz: torch.Tensor        # (M, 3) float32
    desc: torch.Tensor       # (M, 8) int32
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


class SlamState(NamedTuple):
    features: FeatureTable
    lmap: LandmarkMap
    R_cw: torch.Tensor
    t_cw: torch.Tensor
    motion: MotionModel
    last_kf_R: torch.Tensor
    last_kf_t: torch.Tensor
    frames_since_kf: torch.Tensor  # () int32
    frame_idx: torch.Tensor        # () int32
    next_track_id: torch.Tensor    # () int32
    prev_pyr_l: tuple              # ragged levels at true size
    rng_seed: int                  # per-state seed
    rng_step: int                  # frames drawn so far


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


def pack_telemetry(tel: FrameTelemetry) -> torch.Tensor:
    """Flatten a FrameTelemetry to one (25,) f32 tensor on its device: the 13
    scalars, then R_cw row-major, then t_cw. The host reads a frame with one
    copy instead of one per field."""
    scalars = torch.stack([f.to(torch.float32).reshape(()) for f in tel[:_TEL_N_SCALARS]])
    return torch.cat([scalars, tel.R_cw.reshape(-1).to(torch.float32),
                      tel.t_cw.to(torch.float32)])


def unpack_telemetry(vec) -> FrameTelemetry:
    """Host inverse of ``pack_telemetry``: a FrameTelemetry of numpy values
    from a (25,) numpy array or CPU tensor."""
    import numpy as np

    v = vec.numpy() if isinstance(vec, torch.Tensor) else np.asarray(vec)
    k = _TEL_N_SCALARS
    return FrameTelemetry(*v[:k], R_cw=v[k:k + 9].reshape(3, 3), t_cw=v[k + 9:k + 12])


def resolve_use_kernels(cfg: SlamConfig, device) -> bool:
    """Whether the hand-kernel path runs (None = auto: CUDA yes, CPU no)."""
    if cfg.use_pallas_lk is None:
        return torch.device(device).type == "cuda"
    return bool(cfg.use_pallas_lk)


def pyramid_dtype(cfg: SlamConfig, device):
    return torch.bfloat16 if resolve_use_kernels(cfg, device) else torch.float32


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.
    Never falls back to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "zenslam_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def frame_generator(state: SlamState, device) -> torch.Generator:
    """The generator for the state's next frame, seeded from (seed, step)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(state.rng_seed) * 1_000_003 + int(state.rng_step)) % (2 ** 63))
    return g


def init_state(cfg: SlamConfig, image_shape, seed: int = 0, device=None) -> SlamState:
    """Empty state for (H, W) images on ``device`` (default: CUDA, raising
    when absent)."""
    from zenslam_tpu_torch.ops.lk import empty_ragged_pyramid

    check_supported(cfg)
    dev = resolve_device(device)
    H, W = image_shape
    n, m = cfg.max_keypoints, cfg.max_landmarks
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, v, dtype=i32):
        return torch.full(shape, v, dtype=dtype, device=dev)

    eye = torch.eye(3, dtype=f32, device=dev)
    return SlamState(
        features=FeatureTable(
            xy=z(n, 2), uv_r=z(n, 2), stereo_ok=z(n, dtype=torch.bool),
            desc=z(n, 8, dtype=i32), lm_idx=full((n,), -1), track_id=full((n,), -1),
            age=z(n, dtype=i32), valid=z(n, dtype=torch.bool)),
        lmap=LandmarkMap(
            xyz=z(m, 3), desc=z(m, 8, dtype=i32), valid=z(m, dtype=torch.bool),
            last_seen=full((m,), -1), n_obs=z(m, dtype=i32),
            generation=z(m, dtype=i32), color=z(m)),
        R_cw=eye.clone(), t_cw=z(3),
        motion=MotionModel(vel=z(3), acc=z(3), vel_ang=z(3), acc_ang=z(3),
                           n_updates=z(dtype=i32)),
        last_kf_R=eye.clone(), last_kf_t=z(3),
        frames_since_kf=z(dtype=i32), frame_idx=z(dtype=i32),
        next_track_id=z(dtype=i32),
        prev_pyr_l=empty_ragged_pyramid(H, W, cfg.pyramid_levels,
                                        pyramid_dtype(cfg, dev), device=dev),
        rng_seed=int(seed), rng_step=0,
    )
