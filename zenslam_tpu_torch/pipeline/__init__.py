"""State tables, the per-frame SLAM step, the sequence runner and the full
keyframe system; ``eager`` (``utils/graphs.py``) runs the captured
programs as plain PyTorch, the counterpart of ``jax.disable_jit``."""

from zenslam_tpu_torch.pipeline.state import (
    FeatureTable,
    FrameTelemetry,
    LandmarkMap,
    MotionModel,
    SlamConfig,
    SlamState,
    init_state,
)
from zenslam_tpu_torch.utils.graphs import eager
from zenslam_tpu_torch.pipeline.step import make_slam_step, slam_step
from zenslam_tpu_torch.pipeline.runner import run_sequence
from zenslam_tpu_torch.pipeline.system import (
    BackendConfig,
    SlamSystem,
    create_system,
    flush_pipeline,
    process_frame,
    run_system,
)

__all__ = ["BackendConfig", "FeatureTable", "FrameTelemetry", "LandmarkMap", "MotionModel",
           "SlamConfig", "SlamState", "SlamSystem", "create_system", "eager",
           "flush_pipeline", "init_state", "make_slam_step", "process_frame", "run_sequence",
           "run_system", "slam_step"]
