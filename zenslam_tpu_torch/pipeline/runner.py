"""Sequence runner for the per-frame step — counterpart of
``zenslam_tpu/pipeline/runner.py``.

Both modes run the same frame loop and stack the telemetry on the device at
the end (one device->host copy per field for the whole run). ``mode="stream"``
copies each frame to the device as it is reached; ``mode="scan"`` (the
reference's ``lax.scan`` offline path) copies the whole sequence first.
The step is the captured one (``make_slam_step``), as the reference's loop
calls its jitted step.
"""

from __future__ import annotations

import torch

from zenslam_tpu_torch.geometry.camera import StereoRig
from zenslam_tpu_torch.pipeline.state import SlamConfig, init_state, resolve_device
from zenslam_tpu_torch.pipeline.step import make_slam_step


def run_sequence(cfg: SlamConfig, rig: StereoRig, left, right, seed: int = 0,
                 mode: str = "stream", state=None, imu=None, device=None, step=None):
    """Run SLAM over a (T, H, W) stereo sequence (numpy arrays or tensors) on
    ``device`` (default: the given state's, else CUDA, raising when absent).
    Returns (final_state, telemetry stacked over T as numpy). ``imu``:
    optional (gyro (T, S, 3), accel (T, S, 3), dts (T, S), mask (T, S)), the
    per-frame IMU batches (turns on the VIO branch of the step). ``step``: a
    ``make_slam_step(cfg, rig)`` to reuse (its capture already made; default
    a new one)."""
    if mode not in ("stream", "scan"):
        raise ValueError(f"unknown mode {mode!r} (stream, scan)")
    T, H, W = left.shape
    dev = state.R_cw.device if state is not None else resolve_device(device)
    if state is None:
        state = init_state(cfg, (H, W), seed=seed, device=dev)

    def frames(x):
        return torch.as_tensor(x, dtype=torch.float32).to(dev)

    if mode == "scan":
        left, right = frames(left), frames(right)
        if imu is not None:
            imu = tuple(torch.as_tensor(x).to(dev) for x in imu)
    step = step or make_slam_step(cfg, rig)
    tels = []
    for t in range(T):
        il, ir = (left[t], right[t]) if mode == "scan" else (frames(left[t]), frames(right[t]))
        fi = None if imu is None else tuple(x[t] for x in imu)
        state, tel = step(state, il, ir, imu=fi)
        tels.append(tel)
    return state, type(tels[0])(*(torch.stack(xs).cpu().numpy() for xs in zip(*tels)))
