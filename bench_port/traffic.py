"""The one traffic generator: a traffic file's parameters and a
configuration's rig in, a pool of stereo pairs (and IMU) on the device out,
all drawn from the run's seed.

Traffic keys: ``world`` ('corridor' or 'room'), ``motion`` ('arc' with
``speed``, or 'orbit' with ``orbit_radius``), ``dt`` (s between frames),
``pool_frames``, ``schedule`` ('pingpong' or 'wrap'), ``pixel_noise`` (σ
baked into the pool), ``texture_seed`` (the world's textures; without it,
the run's seed), ``warmup_frames`` (frames the measured system runs
before the window), ``trace_frames`` (frames under the profiler in a traced
run, which end its window), ``trace_before_end_s`` (seconds before the
window's end where they start) and,
optionally, ``judge_per_s`` and ``judge_skip`` (where the judged frames are
drawn: ``run.snap_frames``).

The run's seed draws the noise (and the textures, where the traffic names no
``texture_seed``); the trajectory, the frame sizes and the schedule are the
traffic's alone. A fixed ``texture_seed`` keeps the work of a window, which
follows what the textures let the tracker find (keyframes, map, reloads),
the same from seed to seed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from bench_port import scene


class Pool(NamedTuple):
    left: torch.Tensor             # (P, H, W) float32, device
    right: torch.Tensor
    R_cw: np.ndarray               # (P, 3, 3) float64 truth, world -> left camera
    t_cw: np.ndarray               # (P, 3)
    imu: Optional[tuple]           # gyro (P, S, 3), accel (P, S, 3), dts (P, S), device
    world: scene.PlaneWorld
    schedule: str

    def index(self, frame: int) -> int:
        """Pool index of a run's frame ``frame``."""
        return int(scene.schedule(self.schedule, self.left.shape[0], frame))


def intrinsics(cfg: dict) -> tuple:
    return (cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"])


def build_pool(cfg: dict, traffic: dict, seed: int, device) -> Pool:
    """Render the traffic's pool for the configuration's rig on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(traffic.get("texture_seed", seed)) % (1 << 63))
    world = scene.WORLDS[traffic["world"]](gen, dev)
    gen.manual_seed(int(seed) % (1 << 63))
    P, H, W = traffic["pool_frames"], cfg["height"], cfg["width"]
    times = np.arange(P, dtype=np.float64) * traffic["dt"]
    poses = scene.pose_fn(traffic)
    R_cw, t_cw = poses(times)
    t_rl = torch.tensor([-cfg["baseline"], 0.0, 0.0], dtype=torch.float32, device=dev)
    intr = intrinsics(cfg)
    left = torch.empty((P, H, W), dtype=torch.float32, device=dev)
    right = torch.empty_like(left)
    R_dev = torch.as_tensor(R_cw, dtype=torch.float32).to(dev)
    t_dev = torch.as_tensor(t_cw, dtype=torch.float32).to(dev)
    for i in range(P):
        left[i] = scene.render_view(world, intr, R_dev[i], t_dev[i], H, W)
        right[i] = scene.render_view(world, intr, R_dev[i], t_dev[i] + t_rl, H, W)
    scene.bake_noise(gen, left, traffic["pixel_noise"])
    scene.bake_noise(gen, right, traffic["pixel_noise"])
    imu = None
    if cfg.get("imu"):
        if traffic["schedule"] != "wrap":
            raise ValueError("an IMU stream needs a 'wrap' schedule (time runs forward)")
        gyro, accel, dts = scene.imu_samples(poses, times, traffic["dt"],
                                             cfg["imu"]["samples_per_frame"])
        imu = tuple(torch.from_numpy(a).to(dev) for a in (gyro, accel, dts))
    return Pool(left, right, R_cw, t_cw, imu, world, traffic["schedule"])
