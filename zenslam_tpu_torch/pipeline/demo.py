"""Demo: run the per-frame SLAM loop on a rendered synthetic stereo sequence
and report ATE, RPE and throughput — counterpart of
``zenslam_tpu/pipeline/demo.py``.

    python -m zenslam_tpu_torch.pipeline.demo [n_frames] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from zenslam_tpu_torch.eval.metrics import ate_rmse, camera_positions, rpe_rmse
from zenslam_tpu_torch.io.synthetic import make_sequence
from zenslam_tpu_torch.pipeline.runner import run_sequence
from zenslam_tpu_torch.pipeline.state import SlamConfig, init_state, resolve_device
from zenslam_tpu_torch.pipeline.step import make_slam_step


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main(n_frames: int = 30, device=None, width: int = 512, height: int = 384):
    dev = resolve_device(device)
    print(f"device: {dev} ({torch.cuda.get_device_name(0) if dev.type == 'cuda' else 'host CPU'})")
    print(f"rendering {n_frames}-frame synthetic stereo sequence…")
    seq = make_sequence(np.random.default_rng(11), n_frames=n_frames, width=width,
                        height=height, motion="arc", speed=0.5, device_render=dev.type == "cuda",
                        device=dev)
    cfg = SlamConfig()
    left = torch.as_tensor(seq.left, dtype=torch.float32).to(dev)
    right = torch.as_tensor(seq.right, dtype=torch.float32).to(dev)

    t0 = time.time()      # warm-up: first-use work (kernel builds, the step's capture)
    step = make_slam_step(cfg, seq.rig)
    step(init_state(cfg, (height, width), device=dev), left[0], right[0])
    _sync(dev)
    print(f"warm-up: {time.time() - t0:.1f}s")

    t0 = time.time()
    state, tel = run_sequence(cfg, seq.rig, left, right, mode="scan", device=dev, step=step)
    _sync(dev)
    dt = time.time() - t0

    est = camera_positions(tel.R_cw, tel.t_cw)
    gt = camera_positions(seq.R_lw, seq.t_lw)
    ate, rpe = ate_rmse(est, gt), rpe_rmse(est, gt)
    fps = n_frames / dt
    print(f"frames: {n_frames}  pose_ok: {int(tel.pose_ok.sum())}  "
          f"keyframes: {int(tel.is_keyframe.sum())}  map: {int(tel.map_size[-1])}")
    print(f"ATE RMSE: {ate * 1000:.1f} mm   RPE RMSE: {rpe * 1000:.1f} mm")
    print(f"throughput: {fps:.1f} frames/s ({dt / n_frames * 1000:.1f} ms/frame)")
    return ate, fps


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_frames", type=int, nargs="?", default=30)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args()
    main(args.n_frames, device=args.device)
