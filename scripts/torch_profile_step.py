#!/usr/bin/env python3
"""Where the time of zenslam_tpu_torch's per-frame step goes, on one GPU.

    python3 scripts/torch_profile_step.py [--frames 16] [--size 1024] [--out FILE]

Runs the default SlamConfig on a device-rendered 'arc' sequence (as
chip_smoke.py does), then over the measured frames reports:

1. stage times: each stage of pipeline/step.py wrapped with a
   torch.cuda.synchronize() on both sides (host clock), so the stages
   add up to a slower, serialised frame;
2. the unwrapped step's wall time (host clock around synchronize);
3. a torch.profiler trace of the unwrapped step: device busy time per frame
   (sum of kernel durations), the idle share against the unprofiled wall
   time of 2., the device kernels launched per frame, and the top operators
   by device time;
4. the same for the captured step (``make_slam_step``: one CUDA graph,
   ``utils/graphs.py``) from the same state on the same frames: wall
   time unprofiled, device busy time, idle share, the kernels inside the
   graph per frame and the graph launches per frame, and the capture's ms.

Steps 1-3 run the eager ``slam_step``.
With --out, the summary and the full operator table are written to FILE.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import functools
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = ("build_ragged_pyramid_pair", "_predict_pose", "_temporal_track", "_detect_topup",
          "_compute_descriptors", "_associate_landmarks", "_temporal_rematch",
          "_stereo_and_triangulate", "estimate_pose_cascade",
          "allocate_landmark_slots", "_keyframe_decision")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--out", default=None, help="write the full tables here")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from zenslam_tpu_torch.io.synthetic import make_sequence
    from zenslam_tpu_torch.pipeline import SlamConfig, init_state, make_slam_step, slam_step
    from zenslam_tpu_torch.utils import graphs
    from zenslam_tpu_torch.pipeline import step as step_mod

    if not torch.cuda.is_available():
        print("torch_profile_step: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    n_total = args.warmup + 3 * args.frames
    seq = make_sequence(np.random.default_rng(11), n_frames=n_total, width=args.size,
                        height=args.size, motion="arc", speed=0.5, device_render=True,
                        device=dev)
    cfg = SlamConfig()
    state = init_state(cfg, (args.size, args.size), device=dev)
    for t in range(args.warmup):
        state, _ = slam_step(cfg, seq.rig, state, seq.left[t], seq.right[t])
    torch.cuda.synchronize()

    # 1. stage times with synchronising wrappers
    stage_ms = collections.defaultdict(float)
    originals = {name: getattr(step_mod, name) for name in STAGES}

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stage_ms[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    for name, fn in originals.items():
        setattr(step_mod, name, timed(name, fn))
    t0 = time.perf_counter()
    first = args.warmup
    for t in range(first, first + args.frames):
        state, _ = slam_step(cfg, seq.rig, state, seq.left[t], seq.right[t])
    torch.cuda.synchronize()
    serial_ms = (time.perf_counter() - t0) * 1e3 / args.frames
    for name, fn in originals.items():
        setattr(step_mod, name, fn)

    # 2. the unwrapped step, unprofiled
    first += args.frames
    t0 = time.perf_counter()
    for t in range(first, first + args.frames):
        state, _ = slam_step(cfg, seq.rig, state, seq.left[t], seq.right[t])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.frames

    # 3. profiler over the unwrapped step
    first += args.frames
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(first, first + args.frames):
            state, _ = slam_step(cfg, seq.rig, state, seq.left[t], seq.right[t])
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3 / args.frames
    events = prof.key_averages()
    dev_attr = "device_time_total" if hasattr(events[0], "device_time_total") else "cuda_time_total"
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / args.frames
    launches = len(kernels) / args.frames

    # 4. the captured step over the same frames: untimed up to 2.'s first
    # frame (the capture included), then 2.'s frames timed, 3.'s profiled
    step = make_slam_step(cfg, seq.rig)
    gstate = init_state(cfg, (args.size, args.size), device=dev)
    first = args.warmup + args.frames
    for t in range(first):
        gstate, _ = step(gstate, seq.left[t], seq.right[t])
    capture = graphs.capture_ms()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(first, first + args.frames):
        gstate, _ = step(gstate, seq.left[t], seq.right[t])
    torch.cuda.synchronize()
    g_wall_ms = (time.perf_counter() - t0) * 1e3 / args.frames
    first += args.frames
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as gprof:
        for t in range(first, first + args.frames):
            gstate, _ = step(gstate, seq.left[t], seq.right[t])
        torch.cuda.synchronize()
    g_kernels = [e for e in gprof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    g_busy_ms = sum(e.time_range.elapsed_us() for e in g_kernels) / 1e3 / args.frames
    g_launch = sum(e.count for e in gprof.key_averages() if e.key == "cudaGraphLaunch")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    lines = [f"device {smi}; {args.size}x{args.size}, default SlamConfig, "
             f"{args.frames} frames after {args.warmup} warm-up",
             f"serialised stages: {serial_ms:.2f} ms/frame (stages synchronised)"]
    for k in STAGES:
        lines.append(f"  {k:28s} {stage_ms[k] / args.frames:8.3f} ms/frame")
    lines.append(f"step: {wall_ms:.2f} ms/frame wall unprofiled ({prof_ms:.2f} under the "
                 f"profiler); device busy {busy_ms:.3f} ms/frame, idle share "
                 f"{1 - busy_ms / wall_ms:.4f} of the unprofiled frame; "
                 f"{launches:.0f} device kernels/frame")
    lines.append(f"captured step (one CUDA graph): {g_wall_ms:.2f} ms/frame wall unprofiled; "
                 f"device busy {g_busy_ms:.3f} ms/frame, idle share "
                 f"{1 - g_busy_ms / g_wall_ms:.4f}; {len(g_kernels) / args.frames:.0f} device "
                 f"kernels/frame inside the graph, {g_launch / args.frames:.2f} graph "
                 f"launches/frame; capture (warm-up + capture) {capture[-1]:.1f} ms")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n\n"
                    + events.table(sort_by=dev_attr, row_limit=25) + "\n\ncaptured step:\n"
                    + gprof.key_averages().table(sort_by=dev_attr, row_limit=25) + "\n")
    print("\n".join(lines))
    print(events.table(sort_by=dev_attr, row_limit=12))
    return 0


if __name__ == "__main__":
    sys.exit(main())
