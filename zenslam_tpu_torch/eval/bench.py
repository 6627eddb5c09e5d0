"""The headline benchmark's frame rates on the port — counterpart of
``bench.py``: stereo SLAM frames/s on one card against the reference C++
system's published CPU number.

    python3 -m zenslam_tpu_torch.eval.bench [--device cuda]

Three runs, in the reference's order, on the 'arc' sequence rendered on the
device (seed 11, speed 0.5):

- secondary: the step at 512x384 over 60 frames (8 untimed);
- full system: ``process_frame`` with ``BackendConfig(telemetry_lag=3)`` at
  1024x1024 over 80 frames (a throwaway system over every frame first, then a
  fresh one: 10 untimed frames, the other 70 and the final
  ``flush_pipeline`` timed), with the median host ``backend_ms`` of its
  keyframes;
- primary: the step at 1024x1024 over 208 frames (8 untimed, 200 timed).

The step is ``make_slam_step``'s captured program and the system's is its
own (``utils/graphs.py``: CUDA graphs, the reference's jit), so the
first untimed frame captures it.

Each timed span ends in ``torch.cuda.synchronize``, where the reference
waits on ``jax.block_until_ready``; the clock is the host's. The stderr
lines are the reference's, plus the launches of the two hand kernels over
each run's timed frames, whether the programs were captured, and the card's
name and power limit (``nvidia-smi
--query-gpu=name,power.limit``). The last line on stdout is the
reference's one JSON object: ``metric``, ``value`` (the primary fps),
``unit``, ``vs_baseline`` (against 0.063 s a frame). The run is on CUDA
unless ``--device`` names another device; with no card it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

# the reference C++ system's mean processing time on TUM-VI corridor1
# (1024x1024 stereo), on its author's CPU (BASELINE.md)
BASELINE_S_PER_FRAME = 0.063


def _arc_sequence(width: int, height: int, n_frames: int, seed: int, device):
    """The benchmark's sequence: the 'arc' at speed 0.5, rendered on
    ``device``."""
    from zenslam_tpu_torch.io.synthetic import make_sequence

    return make_sequence(np.random.default_rng(seed), n_frames=n_frames, width=width,
                         height=height, motion="arc", speed=0.5, device_render=True,
                         device=device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def kernel_launches() -> dict:
    """The hand kernels' launch counters."""
    from zenslam_tpu_torch.ops.lk_cuda import lk_ragged
    from zenslam_tpu_torch.ops.orb_cuda import orb_steered_brief

    return {"lk_fb": lk_ragged.launches, "orb": orb_steered_brief.launches}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in kernel_launches().items()}


def run_fps(width, height, n_frames, n_warmup=8, seed=11, device=None, record=None):
    """Frames/s of the step (``make_slam_step``: the captured ``slam_step``,
    plain under ``graphs.eager()``) with the default config: ``n_warmup``
    untimed frames, the rest timed. Returns (fps, the last frame's
    telemetry). ``record``: a dict filled with ``seq``, ``packed`` (a copy
    of every frame's packed telemetry, ``pack_telemetry``'s layout, on the
    device), ``tels`` (float32 views of them), ``before_last`` (a copy of
    the state before the last frame), ``step`` (the captured step) and
    ``launches`` (the kernels' launches over the timed frames)."""
    from zenslam_tpu_torch.pipeline import SlamConfig, init_state, make_slam_step
    from zenslam_tpu_torch.utils.graphs import fresh
    from zenslam_tpu_torch.pipeline.state import split_telemetry
    from zenslam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    seq = _arc_sequence(width, height, n_frames, seed, dev)
    cfg = SlamConfig()
    step = make_slam_step(cfg, seq.rig)
    state = init_state(cfg, (height, width), device=dev)
    packed = []

    def frame(state, t):
        if record is not None and t == n_frames - 1:
            record["before_last"] = fresh(state)
        state, tel, p = step.run(state, seq.left[t], seq.right[t])
        if record is not None:
            packed.append(p)
        return state, tel

    for t in range(n_warmup):
        state, tel = frame(state, t)
    _sync(dev)
    before = kernel_launches()
    t0 = time.perf_counter()
    for t in range(n_warmup, n_frames):
        state, tel = frame(state, t)
    _sync(dev)
    dt = time.perf_counter() - t0
    if record is not None:
        record.update(seq=seq, packed=packed, tels=[split_telemetry(p) for p in packed],
                      step=step, launches=_since(before))
    return (n_frames - n_warmup) / dt, tel


def system_pass(sysm, left, right, n_warmup: int, record=None, around=None):
    """The timed pass of the full-system benchmark over the frames ``left``,
    ``right`` through the system ``sysm``: ``n_warmup`` untimed frames, then
    the rest and the final ``flush_pipeline`` timed up to a synchronise,
    inside the context manager ``around`` when one is given. Returns
    (seconds, the host ``backend_ms`` of every timed frame whose keyframe
    back end ran). ``record``: a dict filled with ``tels`` and ``infos`` (the
    rows that carried telemetry, in order), ``n_warmup_rows`` (how many of
    them came before the timed frames) and ``launches`` (the kernels'
    launches over the timed frames)."""
    from zenslam_tpu_torch.pipeline.system import flush_pipeline, process_frame

    tels, infos, backend_ms = [], [], []

    def keep(tel, info, timed: bool):
        if timed and info["backend_ms"] > 0:
            backend_ms.append(info["backend_ms"])
        if tel is not None:
            tels.append(tel)
            infos.append(info)

    for t in range(n_warmup):
        keep(*process_frame(sysm, left[t], right[t]), timed=False)
    _sync(sysm.device)
    n_warmup_rows = len(infos)
    before = kernel_launches()
    with around if around is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        for t in range(n_warmup, len(left)):
            keep(*process_frame(sysm, left[t], right[t]), timed=True)
        for tel, info in flush_pipeline(sysm):
            keep(tel, info, timed=True)
        _sync(sysm.device)
        dt = time.perf_counter() - t0
    if record is not None:
        record.update(tels=tels, infos=infos, n_warmup_rows=n_warmup_rows,
                      launches=_since(before))
    return dt, backend_ms


def run_full_system_fps(width, height, n_frames, n_warmup=10, seed=11, device=None,
                        record=None, around=None):
    """Full-system frames/s: the per-frame step plus the keyframe back end
    (windowed BA, loop-closure gate, landmark spill and reload). A throwaway
    system first runs every frame and the flush, so the back end's first
    uses (allocator growth, solver handles, the vocabulary's bootstrap and
    retrain) fall outside the measurement; then a fresh system runs
    ``system_pass``. Returns (fps, median ``backend_ms``, keyframes whose
    back end ran in the timed frames). ``record`` (given ``seq`` and
    ``system`` before the pass) and ``around``: as for ``system_pass``."""
    from zenslam_tpu_torch.pipeline import SlamConfig
    from zenslam_tpu_torch.pipeline.system import (
        BackendConfig, create_system, flush_pipeline, process_frame)
    from zenslam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    seq = _arc_sequence(width, height, n_frames, seed, dev)
    cfg = SlamConfig()
    warm = create_system(cfg, BackendConfig(telemetry_lag=3), seq.rig, (height, width),
                         device=dev)
    for t in range(n_frames):
        process_frame(warm, seq.left[t], seq.right[t])
    flush_pipeline(warm)
    _sync(dev)
    del warm

    sysm = create_system(cfg, BackendConfig(telemetry_lag=3), seq.rig, (height, width),
                         device=dev)
    if record is not None:
        record.update(seq=seq, system=sysm)
    dt, backend_ms = system_pass(sysm, seq.left, seq.right, n_warmup, record, around)
    med = float(np.median(backend_ms)) if backend_ms else 0.0
    return (n_frames - n_warmup) / dt, med, len(backend_ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("zenslam_tpu_torch.eval.bench",
                                 description="stereo SLAM frames/s on one card (bench.py)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising when absent)")
    args = ap.parse_args(argv)

    from zenslam_tpu_torch.eval.check_run import card_line
    from zenslam_tpu_torch.utils.graphs import graphs_held, graphs_on
    from zenslam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    baseline_fps = 1.0 / BASELINE_S_PER_FRAME
    launches = {}

    rec = {}
    fps_small, _ = run_fps(512, 384, 60, device=dev, record=rec)
    launches["secondary"] = rec["launches"]
    print(f"secondary 512x384: {fps_small:.2f} fps "
          f"(vs_baseline {fps_small / baseline_fps:.3f})", file=sys.stderr)

    rec = {}
    fps_full, med_backend, n_kf = run_full_system_fps(1024, 1024, 80, device=dev, record=rec)
    launches["full-system"] = rec["launches"]
    print(f"full-system 1024x1024 (70 timed frames, backend on): "
          f"{fps_full:.2f} fps, {n_kf} keyframes, median backend "
          f"{med_backend:.1f} ms/kf (vs_baseline "
          f"{fps_full / baseline_fps:.3f})", file=sys.stderr)

    rec = {}
    fps, tel = run_fps(1024, 1024, 208, device=dev, record=rec)
    launches["primary"] = rec["launches"]
    print(f"primary 1024x1024 (200 timed frames): {fps:.2f} fps, "
          f"tracked {int(tel.n_tracked)}, map {int(tel.map_size)}, "
          f"inliers {int(tel.n_pose_inliers)}", file=sys.stderr)
    print("launches over the timed frames: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()), file=sys.stderr)
    print(f"captured programs: {'off (eager)' if not graphs_on() else 'on'}, "
          f"{graphs_held()} held", file=sys.stderr)
    print(card_line() if dev.type == "cuda" else f"device {dev}", file=sys.stderr)

    print(json.dumps({
        "metric": "stereo_slam_frames_per_second_single_chip_1024x1024",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / baseline_fps, 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
