#!/usr/bin/env python3
"""Where the device time of zenslam_tpu_torch's captured step goes, on one GPU.

    python3 scripts/torch_profile_step.py [--frames 32] [--warmup 8] [--profiled 16]
                                          [--size 1024] [--out FILE]

Runs the default SlamConfig's captured step (``make_slam_step``: one CUDA
graph, ``utils/graphs.py``) on a device-rendered 'arc' sequence (as
chip_smoke.py does) with the program's tracing on (``utils/tracing.py``):
the stage stamps replay inside the graph, so nothing synchronises between
stages and the frame is the one the system replays. Over the measured
frames it prints:

1. the stage table: each stage's device ms a frame (median, min, max),
   from the stamps, and the step program's device span;
2. the host's ``frame.replay`` ms (input copies and ``cudaGraphLaunch``)
   and the wall ms a frame;
3. the device's idle share of the measured stretch (1 - the union of the
   device spans over it) and its longest idle intervals, named by the host
   span open at their middle (the eager noise draw and the upload are not
   inside a program: they count as idle);
4. the stamps a replay, the clock fit's uncertainty and the capture's ms;
5. over --profiled more frames, also recorded by ``torch.profiler``: the
   share of the stretch that the program's device spans cover, beside the
   union of the device operations that the profiler saw over the same
   frames; and, a replay, the step's span from its first to its last stamp
   kernel on the profiler's clock beside the union of the operations
   inside it. A span covers the gaps between the graph's nodes; the union
   does not, so their difference is the time the card spends between the
   nodes of the graph. The step's span from the stamps, with the profiler
   and without, says what the profiler adds inside the graph.

With --out, the table is also written to FILE. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEP = "_step_program"
STAMP_KERNEL = "stamp_kernel"


def union_ns(intervals) -> int:
    """The length of the union of (start, end) intervals."""
    total, hi = 0, None
    for s, e in sorted(intervals):
        if hi is None or s > hi:
            total += e - s
            hi = e
        elif e > hi:
            total += e - hi
            hi = e
    return total


def profiled_ops(prof) -> list:
    """(start ns, end ns, name) of every device operation in a finished
    ``torch.profiler`` trace (not the device track's copies of host
    annotations), sorted."""
    from torch.autograd import DeviceType

    return sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
                  for ev in prof.profiler.kineto_results.events()
                  if ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation())


def in_graph(ops, per_replay: int) -> tuple:
    """A replay at a time (``per_replay`` stamp kernels each, after the
    first stamp kernel, which is ``tracing.reset``'s clock stamp): the
    step's span from its first to its last stamp kernel and the union of
    the operations inside it, in ms; the stretch from the first replay's
    first stamp kernel to the last replay's last, (start ns, end ns); the
    stamp kernels seen."""
    stamps = [i for i, (_, _, name) in enumerate(ops) if STAMP_KERNEL in name]
    spans, busy, bounds = [], [], []
    for k in range(1, len(stamps) - per_replay + 1, per_replay):
        a, b = stamps[k], stamps[k + per_replay - 1]
        spans.append((ops[b][1] - ops[a][0]) * 1e-6)
        busy.append(union_ns([(s, e) for s, e, _ in ops[a:b + 1]]) * 1e-6)
        bounds.append((ops[a][0], ops[b][1]))
    return spans, busy, (bounds[0][0], bounds[-1][1]), len(stamps)


def stage_table(device_spans) -> dict:
    """{stage name: [ms of each call of the step]} over the step program's
    spans, the stages found under each (in the order first seen)."""
    root = []
    for i, s in enumerate(device_spans):
        root.append(i if s.parent < 0 else root[s.parent])
    calls = [i for i, s in enumerate(device_spans) if s.name == STEP]
    table = collections.OrderedDict()
    for i, s in enumerate(device_spans):
        if root[i] in calls and s.name.startswith("step."):
            table.setdefault(s.name, {})
            table[s.name][root[i]] = table[s.name].get(root[i], 0.0) + (s.end - s.start) * 1e-6
    out = collections.OrderedDict()
    for name, per in table.items():
        out[name] = [per.get(i, 0.0) for i in calls]
    out[STEP] = [(device_spans[i].end - device_spans[i].start) * 1e-6 for i in calls]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--profiled", type=int, default=16,
                    help="frames also recorded by torch.profiler (0: none)")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--out", default=None, help="write the table here")
    args = ap.parse_args()

    import torch

    from zenslam_tpu_torch.io.synthetic import make_sequence
    from zenslam_tpu_torch.pipeline import SlamConfig, init_state, make_slam_step
    from zenslam_tpu_torch.utils import graphs, tracing

    if not torch.cuda.is_available():
        print("torch_profile_step: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    seq = make_sequence(np.random.default_rng(11),
                        n_frames=args.warmup + args.frames + args.profiled,
                        width=args.size, height=args.size, motion="arc", speed=0.5,
                        device_render=True, device=dev)
    cfg = SlamConfig()
    tracing.enable()
    step = make_slam_step(cfg, seq.rig)
    state = init_state(cfg, (args.size, args.size), device=dev)
    for t in range(args.warmup):
        state, _ = step(state, seq.left[t], seq.right[t])
    capture = tracing.collect()
    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    for t in range(args.warmup, args.warmup + args.frames):
        with tracing.span("frame", frame=t):
            state, tel = step(state, seq.left[t], seq.right[t])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.frames
    got = tracing.collect()
    if args.profiled:
        from torch.profiler import ProfilerActivity, profile

        first = args.warmup + args.frames
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tracing.reset()
            for t in range(first, first + args.profiled):
                with tracing.span("frame", frame=t):
                    state, tel = step(state, seq.left[t], seq.right[t])
            torch.cuda.synchronize()
            profiled = tracing.collect()
    tracing.disable()

    (entry,) = step.program.captured.values()
    stamps = entry.launches[graphs._counters().index((tracing.counters, "stamps"))]
    table = stage_table(got["device"])
    lo, hi = got["window_ns"]
    idle_ns = sum(e - s for s, e, _ in got["idle"])
    by_name = collections.Counter()
    for s, e, name in got["idle"]:
        by_name[name] += (e - s) * 1e-6
    replay = [(s.end - s.start) * 1e-6 for s in got["host"] if s.name == "frame.replay"]
    capture_ms = [(s.end - s.start) * 1e-6 for s in capture["host"]
                  if s.name == "graphs.capture" and s.detail == STEP]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    lines = [f"device {smi}; {args.size}x{args.size}, default SlamConfig, captured step, "
             f"{args.frames} frames after {args.warmup} warm-up; tracing on "
             f"({stamps} stamps a replay, clock fit within {got['fit_ns']} ns, "
             f"dropped {got['dropped']})",
             f"{'stage':24s} {'median':>9s} {'min':>9s} {'max':>9s}  device ms a frame"]
    for name, ms in table.items():
        lines.append(f"{name:24s} {np.median(ms):9.3f} {min(ms):9.3f} {max(ms):9.3f}")
    stage_sum = sum(float(np.median(ms)) for k, ms in table.items() if k != STEP)
    lines.append(f"sum of the stage medians {stage_sum:.3f} ms; wall {wall_ms:.3f} ms a frame; "
                 f"host frame.replay median {np.median(replay):.3f} ms")
    lines.append(f"device idle {idle_ns / (hi - lo):.4f} of the stretch ({(hi - lo) * 1e-6:.1f} "
                 "ms); idle ms by the host span open: " + ", ".join(
                     f"{k} {v:.3f}" for k, v in by_name.most_common(6)))
    lines.append(f"capture of the step (warm-up + capture): "
                 f"{', '.join(f'{ms:.1f}' for ms in capture_ms)} ms")
    if args.profiled:
        ops = profiled_ops(prof)
        spans, busy, (o_lo, o_hi), n_stamps = in_graph(ops, stamps)
        p_lo, p_hi = profiled["window_ns"]
        covered = union_ns([(x.start, x.end) for x in profiled["device"]])
        ops_busy = union_ns([(max(s, o_lo), min(e, o_hi)) for s, e, _ in ops
                             if e > o_lo and s < o_hi])
        p_table = stage_table(profiled["device"])
        lines.append(f"profiled, {args.profiled} frames (tracing on, the profiler recording): "
                     f"program spans cover {covered / (p_hi - p_lo):.4f} of the window "
                     f"({(p_hi - p_lo) * 1e-6:.1f} ms; {covered * 1e-6 / args.profiled:.3f} ms "
                     f"a frame); the union of the profiler's device operations "
                     f"{ops_busy / (o_hi - o_lo):.4f} of the replays' stretch "
                     f"({(o_hi - o_lo) * 1e-6:.1f} ms, first to last stamp kernel; "
                     f"{ops_busy * 1e-6 / args.profiled:.3f} ms a frame); dropped "
                     f"{profiled['dropped']}")
        lines.append(f"a replay ({len(spans)} of {args.profiled}, {n_stamps} stamp kernels seen): "
                     f"the step's span first to last stamp kernel median "
                     f"{np.median(spans):.3f} ms [{min(spans):.3f}, {max(spans):.3f}], the union "
                     f"of the operations inside it {np.median(busy):.3f} ms "
                     f"[{min(busy):.3f}, {max(busy):.3f}]: between the graph's nodes "
                     f"{1 - np.median(busy) / np.median(spans):.4f} of the span; the step's span "
                     f"from its stamps {np.median(p_table[STEP]):.3f} ms profiled, "
                     f"{np.median(table[STEP]):.3f} not")
    print("\n".join(lines))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
