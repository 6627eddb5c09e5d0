#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--compare DIR ...]

Phases (each one fatal on failure):

1. device: name, count and the card's power limit (nvidia-smi);
2. build: both CUDA kernels from ``zenslam_tpu_torch/csrc`` (one nvcc per
   source, all in parallel, with those of every ``--compare`` directory),
   printing ptxas' register / shared-memory / spill lines; a kernel of this
   tree with a stack frame or spills fails the phase;
3. lk: the LK kernel against its plain PyTorch version on a rendered
   1024x1024 stereo pair, 512 detected points, the per-frame step's exact
   arguments (with and without init_pts); timed two ways (see below);
4. orb: the ORB kernel against its plain version, full and with a ~10%
   ``needs`` mask; timed likewise;
5. slice: ``slam_step`` alone, default SlamConfig, on the first 40 frames of
   a 1024x1024 'arc' sequence rendered on the card (8 warm-up frames, then
   the measured frames with every launch counter set to 0 first): exactly 2
   LK and 1 ORB launches per frame, pose_ok on >= 90% of frames, ATE <
   0.05 m; prints ms/frame, fps, peak memory;
6. system: the full keyframe system as ``bench.py:run_full_system_fps``
   drives it: ``create_system`` with the default SlamConfig and
   ``BackendConfig(telemetry_lag=3)``, ``process_frame`` over the 80-frame
   sequence (a throwaway system first warms the back end's first uses;
   frames 0-9 untimed, then counters at 0, frames 10-79 and
   ``flush_pipeline`` timed up to a synchronise). Prints ms/frame, fps, the
   median host ``backend_ms`` per keyframe and of each of its phases,
   keyframes, BA runs, vocabulary trains, archive size, peak memory, ATE,
   pose_ok, launches, and the host syncs (the system's waits on its
   device->host copies by kind, and every implicit synchronise that
   ``torch.cuda.set_sync_debug_mode`` reports, by source line). Requires 2
   LK + 1 ORB launches per timed frame, >= 8 keyframes (the vocabulary
   retrain at 8 runs), a BA run on every keyframe after the first, each
   with rmse_after <= 1.05 rmse_before and no dropped observations,
   pose_ok >= 0.9 and ATE < 0.05 m. Two untimed repeats of the 80-frame
   run (one as it is, one under ``torch.use_deterministic_algorithms``)
   print how far each window's rmse_before differs from the timed run's,
   and every window's robust cost, rmse and five worst residuals
   (keyframe, landmark, px) before and after BA;
7. loop: the 64-frame 320x240 orbit of ``tests/test_loop_closure.py``
   (seed 21, pixel noise 0.01, radius 1.0, host render) through
   ``run_system`` twice, loop closure off and on with that test's configs:
   at least one loop closes, and the keyframe ATE with loops is below the
   one without; 2 LK + 1 ORB launches per frame in each run;
8. kidnap: ``tests/test_place_recognition.py``'s kidnap run (112-frame
   448x336 orbit, frames 80-95 skipped) for the port alone, relocalisation
   off and on, on the kernel path and on the f32 path that test runs: the
   kidnap breaks the run without reloc (tail revisit error > 1 m), 1-4
   relocalisations happen with it, on the f32 path one at or after the
   kidnap; prints each attempt;
9. app: the shipped EuRoC recipe through ``zenslam_tpu_torch.app.main`` on
   an 80-frame 752x480 EuRoC-layout dataset rendered through
   ``options/euroc_camchain.yaml`` (distorted radtan; rectification, CLAHE,
   the native reader, telemetry, ``--no-imu --no-scene``), checked by
   ``zenslam_tpu_torch.eval.check_run`` against
   ``options/euroc_mh_expected.json`` (ATE, RPE, mean tracked, problem-frame
   share; steady ms/frame and fps reported, no fps floor): 2 LK + 1 ORB
   launches per frame, a BA run per keyframe after the first; the LK kernel
   against its plain version on the app's first pyramids; a checkpoint
   after frame 40 loaded back bit-identical;
10. a ``kernels`` JSON line (``launches`` is the system phase's count,
   ``launches_by_path`` every path's), the nvidia-smi line, and last the
   result line ``{"ok": true, "device": {...}}``.

Each kernel is timed two ways, each as the median and min-max of
``REPEATS`` repeats per turn: ``ms`` is the time per wrapper call (CUDA
events around back-to-back calls: the host's shape checks and ctypes call
plus the kernel, what the main path pays), ``device_ms`` the device time per
launch (``DEVICE_CALLS`` calls captured in one CUDA graph and replayed
between CUDA events, so the host's work is not timed). With ``--compare
DIR`` (repeatable) the kernels built from ``DIR/lk_fb.cu`` and/or
``DIR/orb.cu`` (another revision's or a variant's, same C interface) are
checked against the plain versions and timed the same way, in turns: every
DIR, this tree twice, every DIR in reverse order.

``bound_ms`` is the larger of the bytes the kernel must move over HBM's rate
(the 32-byte sectors of the texels this run's data reads, each once, plus
the small inputs and outputs) and its f32 operations over the f32 peak.

It exits non-zero without a result when no CUDA device is present or when
the ``zenslam_tpu_torch`` package is not next to it. It imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
import warnings
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

N_FRAMES = 40        # slice phase: frames of the rendered sequence it runs
N_WARMUP = 8
SYSTEM_FRAMES = 80   # system phase (bench.py:run_full_system_fps)
SYSTEM_WARMUP = 10
APP_FRAMES = 80      # app phase: the exported EuRoC-layout sequence
APP_CKPT_FRAME = 40  # app phase: the checkpoint round trip saves after this frame
SIZE = 1024
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
REPEATS = 5          # timed repeats per turn
DEVICE_CALLS = 50    # wrapper calls captured in one CUDA graph


class PhaseError(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseError(msg)


def _events_ms(run, count: int) -> float:
    """ms per item of ``run()``, which does ``count`` items, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count


def time_calls(fn, reps: int, repeats: int = REPEATS, warmup: int = 3) -> list:
    """ms per call of ``fn`` (host + device), one value per repeat of
    ``reps`` back-to-back calls, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    return [_events_ms(run, reps) for _ in range(repeats)]


def time_device(fn, calls: int = DEVICE_CALLS, repeats: int = REPEATS) -> list:
    """Device ms per launch of ``fn``, one value per repeat: ``calls``
    calls captured into one CUDA graph, replayed between CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return [_events_ms(graph.replay, calls) for _ in range(repeats)]


def summary(ms: list) -> dict:
    """Median and [min, max] of repeated timings."""
    return {"median": float(np.median(ms)), "spread": [float(min(ms)), float(max(ms))]}


@contextlib.contextmanager
def kernels_from(csrc_dir):
    """Inside the block the wrappers launch the kernels built from
    ``csrc_dir`` (this tree's when None). A timing aid of this script: the
    package itself always loads ``csrc/``."""
    from zenslam_tpu_torch.ops import cuda_build

    if csrc_dir is None:
        yield
        return
    load = cuda_build.load
    cuda_build.load = lambda name: load(name, csrc_dir)
    try:
        yield
    finally:
        cuda_build.load = load


def compared(kernel: str, compare: list) -> list:
    """The --compare directories that hold ``kernel``'s source."""
    return [d for d in compare if (Path(d) / f"{kernel}.cu").is_file()]


def time_turns(fn, reps: int, dirs: list) -> dict:
    """Per-call and device times of ``fn`` with this tree's kernels ("new")
    and with those of each directory in ``dirs``, in turns: the directories,
    new, new, the directories in reverse order."""
    order = [*dirs, None, None, *dirs[::-1]]
    raw = {d or "new": {"call": [], "device": []} for d in order}
    for d in order:
        with kernels_from(d):
            raw[d or "new"]["device"] += time_device(fn)
            raw[d or "new"]["call"] += time_calls(fn, reps)
    return {who: {k: summary(v) for k, v in t.items()} for who, t in raw.items()}


def sector_bytes(mask, elem: int) -> int:
    """Bytes of the 32-byte sectors that hold the True texels of a (h, w)
    row-major image of ``elem``-byte texels."""
    import torch

    per = 32 // elem
    h, w = mask.shape
    pad = torch.nn.functional.pad(mask, (0, -w % per))
    return int(pad.reshape(h, -1, per).any(-1).sum()) * 32


def box_mask(h: int, w: int, lx, ly, side: int, hx=None, hy=None):
    """(h, w) bool mask of the union of boxes [lx, lx+side) x [ly, ly+side)
    (int tensors, one box per row), each cut at hx / hy (inclusive, default
    the box's end) and at the image."""
    import torch

    d = torch.arange(side, device=lx.device)
    xs = lx[:, None] + d
    ys = ly[:, None] + d
    okx = (xs < w) if hx is None else (xs <= hx[:, None]) & (xs < w)
    oky = (ys < h) if hy is None else (ys <= hy[:, None]) & (ys < h)
    keep = oky[:, :, None] & okx[:, None, :] & (xs >= 0)[:, None, :] & (ys >= 0)[:, :, None]
    idx = (ys.clamp(0, h - 1)[:, :, None] * w + xs.clamp(0, w - 1)[:, None, :])[keep]
    mask = torch.zeros(h * w, dtype=torch.bool, device=lx.device)
    mask[idx] = True
    return mask.reshape(h, w)


def report_times(tag: str, times: dict) -> None:
    for who, t in times.items():
        c, d = t["call"], t["device"]
        print(f"[{tag}] {who} kernel: device {d['median']:.5f} ms/launch "
              f"[{d['spread'][0]:.5f}, {d['spread'][1]:.5f}], per call "
              f"{c['median']:.5f} ms [{c['spread'][0]:.5f}, {c['spread'][1]:.5f}]")


def kernel_entry(times: dict, **fields) -> dict:
    new = times["new"]
    return dict(fields, ms=new["call"]["median"], ms_spread=new["call"]["spread"],
                device_ms=new["device"]["median"], device_ms_spread=new["device"]["spread"])


def phase_device():
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[device] {name} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    return name, count, smi_line


def phase_build(compare: list):
    from zenslam_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    dirs = [cuda_build.CSRC_DIR, *compare]
    names = [[k for k in ("lk_fb", "orb") if (Path(d) / f"{k}.cu").is_file()] for d in dirs]
    with ThreadPoolExecutor(len(dirs)) as pool:
        all_logs = list(pool.map(cuda_build.build, names, dirs))
    for name, text in all_logs[0].items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "Compiling entry")):
                print(f"[build] {name}: {line.strip()}")
        frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", text)
        require(frames and all(f == ("0", "0", "0") for f in frames),
                f"build: ptxas reports a stack frame or spills for {name}")
    for d, logs in zip(compare, all_logs[1:]):
        for name, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {d} {name}: {line.strip()}")
    print(f"[build] {sum(map(len, names))} sources in {time.perf_counter() - t0:.1f} s")


def render_inputs(dev):
    """The arc sequence on the card, and 512 FAST keypoints of frame 0."""
    import torch

    from zenslam_tpu_torch.io.synthetic import make_sequence
    from zenslam_tpu_torch.ops.fast import detect_grid_keypoints

    t0 = time.perf_counter()
    seq = make_sequence(np.random.default_rng(11), n_frames=SYSTEM_FRAMES, width=SIZE,
                        height=SIZE, motion="arc", speed=0.5, device_render=True,
                        device=dev)
    torch.cuda.synchronize()
    xy, _, valid = detect_grid_keypoints(
        seq.left[0], torch.zeros((512, 2), device=dev), torch.zeros(512, dtype=torch.bool, device=dev),
        max_keypoints=512, subpixel=True)
    require(int(valid.sum()) >= 400, f"only {int(valid.sum())} keypoints detected")
    print(f"[render] {SYSTEM_FRAMES} stereo frames {SIZE}x{SIZE} in "
          f"{time.perf_counter() - t0:.1f} s; {int(valid.sum())} keypoints")
    return seq, xy, valid


def lk_bytes(prev, nxt, xy, valid, tracked, ok, radius: int, bwd_levels: int) -> int:
    """Bytes of the pyramid sectors the LK kernel reads on these inputs. Per
    level: the template footprint of every valid point (exact), and the
    Newton window at its final flow scaled to the level (the steps before it
    move the window by a few texels); the backward pass likewise, around
    the forward result, for the rows that end ok."""
    import torch

    G, win = 2 * radius + 3, 2 * radius + 1

    def template(h, w, x, y):  # texels tap_lo(off) .. tap_hi(off + G - 1)
        out = []
        for c, n in ((x, w), (y, h)):
            off = (c - radius) - 1.0
            lo = torch.floor(off.clamp(0, n - 1)).long()
            hi = (torch.floor((off + (G - 1)).clamp(0, n - 1)).long() + 1).clamp(max=n - 1)
            out += [lo, hi]
        return out

    def window(h, w, x, y):  # texels floor(o) .. floor(o) + win + 2, clamped
        out = []
        for c, n in ((x, w), (y, h)):
            f = torch.floor((c - radius) - 1.0).long()
            lo = f.clamp(0, n - 1)
            hi = ((f + win + 1).clamp(0, n - 1) + 1).clamp(max=n - 1)
            out += [lo, hi]
        return out

    src, dst = xy[valid], tracked[valid]
    back_src, back_dst = tracked[ok], xy[ok]
    total = 0
    for lvl, (a, b) in enumerate(zip(prev, nxt)):
        h, w = a.shape
        sc = 1.0 / (1 << lvl)
        boxes = {0: [template(h, w, *(src * sc).unbind(-1))],
                 1: [window(h, w, *(dst * sc).unbind(-1))]}
        if lvl < bwd_levels:
            boxes[1].append(template(h, w, *(back_src * sc).unbind(-1)))
            boxes[0].append(window(h, w, *(back_dst * sc).unbind(-1)))
        for img, bs in boxes.items():
            mask = torch.zeros((h, w), dtype=torch.bool, device=xy.device)
            for lx, hx, ly, hy in bs:
                mask |= box_mask(h, w, lx, ly, G + 1, hx, hy)
            total += sector_bytes(mask, a.element_size())
    return total


def check_lk_cases(tag: str, cases: dict, xy, valid, args: dict) -> float:
    """The LK kernel against its plain version on each (prev pyramid, next
    pyramid, init_pts) case: max |dxy| <= 0.01 px on rows ok in both, ok
    flags agreeing on >= 99% of valid rows, invalid rows passed through.
    Returns the largest |dxy|."""
    import torch

    from zenslam_tpu_torch.ops.lk_cuda import lk_ragged, lk_ragged_plain

    max_err = 0.0
    for name, (a, b, ip) in cases.items():
        tk, ok_k, _ = lk_ragged(a, b, xy, valid, init_pts=ip, **args)
        tp, ok_p, _ = lk_ragged_plain(a, b, xy, valid, init_pts=ip, **args)
        torch.cuda.synchronize()
        both = ok_k & ok_p
        agree = float((ok_k == ok_p)[valid].float().mean())
        d = float((tk - tp).abs()[both].max()) if bool(both.any()) else 0.0
        max_err = max(max_err, d)
        print(f"[{tag}] {name}: ok kernel {int(ok_k.sum())} plain {int(ok_p.sum())}, "
              f"flags agree {agree:.4f}, max |dxy| on ok-in-both {d:.2e} px")
        require(torch.isfinite(tk).all(), f"{tag} {name}: non-finite output")
        require(int(both.sum()) >= 0.5 * int(valid.sum()), f"{tag} {name}: too few tracks")
        require(d <= 0.01, f"{tag} {name}: |dxy| {d} > 0.01 px")
        require(agree >= 0.99, f"{tag} {name}: ok flags agree on {agree:.4f} < 0.99")
        inv = ~valid
        require(bool((tk[inv] == xy[inv]).all()) and not bool(ok_k[inv].any()),
                f"{tag} {name}: invalid rows not passed through")
    return max_err


def phase_lk(seq, xy, valid, dev, compare: list):
    import torch

    from zenslam_tpu_torch.ops.lk import build_ragged_pyramid_pair
    from zenslam_tpu_torch.ops.lk_cuda import lk_ragged, lk_ragged_plain

    bf16 = torch.bfloat16
    l0, l1 = build_ragged_pyramid_pair(seq.left[0], seq.left[1], 3, dtype=bf16)
    s0, r0 = build_ragged_pyramid_pair(seq.left[0], seq.right[0], 3, dtype=bf16)
    g = torch.Generator(device=dev).manual_seed(5)
    init = xy + 0.5 * torch.randn(xy.shape, generator=g, device=dev)
    args = dict(radius=10, iters=(5, 3, 3, 3), bwd_levels=1, compute_err=False,
                fb_threshold=1.0)
    cases = {"temporal": (l0, l1, None), "temporal+init": (l0, l1, init),
             "stereo": (s0, r0, None)}
    max_err = check_lk_cases("lk", cases, xy, valid, args)

    dirs = compared("lk_fb", compare)
    tp, ok_p, _ = lk_ragged_plain(l0, l1, xy, valid, init_pts=init, **args)
    for d in dirs:
        with kernels_from(d):
            tk, ok_k, _ = lk_ragged(l0, l1, xy, valid, init_pts=init, **args)
        both = ok_k & ok_p
        print(f"[lk] {d} kernel vs plain (temporal+init): flags agree "
              f"{float((ok_k == ok_p)[valid].float().mean()):.4f}, max |dxy| on ok-in-both "
              f"{float((tk - tp).abs()[both].max()):.2e} px")

    work = {}
    lk_ragged_plain(l0, l1, xy, valid, init_pts=init, work=work, **args)
    times = time_turns(lambda: lk_ragged(l0, l1, xy, valid, init_pts=init, **args), 100, dirs)
    plain_ms = float(np.median(time_calls(
        lambda: lk_ragged_plain(l0, l1, xy, valid, init_pts=init, **args), 10, repeats=3)))
    n = xy.shape[0]
    nbytes = lk_bytes(l0, l1, xy, valid, tp, ok_p, args["radius"], args["bwd_levels"]) \
        + n * (8 + 8 + 1) + n * (8 + 1 + 4)
    # f32 ops per bilinear sample (clamp, floor, weights, 6 mul + 3 add) ~ 20;
    # per Newton cell +3 (residual, two FMAs); per template cell +8 (gradients, sums)
    ops = 20 * (work["grid_samples"] + work["window_samples"]) \
        + 3 * work["window_samples"] + 8 * work["grid_samples"]
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    report_times("lk", times)
    print(f"[lk] plain {plain_ms:.3f} ms; bytes {nbytes} ({t_bytes:.5f} ms), samples {work} "
          f"({t_ops:.5f} ms), bound {max(t_bytes, t_ops):.5f} ms")
    return kernel_entry(times, name="lk_fb", route="cuda",
                        source="zenslam_tpu_torch/csrc/lk_fb.cu",
                        replaces="zenslam_tpu/ops/lk_pallas.py:95", max_abs_err=max_err,
                        plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops else "operations",
                        library_ms=None)


def orb_bytes(sm, xy, valid, c, s) -> int:
    """Bytes of the image sectors the ORB kernel reads on these inputs: the
    31x31 moment window of every row and, for valid rows, the nearest pixel
    of each pattern endpoint rotated by (c, s)."""
    import torch

    from zenslam_tpu_torch.ops.orb_cuda import _pattern

    H, W = sm.shape
    r = 15
    xi = torch.round(xy[:, 0]).long()
    yi = torch.round(xy[:, 1]).long()
    mask = box_mask(H, W, xi - r, yi - r, 2 * r + 1).reshape(-1)
    pat = _pattern(xy.device)
    xc, yc, c, s = xy[valid, 0:1], xy[valid, 1:2], c[valid, None], s[valid, None]
    for px, py in ((pat[:, 0], pat[:, 1]), (pat[:, 2], pat[:, 3])):
        kx = torch.round((xc + px * c) - py * s).long().clamp(0, W - 1)
        ky = torch.round((yc + px * s) + py * c).long().clamp(0, H - 1)
        mask[(ky * W + kx).reshape(-1)] = True
    return sector_bytes(mask.reshape(H, W), sm.element_size())


def phase_orb(seq, xy, valid, dev, compare: list):
    import torch

    from zenslam_tpu_torch.ops.image import gaussian_blur
    from zenslam_tpu_torch.ops.match import unpack_bits
    from zenslam_tpu_torch.ops.orb_cuda import orb_steered_brief, orb_steered_brief_plain

    sm = gaussian_blur(seq.left[0], sigma=2.0, radius=4).to(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(6)
    needs = (torch.rand(xy.shape[0], generator=g, device=dev) < 0.1) & valid
    wk, ck, sk = orb_steered_brief(sm, xy, valid)
    wp, cp, sp = orb_steered_brief_plain(sm, xy, valid)
    torch.cuda.synchronize()
    ham = (unpack_bits(wk) != unpack_bits(wp)).sum(-1)[valid].float()
    dth = (torch.atan2(sk, ck) - torch.atan2(sp, cp)).abs()[valid]
    dth = torch.minimum(dth, 2 * np.pi - dth)
    same = float((ham == 0).float().mean())
    print(f"[orb] rows identical {same:.4f}, mean Hamming {float(ham.mean()):.4f}, "
          f"median |dtheta| {float(dth.median()):.2e}, max {float(dth.max()):.2e}")
    require(same >= 0.99, f"orb: {same:.4f} rows identical < 0.99")
    require(float(ham.mean()) <= 1.0, "orb: mean Hamming > 1")
    require(float(dth.median()) <= 1e-4, "orb: median |dtheta| > 1e-4")
    require(not bool(wk[~valid].any()), "orb: invalid rows not all zero")
    wn, _, _ = orb_steered_brief(sm, xy, needs, needs=needs)
    torch.cuda.synchronize()
    require(bool((wn[needs] == wk[needs]).all()), "orb: needs rows differ from the full pass")
    print(f"[orb] needs mask: {int(needs.sum())} rows computed, bit-identical to the full pass")

    dirs = compared("orb", compare)
    for d in dirs:
        with kernels_from(d):
            wd, cd, sd = orb_steered_brief(sm, xy, valid)
        print(f"[orb] {d} kernel vs plain: rows identical "
              f"{float((wd == wp).all(-1)[valid].float().mean()):.4f}, max |dcos| "
              f"{float((cd - cp).abs().max()):.2e}, max |dsin| {float((sd - sp).abs().max()):.2e}")

    times = time_turns(lambda: orb_steered_brief(sm, xy, valid), 200, dirs)
    plain_ms = float(np.median(time_calls(
        lambda: orb_steered_brief_plain(sm, xy, valid), 20, repeats=3)))
    n = xy.shape[0]
    nbytes = orb_bytes(sm, xy, valid, cp, sp) + n * (8 + 1) + 256 * 16 + n * (32 + 8)
    # per keypoint: 961 moment taps x 4 ops, 512 rotated samples x 8 ops, 256 compares
    ops = n * (961 * 4 + 512 * 8 + 256)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    report_times("orb", times)
    print(f"[orb] plain {plain_ms:.3f} ms; bytes {nbytes} ({t_bytes:.5f} ms), ops {ops} "
          f"({t_ops:.5f} ms), bound {max(t_bytes, t_ops):.5f} ms")
    return kernel_entry(times, name="orb", route="cuda", source="zenslam_tpu_torch/csrc/orb.cu",
                        replaces="zenslam_tpu/ops/orb_pallas.py:56",
                        max_abs_err=float(dth.max()), plain_ms=plain_ms,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops else "operations",
                        library_ms=None)


def phase_slice(seq, dev):
    import torch

    from zenslam_tpu_torch.eval.metrics import ate_rmse, camera_positions
    from zenslam_tpu_torch.pipeline import SlamConfig, init_state, slam_step

    cfg = SlamConfig()
    state = init_state(cfg, (SIZE, SIZE), seed=0, device=dev)
    Rs, ts, ok = [], [], []
    for t in range(N_WARMUP):
        state, tel = slam_step(cfg, seq.rig, state, seq.left[t], seq.right[t])
        Rs.append(tel.R_cw), ts.append(tel.t_cw), ok.append(tel.pose_ok)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for t in range(N_WARMUP, N_FRAMES):
        state, tel = slam_step(cfg, seq.rig, state, seq.left[t], seq.right[t])
        Rs.append(tel.R_cw), ts.append(tel.t_cw), ok.append(tel.pose_ok)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    n = N_FRAMES - N_WARMUP
    R = torch.stack(Rs).cpu().numpy()
    tt = torch.stack(ts).cpu().numpy()
    pose_ok = torch.stack(ok).cpu().numpy()
    require(np.isfinite(R).all() and np.isfinite(tt).all(), "slice: non-finite pose")
    gt = camera_positions(seq.R_lw[:N_FRAMES], seq.t_lw[:N_FRAMES])
    ate = ate_rmse(camera_positions(R, tt), gt)
    ok_share = float(pose_ok[1:].mean())
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"[slice] {n} frames: {dt / n * 1e3:.2f} ms/frame, {n / dt:.2f} fps, peak "
          f"{peak:.1f} MiB; pose_ok {ok_share:.3f}, ATE {ate:.5f} m, "
          f"map {int(tel.map_size)}, launches {launches}")
    require(launches == {"lk_fb": 2 * n, "orb": n},
            f"slice: launches {launches} != 2 LK + 1 ORB per frame over {n} frames")
    require(ok_share >= 0.9, f"slice: pose_ok on {ok_share:.3f} < 0.9 of frames")
    require(ate < 0.05, f"slice: ATE {ate:.4f} m >= 0.05 m")
    return launches


def reset_launches():
    from zenslam_tpu_torch.ops.lk_cuda import lk_ragged
    from zenslam_tpu_torch.ops.orb_cuda import orb_steered_brief

    lk_ragged.launches = 0
    orb_steered_brief.launches = 0


def read_launches() -> dict:
    from zenslam_tpu_torch.ops.lk_cuda import lk_ragged
    from zenslam_tpu_torch.ops.orb_cuda import orb_steered_brief

    return {"lk_fb": lk_ragged.launches, "orb": orb_steered_brief.launches}


@contextlib.contextmanager
def implicit_syncs():
    """Inside the block, record every implicit synchronise that
    ``torch.cuda.set_sync_debug_mode`` reports; yields the list the
    records are appended to, in order."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            torch.cuda.set_sync_debug_mode("default")


def sync_sites(records) -> Counter:
    """The synchronise records among ``records``, counted by source line."""
    return Counter(f"{Path(w.filename).name}:{w.lineno}" for w in records
                   if "synchroniz" in str(w.message))


@contextlib.contextmanager
def backend_spans(system_module, records, spans: list):
    """Note in ``spans`` the (start, end) of ``records`` over each keyframe
    back-end call made inside the block."""
    inner = system_module._keyframe_backend

    def spanned(*args, **kwargs):
        start = len(records)
        try:
            return inner(*args, **kwargs)
        finally:
            spans.append((start, len(records)))

    system_module._keyframe_backend = spanned
    try:
        yield
    finally:
        system_module._keyframe_backend = inner


def phase_system(seq, dev):
    import torch

    from zenslam_tpu_torch.eval.metrics import ate_rmse, camera_positions
    from zenslam_tpu_torch.pipeline import SlamConfig
    from zenslam_tpu_torch.pipeline import system
    from zenslam_tpu_torch.pipeline.system import (
        BackendConfig, create_system, flush_pipeline, process_frame)

    cfg, bcfg = SlamConfig(), BackendConfig(telemetry_lag=3)
    # a throwaway system over the first frames: the back end's first uses
    # (solver handles, allocator growth) land outside the measured system
    warm = create_system(cfg, bcfg, seq.rig, (SIZE, SIZE))
    for t in range(16):
        process_frame(warm, seq.left[t], seq.right[t])
    flush_pipeline(warm)
    torch.cuda.synchronize()
    del warm

    s = create_system(cfg, bcfg, seq.rig, (SIZE, SIZE))
    tels, infos = [], []

    def keep(tel, info):
        if tel is not None:
            tels.append(tel)
            infos.append(info)

    for t in range(SYSTEM_WARMUP):
        keep(*process_frame(s, seq.left[t], seq.right[t]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kf0, reads0 = s.n_keyframes, Counter(s.host_reads)
    n_timed_infos = len(infos)
    spans = []
    reset_launches()
    t0 = time.perf_counter()
    with implicit_syncs() as records, backend_spans(system, records, spans):
        for t in range(SYSTEM_WARMUP, SYSTEM_FRAMES):
            keep(*process_frame(s, seq.left[t], seq.right[t]))
        for tel, info in flush_pipeline(s):
            keep(tel, info)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    in_backend = {i for a, b in spans for i in range(a, b)}
    back = sync_sites([r for i, r in enumerate(records) if i in in_backend])
    front = sync_sites([r for i, r in enumerate(records) if i not in in_backend])
    launches = read_launches()
    n = SYSTEM_FRAMES - SYSTEM_WARMUP
    timed = infos[n_timed_infos:]
    n_kf = s.n_keyframes - kf0
    backend = [i["backend_ms"] for i in timed if i["backend_ms"] > 0]
    phases = {}
    for i in timed:
        for k, v in i.get("phases", {}).items():
            phases.setdefault(k, []).append(v)
    R = np.stack([t.R_cw for t in tels])
    tt = np.stack([t.t_cw for t in tels])
    pose_ok = np.array([float(t.pose_ok) for t in tels])
    require(len(tels) == SYSTEM_FRAMES, f"system: {len(tels)} telemetry rows != {SYSTEM_FRAMES}")
    require(np.isfinite(R).all() and np.isfinite(tt).all(), "system: non-finite pose")
    ate = ate_rmse(camera_positions(R, tt), camera_positions(seq.R_lw, seq.t_lw))
    ok_share = float(pose_ok[1:].mean())
    runs = [i["ba"].cpu().numpy() for i in infos if i["ba"] is not None]
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    reads = Counter(s.host_reads)
    reads.subtract(reads0)
    print(f"[system] {n} frames: {dt / n * 1e3:.2f} ms/frame, {n / dt:.2f} fps, peak "
          f"{peak:.1f} MiB; backend_ms median {float(np.median(backend)):.2f} over "
          f"{len(backend)} keyframes (min {min(backend):.2f}, max {max(backend):.2f})")
    print("[system] phase medians (host ms per keyframe): " + ", ".join(
        f"{k} {float(np.median(v)):.3f}" for k, v in phases.items()))
    print(f"[system] keyframes {s.n_keyframes} ({n_kf} timed), BA runs {s.n_ba_runs}, vocabulary "
          f"trains {s.n_vocab_trains}, loop closures {s.n_loop_closures}, relocs {s.n_relocs}, "
          f"archive {len(s.archive)} rows ({s.archive.n_reloads} reloads); pose_ok "
          f"{ok_share:.3f}, ATE {ate:.5f} m, launches {launches}")
    print(f"[system] BA rmse before/after/dropped: "
          + "; ".join(f"{a:.4f}/{b:.4f}/{int(c)}" for a, b, c in runs))
    print(f"[system] host reads of device->host copies over the timed frames: {dict(reads)} "
          f"({sum(reads.values()) / n:.3f} per frame; {n_kf} keyframes)")
    nb, nf = sum(back.values()), sum(front.values())
    print(f"[system] implicit synchronises in the keyframe back end: {nb} over {len(spans)} "
          f"keyframes ({nb / max(len(spans), 1):.3f} per keyframe); by line: "
          + ", ".join(f"{k} x{v}" for k, v in back.most_common()))
    print(f"[system] implicit synchronises outside it (the step, telemetry): {nf} "
          f"({nf / n:.3f} per frame); by line: "
          + ", ".join(f"{k} x{v}" for k, v in front.most_common(16)))
    repeat_system(seq, cfg, bcfg, runs)
    require(launches == {"lk_fb": 2 * n, "orb": n},
            f"system: launches {launches} != 2 LK + 1 ORB per frame over {n} frames")
    require(s.n_keyframes >= 8, f"system: {s.n_keyframes} keyframes < 8")
    require(s.n_vocab_trains >= 2, f"system: {s.n_vocab_trains} vocabulary trains (no retrain)")
    require(s.n_ba_runs == s.n_keyframes - 1 == len(runs),
            f"system: {s.n_ba_runs} BA runs for {s.n_keyframes} keyframes")
    require(all(np.isfinite(r).all() and r[1] <= 1.05 * r[0] and r[2] == 0 for r in runs),
            "system: a BA run raised its rmse by > 5% or dropped observations")
    require(ok_share >= 0.9, f"system: pose_ok on {ok_share:.3f} < 0.9 of frames")
    require(ate < 0.05, f"system: ATE {ate:.4f} m >= 0.05 m")
    return launches


@contextlib.contextmanager
def worst_residuals(system_module, windows: list):
    """Inside the block, append to ``windows``, for every windowed BA, its
    five worst observations before and after it (keyframe index in the
    window, 0 = newest; landmark index in the compacted problem; px) and
    [robust cost before, after, rmse before, after, accepted LM steps,
    observations]."""
    import torch

    from zenslam_tpu_torch.backend.ba import _residuals_and_weights

    inner = system_module.bundle_adjust

    def top5(p, R, t, xyz):
        r, _, good, *_ = _residuals_and_weights(p, R, t, xyz, 1.0)
        n = torch.where(good, torch.linalg.vector_norm(r, dim=-1), -1.0)
        v, i = torch.topk(n, 5)
        return [(int(p.obs_kf[j]), int(p.obs_lm[j]), round(float(x), 2))
                for j, x in zip(i.tolist(), v.tolist())]

    def logged(p, **kwargs):
        res = inner(p, **kwargs)
        windows.append((top5(p, p.R, p.t, p.xyz), top5(p, res["R"], res["t"], res["xyz"]),
                        [round(float(res[k]), 3) for k in ("cost_before", "cost_after",
                                                            "rmse_before", "rmse_after")]
                        + [int(res["n_accepted"]), int(p.obs_valid.sum())]))
        return res

    system_module.bundle_adjust = logged
    try:
        yield
    finally:
        system_module.bundle_adjust = inner


def run_windows(seq, cfg, bcfg, deterministic: bool = False):
    """One untimed 80-frame system run: (the BA runs' [rmse_before,
    rmse_after, dropped], the five worst residuals of each window)."""
    import torch

    from zenslam_tpu_torch.pipeline import system
    from zenslam_tpu_torch.pipeline.system import create_system, flush_pipeline, process_frame

    windows, runs = [], []
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        with worst_residuals(system, windows):
            s = create_system(cfg, bcfg, seq.rig, (SIZE, SIZE))
            infos = [process_frame(s, seq.left[t], seq.right[t])[1] for t in range(SYSTEM_FRAMES)]
            infos += [i for _, i in flush_pipeline(s)]
            runs = [i["ba"].cpu().numpy() for i in infos if i["ba"] is not None]
    finally:
        torch.use_deterministic_algorithms(False)
    return runs, windows


def scatter_determinism(dev) -> None:
    """Whether a float scatter-add gives the same bits on every run: 20
    repeats of ``index_add_`` and of ``index_put_(accumulate=True)`` (what
    ``backend.ba.seg_add_`` uses on CUDA) over 60000 random (6, 6) rows
    into 16384 slots, as BA's block sums do."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, 16384, (60000,), device=dev, generator=g)
    vals = torch.randn(60000, 6, 6, device=dev, generator=g)
    for name, fn in (("index_add_", lambda z: z.index_add_(0, idx, vals)),
                     ("index_put_ accumulate", lambda z: z.index_put_((idx,), vals,
                                                                      accumulate=True))):
        outs = [fn(torch.zeros(16384, 6, 6, device=dev)) for _ in range(20)]
        same = sum(torch.equal(outs[0], o) for o in outs[1:])
        diff = float((torch.stack(outs) - outs[0]).abs().max())
        print(f"[system] {name}: {same} of 19 repeats bit-identical to the first, max |diff| "
              f"{diff:.3e}")


def repeat_system(seq, cfg, bcfg, timed_runs):
    """Run the 80-frame system again, once as it is and once under
    ``torch.use_deterministic_algorithms``, and print how far each BA
    window's rmse_before differs from the timed run's, and each window's
    robust cost, rmse and five worst residuals before and after BA."""
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    scatter_determinism(seq.left.device)
    reps = {name: run_windows(seq, cfg, bcfg, det) for name, det in
            (("again", False), ("deterministic", True))}
    base = np.array([r[0] for r in timed_runs])
    for name, (runs, _) in reps.items():
        b = np.array([r[0] for r in runs])
        if len(b) != len(base):
            print(f"[system] repeat {name}: {len(b)} BA windows, the timed run {len(base)}")
            continue
        print(f"[system] repeat {name}: max |rmse_before - timed run's| "
              f"{float(np.abs(b - base).max()):.3e} px over {len(b)} windows")
    for w, (before, after, stats) in enumerate(reps["again"][1]):
        print(f"[system] window {w}: robust cost, rmse before/after, accepted LM steps, "
              f"observations {stats}; worst residuals (kf, lm, px) before {before} after {after}")


def kf_ate(kf_db, seq) -> float:
    """Unaligned RMSE of keyframe camera centres against groundtruth (as
    tests/test_loop_closure.py:_kf_ate)."""
    fi, v = kf_db.frame_idx.cpu().numpy(), kf_db.valid.cpu().numpy()
    R, t = kf_db.R.cpu().numpy()[v], kf_db.t.cpu().numpy()[v]
    est = np.einsum("kij,kj->ki", np.transpose(R, (0, 2, 1)), -t)
    gt = np.stack([-seq.R_lw[f].T @ seq.t_lw[f] for f in fi[v]])
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, -1))))


def phase_loop(dev):
    import torch

    from zenslam_tpu_torch.io.synthetic import make_sequence
    from zenslam_tpu_torch.pipeline import SlamConfig
    from zenslam_tpu_torch.pipeline.system import BackendConfig, create_system, run_system

    t0 = time.perf_counter()
    seq = make_sequence(np.random.default_rng(21), n_frames=64, width=320, height=240,
                        motion="orbit", pixel_noise=0.01, orbit_radius=1.0, device=dev)
    cfg = SlamConfig(max_keypoints=256, max_landmarks=4096, kf_min_frames=2,
                     kf_min_translation=0.05)
    configs = {
        "off": BackendConfig(ba_every_kf=False, enable_loop_closure=False),
        "on": BackendConfig(ba_every_kf=False, enable_loop_closure=True, bow_branch=32,
                            bow_top_k=5, bow_min_score=0.20, bow_min_frame_gap=15,
                            loop_min_inliers=12)}
    out, launches = {}, {}
    for name, bcfg in configs.items():
        s = create_system(cfg, bcfg, seq.rig, (240, 320))
        reset_launches()
        t1 = time.perf_counter()
        run_system(s, seq.left, seq.right)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        launches[name] = read_launches()
        out[name] = s
        print(f"[loop] loops {name}: 64 frames in {dt:.2f} s, keyframes {s.n_keyframes}, "
              f"loop closures {s.n_loop_closures}, keyframe ATE {kf_ate(s.kf_db, seq):.5f} m, "
              f"launches {launches[name]}")
        require(launches[name] == {"lk_fb": 128, "orb": 64},
                f"loop {name}: launches {launches[name]} != 2 LK + 1 ORB per frame")
    fired = [d for d in out["on"].loop_debug if d["fired"]]
    print(f"[loop] fired: {fired}; phase {time.perf_counter() - t0:.1f} s")
    ate_off, ate_on = kf_ate(out["off"].kf_db, seq), kf_ate(out["on"].kf_db, seq)
    require(out["on"].n_loop_closures >= 1, "loop: no loop closed")
    require(ate_on < ate_off, f"loop: keyframe ATE with loops {ate_on:.5f} m >= without "
                              f"{ate_off:.5f} m")
    total = Counter()
    for v in launches.values():
        total.update(v)
    return dict(total)


def phase_app(dev):
    """The shipped EuRoC recipe's vision path through the port's app: a
    synthetic EuRoC-layout dataset rendered through options/euroc_camchain.yaml
    (752x480, distorted radtan, strafe, pixel noise 0.005, APP_FRAMES
    frames, no IMU), ``app.main`` with euroc_mh.yaml's slam and backend
    sections, ``calibration_file`` set and ``--no-imu --no-scene``, then the
    port's checker against options/euroc_mh_expected.json; the LK kernel
    against its plain version on the app's first pyramids (rectified, CLAHE,
    752x480: levels 188 and 94 are not whole 16-byte chunks); a checkpoint
    saved after frame APP_CKPT_FRAME and loaded back, bit-identical."""
    import io
    import tempfile
    from itertools import islice

    import torch
    import yaml

    from zenslam_tpu_torch import app
    from zenslam_tpu_torch.config import load_options
    from zenslam_tpu_torch.eval import check_run
    from zenslam_tpu_torch.io import checkpoint
    from zenslam_tpu_torch.io.calibration import compute_rectify_maps, load_kalibr_yaml
    from zenslam_tpu_torch.io.dataset import FolderReader
    from zenslam_tpu_torch.io.synthetic import export_dataset, make_distorted_sequence
    from zenslam_tpu_torch.ops.fast import detect_grid_keypoints
    from zenslam_tpu_torch.ops.image import clahe, remap
    from zenslam_tpu_torch.ops.lk import build_ragged_pyramid_pair
    from zenslam_tpu_torch.pipeline.system import create_system, process_frame

    here = Path(__file__).resolve().parent
    camchain = here / "options" / "euroc_camchain.yaml"
    t0 = time.perf_counter()
    rig_raw, models = load_kalibr_yaml(str(camchain), device=dev)
    seq = make_distorted_sequence(np.random.default_rng(9), rig_raw, models,
                                  n_frames=APP_FRAMES, motion="strafe", pixel_noise=0.005,
                                  device_render=True)
    with tempfile.TemporaryDirectory() as tmp:
        root, out = Path(tmp) / "mav0", Path(tmp) / "out"
        export_dataset(seq, str(root))
        t_export = time.perf_counter() - t0
        recipe = yaml.safe_load((here / "options" / "euroc_mh.yaml").read_text())
        opts_path = Path(tmp) / "euroc_mh.yaml"
        opts_path.write_text(yaml.safe_dump({
            "folder": {"root": str(root), "output": str(out), "calibration_file": str(camchain),
                       "groundtruth_file": str(root / "groundtruth.csv")},
            "slam": recipe["slam"], "backend": recipe["backend"]}))
        print(f"[app] exported {APP_FRAMES} stereo frames 752x480 (distorted radtan) in "
              f"{t_export:.1f} s; recipe slam {recipe['slam']}, backend {recipe['backend']}")
        reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = app.main(["--options-file", str(opts_path), "--no-imu", "--no-scene",
                           "--device", str(dev)])
        torch.cuda.synchronize()
        launches = read_launches()
        text = buf.getvalue()
        for line in text.splitlines():
            if line.strip():
                print(f"[app] | {line}")
        require(rc == 0, f"app: exit code {rc}")
        m = re.search(r"keyframes: (\d+), BA runs: (\d+), loop closures: (\d+)", text)
        require(m is not None, "app: no keyframe line")
        n_kf, n_ba, n_loops = (int(x) for x in m.groups())
        r = check_run.check(str(out))
        exp = r.get("exp", {})
        print(f"[app] launches {launches}; keyframes {n_kf}, BA runs {n_ba}, loop closures "
              f"{n_loops}")
        print(f"[app] checker: ATE {r.get('ate_mm', float('nan')):.1f} mm (bound "
              f"{exp.get('ate_bound_mm')}), RPE {r.get('rpe_mm', float('nan')):.1f} mm (bound "
              f"{exp.get('rpe_bound_mm')}), mean tracked {r.get('mean_tracked', 0):.1f} (min "
              f"{exp.get('min_tracked_mean')}), problem-frame share "
              f"{r.get('problem_fraction', 1):.3f} (max {exp.get('max_problem_frame_fraction')})")
        print(f"[app] steady {r.get('steady_ms', float('nan')):.2f} ms/frame, "
              f"{r.get('steady_fps', float('nan')):.2f} fps ({r.get('slow_frames')} frames over "
              f"100 ms) on {check_run.card_line()}")
        require(not r["failures"], f"app: checker failed: {r['failures']}")
        require(launches == {"lk_fb": 2 * APP_FRAMES, "orb": APP_FRAMES},
                f"app: launches {launches} != 2 LK + 1 ORB per frame over {APP_FRAMES} frames")
        require(n_ba == n_kf - 1 and n_kf >= 3, f"app: {n_ba} BA runs for {n_kf} keyframes")

        opts = load_options(str(opts_path))
        maps = compute_rectify_maps(rig_raw, models)
        mx = [torch.from_numpy(m).to(dev) for m in maps[:4]]

        def prep(frame):
            return (remap(app.upload(frame.left, dev), mx[0], mx[1]),
                    remap(app.upload(frame.right, dev), mx[2], mx[3]))

        frames = list(islice(FolderReader(str(root)).frames(), 2))
        (a0, b0), (a1, _) = (prep(f) for f in frames)
        a0, b0, a1 = (clahe(x, clip_limit=opts.slam.clahe_clip) for x in (a0, b0, a1))
        bf16 = torch.bfloat16
        L = opts.slam.pyramid_levels
        l0, l1 = build_ragged_pyramid_pair(a0, a1, L, dtype=bf16)
        s0, r0 = build_ragged_pyramid_pair(a0, b0, L, dtype=bf16)
        print(f"[app] LK pyramid level widths {[int(x.shape[1]) for x in l0]}")
        N = opts.slam.max_keypoints
        xy, _, valid = detect_grid_keypoints(
            a0, torch.zeros((N, 2), device=dev), torch.zeros(N, dtype=torch.bool, device=dev),
            max_keypoints=N, subpixel=True)
        g = torch.Generator(device=dev).manual_seed(5)
        init = xy + 0.5 * torch.randn(xy.shape, generator=g, device=dev)
        args = dict(radius=opts.slam.klt_radius, iters=(5, 3, 3, 3), bwd_levels=1,
                    compute_err=False, fb_threshold=1.0)
        lk_err = check_lk_cases("app", {"temporal": (l0, l1, None),
                                        "temporal+init": (l0, l1, init),
                                        "stereo": (s0, r0, None)}, xy, valid, args)

        ck = Path(tmp) / "system.npz"
        s = create_system(opts.slam, opts.backend, maps.rig_rectified, (480, 752), device=dev)
        for f in islice(FolderReader(str(root)).frames_prefetch(), APP_CKPT_FRAME):
            process_frame(s, *prep(f))
        checkpoint.save_system(str(ck), s)
        s2 = checkpoint.load_system(str(ck), opts.slam, opts.backend, maps.rig_rectified,
                                    (480, 752), device=dev)
        trees = [{"state": x.state, "kf_db": x.kf_db, "bow_db": x.bow_db,
                  "vocab": x.vocab, "queue": [q[1] for q in x._tel_queue]} for x in (s, s2)]
        la, lb = (checkpoint._flatten(t) for t in trees)
        same = [n for n, _ in la] == [n for n, _ in lb] and all(
            (x.dtype == y.dtype and x.device == y.device and torch.equal(x, y))
            if isinstance(x, torch.Tensor) else x == y for (_, x), (_, y) in zip(la, lb))
        same &= all(np.array_equal(p.numpy(), q.numpy())
                    for (p, _, _), (q, _, _) in zip(s._tel_queue, s2._tel_queue))
        same &= (s.edge_i == s2.edge_i and s.edge_j == s2.edge_j and s.edge_w == s2.edge_w
                 and all(np.array_equal(checkpoint._to_numpy(x), y)
                         for x, y in zip(s.edge_R + s.edge_t, s2.edge_R + s2.edge_t)))
        a, b = s.archive, s2.archive
        same &= (all(np.array_equal(getattr(a, k), getattr(b, k))
                     for k in ("xyz", "desc", "color", "dormant", "_slot_row", "_slot_gen"))
                 and a._row_key == b._row_key and a.reload_keys == b.reload_keys)
        print(f"[app] checkpoint after frame {APP_CKPT_FRAME}: {len(la)} tensors and numbers "
              f"of state, keyframe DB ({s.n_keyframes} keyframes), BoW DB, vocabulary and "
              f"telemetry queue ({len(s._tel_queue)}), {len(s.edge_i)} edges, archive "
              f"{len(a)} rows: {'bit-identical' if same else 'DIFFERENT'} after load_system "
              f"({ck.stat().st_size / 2 ** 20:.1f} MiB)")
        require(same, "app: checkpoint round trip on the card is not bit-identical")
    print(f"[app] phase {time.perf_counter() - t0:.1f} s")
    return launches, lk_err


def phase_kidnap(dev):
    """tests/test_place_recognition.py::TestRelocalizationAfterKidnap's run
    for the port alone: the 112-frame 448x336 orbit (1.75 turns, seed 33,
    pixel noise 0.01; rendered on the card), frames 80-95 skipped, loops on
    with a frame gap that never fires, relocalisation off and on; once on
    the main (kernel) path and once on the f32 path the reference's test
    runs (``use_pallas_lk=False``: f32 pyramid, the gather LK, no kernel).
    Requires on both: the run without reloc broken (tail revisit error >
    1 m), 1-4 relocalisations with it; on the f32 path one of them at or
    after the kidnap. Prints each attempt (frame, chosen keyframe's frame,
    score, inliers) and the tail errors (the reference's own 0.35 m bound is
    red in the reference and is not applied)."""
    import torch

    from zenslam_tpu_torch.io.synthetic import make_sequence
    from zenslam_tpu_torch.pipeline import SlamConfig
    from zenslam_tpu_torch.pipeline.system import BackendConfig, create_system, process_frame

    t0 = time.perf_counter()
    n, jump = 112, 80
    seq = make_sequence(np.random.default_rng(33), n_frames=n, width=448, height=336,
                        motion="orbit", pixel_noise=0.01, orbit_radius=1.0,
                        orbit_revolutions=1.75, device_render=True, device=dev)
    cfg = SlamConfig(max_keypoints=256, max_landmarks=4096, kf_min_frames=2,
                     kf_min_translation=0.05)
    order = list(range(0, jump)) + list(range(96, n))
    launches = Counter()
    for path, pcfg in (("kernel", cfg), ("f32", cfg._replace(use_pallas_lk=False))):
        out = {}
        for reloc in (False, True):
            bc = BackendConfig(ba_every_kf=False, enable_loop_closure=True,
                               enable_relocalization=reloc, reloc_lost_frames=1,
                               reloc_min_inliers=12, reloc_cooldown=10, bow_levels=2,
                               bow_branch=32, bow_min_score=0.20, bow_min_frame_gap=100000,
                               bow_top_k=3, loop_min_inliers=12, vocab_retrain_kfs=8)
            s = create_system(pcfg, bc, seq.rig, (336, 448), device=dev)
            centers = {}
            reset_launches()
            for fi in order:
                tel, _ = process_frame(s, seq.left[fi], seq.right[fi])
                centers[fi] = -tel.R_cw.T @ tel.t_cw
            torch.cuda.synchronize()
            if path == "kernel":
                launches.update(read_launches())
            err = float(np.mean([np.linalg.norm(centers[f] - centers[f - 64])
                                 for f in range(n - 3, n)]))
            kf_frames = s.kf_db.frame_idx.cpu().numpy()
            events = [dict(d, kf_frame=int(kf_frames[d["slot"]])) for d in s.reloc_debug]
            out[reloc] = (s, err, events)
            print(f"[kidnap] {path} path, reloc {'on' if reloc else 'off'}: relocs {s.n_relocs}, "
                  f"keyframes {s.n_keyframes}, tail revisit error {err:.4f} m; attempts "
                  f"(frame = frames processed, the kidnap at {jump}) {events}")
        (_, err_off, _), (s_on, err_on, events) = out[False], out[True]
        require(err_off > 1.0, f"kidnap {path}: without reloc the tail error {err_off:.3f} m "
                               "<= 1 m (the kidnap did not break the run)")
        require(1 <= s_on.n_relocs <= 4,
                f"kidnap {path}: {s_on.n_relocs} relocalisations (want 1-4)")
        after = [e for e in events if e["fired"] and e["frame"] >= jump]
        print(f"[kidnap] {path} path: {len(after)} relocalisation(s) at or after the kidnap; "
              f"tail error {err_off:.4f} m without reloc, {err_on:.4f} m with")
        if path == "f32":
            require(after, "kidnap f32: no relocalisation at or after the kidnap")
    print(f"[kidnap] phase {time.perf_counter() - t0:.1f} s")
    require(dict(launches) == {"lk_fb": 4 * len(order), "orb": 2 * len(order)},
            f"kidnap: launches {dict(launches)} on the kernel path")
    return dict(launches)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", action="append", default=[], metavar="DIR",
                    help="directory with another revision's (or a variant's) lk_fb.cu "
                         "and/or orb.cu to check and time beside this tree's kernels "
                         "(repeatable)")
    compare = ap.parse_args().compare
    try:
        import torch
        import zenslam_tpu_torch  # noqa: F401  (the package beside this script)
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e})", file=sys.stderr)
        return 2
    try:
        name, count, smi_line = phase_device()
        phase_build(compare)
        dev = torch.device("cuda")
        seq, xy, valid = render_inputs(dev)
        lk = phase_lk(seq, xy, valid, dev, compare)
        orb = phase_orb(seq, xy, valid, dev, compare)
        paths = {"slice": phase_slice(seq, dev), "system": phase_system(seq, dev),
                 "loop": phase_loop(dev)}
        paths["kidnap"] = phase_kidnap(dev)
        paths["app"], app_lk_err = phase_app(dev)
        lk["max_abs_err"] = max(lk["max_abs_err"], app_lk_err)
    except PhaseError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    for k in (lk, orb):
        k["launches"] = paths["system"][k["name"]]
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()}
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "ms_spread", "device_ms", "device_ms_spread", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: d[k] for k in keys} for d in (lk, orb)]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
