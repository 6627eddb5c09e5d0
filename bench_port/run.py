"""The port's benchmark: one cell of ``BENCHMARK.json`` for a fixed window.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up renders the cell's traffic pool on the card from the seed, builds
``zenslam_tpu_torch``'s full system (``pipeline/system.py:create_system``)
for the cell's configuration and warms that same system up on the traffic,
frame by frame, until every program the window calls has been captured.
The window then drives ``process_frame`` in a closed loop, the next frame
submitted as soon as the call returns, for ``--seconds``, and ends with
``flush_pipeline`` and a synchronise. After it the outputs are handed to
the plain reference (``reference/judge.py``), which decides ``correct``.

End-to-end metrics (``--trace 0``): ``fps``, the frames whose telemetry came
back over the whole window; ``frame_p95_ms``, the 95th percentile over
every frame submitted in the window of the time from the start of the call
that submitted it to the return of the call (or the flush) that handed back
its telemetry and ran its keyframe back end; ``setup_s``, from the start of
this process to the window's start. With ``--trace 1`` the same window runs
with ``torch.profiler`` over its last ``trace_frames`` frames (from
``trace_before_end_s`` before its end), and the line carries the per-layer
metrics (``metrics/<name>.py``) instead.

The last line on stdout is the result's JSON object; the numbers compared
with the reference are the last lines on stderr. Without a CUDA card, or
with fewer cards than the cell asks for, it exits 2 and prints no result;
with a JAX module loaded after the window, 3.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from bench_port import finder  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "zenslam_tpu")
HOST_THREADS = 1    # intra-op threads: one process, few threads, on a host shared with others
STRETCH = "bench.stretch"


def forbidden_modules(names=None) -> list:
    """Loaded modules whose top-level name (before the first dot, whole) is
    JAX's or the JAX package's."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def cache_dirs(repo: Path) -> None:
    """Every kernel cache at a fixed path inside the checkout: the program's
    nvcc builds go to ``zenslam_tpu_torch/_build/`` by themselves, Triton's
    to ``.bench_cache/triton``."""
    os.environ["TRITON_CACHE_DIR"] = str(Path(repo) / ".bench_cache" / "triton")


def window_stats(submitted: dict, returned: dict, t0: float, t1: float) -> dict:
    """``submitted``: frame -> host time its call started; ``returned``:
    frame -> host time the call or flush that handed back its telemetry
    returned; [t0, t1] the window. fps counts the window's frames that came
    back over the whole window; the latencies are of every frame submitted
    in it (one that never came back counts as lasting to the window's end)."""
    lat = np.array([(returned.get(f, t1) - s) * 1e3 for f, s in submitted.items()])
    back = sum(f in returned for f in submitted)
    return {"fps": back / (t1 - t0), "latency_ms": lat,
            "frame_p95_ms": float(np.percentile(lat, 95)) if len(lat) else float("nan"),
            "frame_p50_ms": float(np.percentile(lat, 50)) if len(lat) else float("nan"),
            "returned": back}


def untraced_latency(submitted: dict, returned: dict, t1: float, stretch) -> np.ndarray:
    """The frame times (ms) of ``window_stats`` less those of frames in
    flight during the traced ``stretch`` (host times (start, end)), which
    the profiler slows."""
    lo, hi = stretch if stretch is not None else (np.inf, np.inf)
    return np.array([(returned.get(f, t1) - s) * 1e3 for f, s in submitted.items()
                     if returned.get(f, t1) < lo or s > hi])


def make_rig(cfg: dict, dev):
    """The configuration's rectified stereo rig as the program takes it (body
    = left camera)."""
    import torch

    from zenslam_tpu_torch.geometry.camera import PinholeCamera, StereoRig

    f32 = torch.float32

    def s(x):
        return torch.tensor(x, dtype=f32, device=dev)

    cam = PinholeCamera(fx=s(cfg["fx"]), fy=s(cfg["fy"]), cx=s(cfg["cx"]), cy=s(cfg["cy"]),
                        dist=torch.zeros(4, dtype=f32, device=dev), width=cfg["width"],
                        height=cfg["height"])
    eye = torch.eye(3, dtype=f32, device=dev)
    return StereoRig(left=cam, right=cam, R_rl=eye, t_rl=s([-cfg["baseline"], 0.0, 0.0]),
                     R_ci=eye.clone(), t_ci=torch.zeros(3, dtype=f32, device=dev))


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class BAProbe:
    """Stands in for ``pipeline/system.py:_windowed_ba`` (the windowed BA
    the keyframe back end calls) and hands every call on to it; while
    ``armed`` is above 0 it keeps device copies of a call's input keyframes
    and map and of its output, for the reference to redo the BA from the
    same input (``reference/judge.py:ba_reference``)."""

    IN = ("frame_idx", "valid", "R", "t", "kp_xy", "kp_uvr", "kp_lm", "kp_lm_gen",
          "kp_valid", "kp_stereo")

    def __init__(self, program):
        self.program, self.real = program, program._windowed_ba
        self.armed, self.records = 0, []
        program._windowed_ba = self

    def __call__(self, db, lmap_xyz, lmap_valid, lmap_gen, R_cw, t_cw, rig, **kw):
        if self.armed <= 0:
            return self.real(db, lmap_xyz, lmap_valid, lmap_gen, R_cw, t_cw, rig, **kw)
        kept = {k: getattr(db, k).clone() for k in self.IN}
        kept.update(lm_xyz=lmap_xyz.clone(), lm_valid=lmap_valid.clone(),
                    lm_gen=lmap_gen.clone())
        res = self.real(db, lmap_xyz, lmap_valid, lmap_gen, R_cw, t_cw, rig, **kw)
        self.records.append({"in": kept, "W": kw["W"], "iterations": kw["iterations"],
                             "solver": kw["solver"],
                             "out": {"R": res[0].clone(), "t": res[1].clone(),
                                     "lm_xyz": res[2].clone()}})
        self.armed -= 1
        return res

    def close(self) -> None:
        self.program._windowed_ba = self.real


class Driver:
    """Feeds the pool's frames to one system, frame after frame, and keeps
    what each call handed back; after the frames in ``snap_at`` returns,
    a copy of the step's outputs that the reference judges (``snapshot``),
    and from each of them on, the next windowed BA's input and output
    (``BAProbe``, once ``probe`` is set)."""

    def __init__(self, program, sysm, pool, dev, snap_at=()):
        import torch

        self.program, self.sysm, self.pool = program, sysm, pool
        S = pool.imu[0].shape[1] if pool.imu is not None else 0
        self.mask_on = torch.ones(S, dtype=torch.bool, device=dev)
        self.mask_off = torch.zeros(S, dtype=torch.bool, device=dev)
        self.snap_at = set(snap_at)
        self.probe = None
        self.snaps = {}      # frame -> snapshot (device tensors)
        self.tels = {}       # frame -> telemetry (numpy)
        self.infos = {}      # frame -> back-end info
        self.submitted = {}  # frame -> host time of the submitting call's start
        self.returned = {}   # frame -> host time of the handing-back return
        self.stretch = None  # (start, end) host times of the traced stretch

    def submit(self, timed: bool) -> None:
        f = self.sysm.n_frames
        i = self.pool.index(f)
        imu = None
        if self.pool.imu is not None:
            g, a, d = self.pool.imu
            imu = (g[i], a[i], d[i], self.mask_on if f > 0 else self.mask_off)
        if self.probe is not None and f in self.snap_at:
            self.probe.armed += 1
        t0 = time.perf_counter()
        tel, info = self.program.process_frame(self.sysm, self.pool.left[i],
                                               self.pool.right[i], imu=imu)
        t1 = time.perf_counter()
        if timed:
            self.submitted[f] = t0
        if tel is not None:
            self._keep(tel, info, t1, timed)
        if f in self.snap_at:
            self.snaps[f] = snapshot(self.sysm.state)

    def flush(self, timed: bool) -> None:
        out = self.program.flush_pipeline(self.sysm)
        t1 = time.perf_counter()
        for tel, info in out:
            self._keep(tel, info, t1, timed)

    def _keep(self, tel, info, t1: float, timed: bool) -> None:
        f = info["frame"]
        if timed:
            self.returned[f] = t1
            self.tels[f] = tel
            self.infos[f] = info


def snapshot(state) -> dict:
    """Device copies (stream-ordered, so taken before the next step writes
    the state in place) of a frame's feature table, its pose and the map."""
    ft, lm = state.features, state.lmap
    keep = {"xy": ft.xy, "uv_r": ft.uv_r, "stereo_ok": ft.stereo_ok, "lm_idx": ft.lm_idx,
            "track_id": ft.track_id, "age": ft.age, "valid": ft.valid, "R": state.R_cw,
            "t": state.t_cw,
            "lm_xyz": lm.xyz, "lm_valid": lm.valid, "lm_gen": lm.generation}
    return {k: v.clone() for k, v in keep.items()}


def snap_frames(seed: int, first: int, seconds: float, per_s: float = 15.0,
                skip: int = 10, pairs: int = 12) -> list:
    """The sampled frames the reference judges, drawn from the seed: up to
    ``pairs`` consecutive pairs among the window's first ``per_s`` frames a
    second (so a system at that rate or more reaches them all), after its
    first ``skip``."""
    span = np.arange(first + skip, first + skip + max(1, int(per_s * seconds)))
    ends = np.random.default_rng(seed).choice(span, min(pairs, len(span)), replace=False)
    return sorted({int(f) for e in ends for f in (e - 1, e)})


def host_reads(sysm) -> int:
    return int(sum(sysm.host_reads.values()))


def outputs(drv: Driver) -> dict:
    """What the reference judges, copied to the host: the window's
    telemetry poses, the snapshots of the sampled frames and the judged
    windowed BA calls' inputs and outputs."""
    host = lambda t: t.cpu().numpy()  # noqa: E731
    recs = drv.probe.records if drv.probe is not None else []
    return {
        "tels": {f: {"R": np.asarray(t.R_cw, np.float32), "t": np.asarray(t.t_cw, np.float32),
                     "method": int(t.pose_method), "ok": bool(t.pose_ok)}
                 for f, t in drv.tels.items()},
        "snaps": {f: {k: host(v) for k, v in s.items()} for f, s in drv.snaps.items()},
        "ba": [dict(r, **{part: {k: host(v) for k, v in r[part].items()}
                          for part in ("in", "out")}) for r in recs],
    }


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def measure(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            repo: Path = finder.REPO_DIR, root: Path = finder.BENCH_DIR, log=print) -> dict:
    """Set-up and window of one run of cell ``name``; returns what the
    result is made of, the program's state freed. ``device`` is the card in
    a benchmark run; the tests pass 'cpu' at tiny sizes."""
    import torch

    from bench_port import traffic as traffic_mod
    from bench_port import trace as trace_mod
    from bench_port.reference import judge
    from zenslam_tpu_torch.pipeline import SlamConfig
    from zenslam_tpu_torch.pipeline import system as program
    from zenslam_tpu_torch.utils import graphs

    man = finder.manifest(repo)
    cell = finder.cell(man, name)
    cfg = finder.config(cell["config"], root)
    tfc = finder.traffic(cell["traffic"], root)
    dev = torch.device(device)

    pool = traffic_mod.build_pool(cfg, tfc, seed, dev)
    sysm = program.create_system(SlamConfig(**cfg["slam"]),
                                 program.BackendConfig(**cfg["backend"]), make_rig(cfg, dev),
                                 (cfg["height"], cfg["width"]), seed=seed % (1 << 31),
                                 device=dev)
    first = tfc["warmup_frames"]
    drv = Driver(program, sysm, pool, dev,
                 snap_frames(seed, first, seconds, tfc.get("judge_per_s", 15.0),
                             tfc.get("judge_skip", 10)))
    held, warm_captures = graphs.graphs_held(), []
    for f in range(tfc["warmup_frames"]):
        drv.submit(timed=False)
        if graphs.graphs_held() != held:
            held = graphs.graphs_held()
            warm_captures.append(f)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    held0, reads0, kf0 = graphs.graphs_held(), host_reads(sysm), sysm.n_keyframes
    loops0 = sysm.n_loop_closures
    prof, traced, raised = None, 0, None
    drv.probe = BAProbe(program)
    by_program = _held_by_program(graphs)
    # a traced run ends its window with the traced stretch, so that what the
    # profiler leaves behind falls on no frame that a metric reads
    trace_at = max(0.0, seconds - tfc["trace_before_end_s"]) if trace else np.inf
    t_start = time.perf_counter()
    setup_s = t_start - T_PROCESS
    try:
        while time.perf_counter() - t_start < seconds:
            if time.perf_counter() - t_start >= trace_at:
                prof = _traced_stretch(drv, tfc["trace_frames"], dev, log)
                traced = tfc["trace_frames"]
                break
            drv.submit(timed=True)
        drv.flush(timed=True)
    except Exception as e:  # a frame that raises fails the run; its frames count as failed
        raised = e
        log(f"[window] process_frame raised: {type(e).__name__}: {e}", file=sys.stderr)
    finally:
        drv.probe.close()
    sync(dev)
    t_end = time.perf_counter()
    stats = window_stats(drv.submitted, drv.returned, t_start, t_end)
    not_ok = sum(not bool(t.pose_ok) for t in drv.tels.values())
    m = {"man": man, "cell": cell, "cfg": cfg, "stats": stats, "setup_s": setup_s,
         "latency_untraced": untraced_latency(drv.submitted, drv.returned, t_end, drv.stretch),
         "raised": raised, "traced": traced, "warm_captures": warm_captures,
         "captures": graphs.graphs_held() - held0, "reads": host_reads(sysm) - reads0,
         "peak": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
         "n_kf": sysm.n_keyframes - kf0, "n_loops": sysm.n_loop_closures - loops0,
         "backend_ms": [i["backend_ms"] for f, i in drv.infos.items() if i["backend_ms"] > 0
                        and (drv.stretch is None or drv.returned[f] < drv.stretch[0])],
         "loops_at": sorted(f for f, i in drv.infos.items() if i["loop"]),
         "not_ok": not_ok, "failed": len(drv.submitted) - stats["returned"] + not_ok,
         "out": outputs(drv) if raised is None else None,
         "device": dev}
    world = (pool.world.normals.double().cpu().numpy(),
             pool.world.offsets.double().cpu().numpy())
    m["truth"] = judge.make_truth(
        pool.R_cw, pool.t_cw,
        lambda f, kind=pool.schedule, n=pool.left.shape[0]: traffic_mod.scene.schedule(kind, n, f),
        traffic_mod.intrinsics(cfg), cfg["baseline"], *world)
    del drv, sysm, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    m["trace"] = trace_mod.from_profiler(prof, STRETCH) if prof is not None else None
    log(f"[window] {len(stats['latency_ms'])} frames submitted, {stats['returned']} back, "
        f"{m['n_kf']} keyframes, {m['n_loops']} loop closures, {m['captures']} captures, "
        f"{m['reads']} host reads, pose_ok false on {not_ok}; captured in the window: "
        f"{_captured_since(graphs, by_program)}; longest back ends (ms): "
        f"{sorted(m['backend_ms'])[-3:]}; warm-up captures at frames "
        f"{warm_captures}; {len(m['out']['snaps']) if m['out'] else 0} frames and "
        f"{len(m['out']['ba']) if m['out'] else 0} windowed BA calls judged", file=sys.stderr)
    return m


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             repo: Path = finder.REPO_DIR, root: Path = finder.BENCH_DIR, log=print) -> dict:
    """One run of cell ``name``; returns the result object (arguments as
    ``measure``'s)."""
    import torch

    from bench_port.reference import judge

    m = measure(name, seed, seconds, trace, device, repo, root, log)
    stats, cfg, dev = m["stats"], m["cfg"], m["device"]
    # the comparison with the plain reference, after the program's state is freed
    limits = finder.limits(name, root)
    correct, checks = False, {k: {"value": float("nan"), "limit": limits[k]}
                              for k in judge.NUMBERS if k in limits}
    if m["out"] is not None:
        correct, checks = judge.judge(judge.readings(m["out"], m["truth"]), limits)
    correct = correct and m["raised"] is None and stats["returned"] == len(stats["latency_ms"])

    run = {"latency_ms": m["latency_untraced"], "backend_ms": m["backend_ms"],
           "captures": m["captures"], "host_reads": m["reads"], "frames": stats["returned"],
           "trace": m["trace"], "trace_frames": m["traced"], "config": cfg}
    if trace:
        metrics = {}
        for spec in finder.layer_metrics(m["man"], name):
            v = finder.metric_reader(spec["name"], root)(run)
            if v is not None:
                metrics[spec["name"]] = {"value": float(v), "unit": spec["unit"]}
    else:
        e2e = {"fps": stats["fps"], "frame_p95_ms": stats["frame_p95_ms"],
               "setup_s": m["setup_s"]}
        metrics = {spec["name"]: {"value": float(e2e[spec["name"]]), "unit": spec["unit"]}
                   for spec in finder.e2e_metrics(m["man"], name)}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                   "count": int(m["cell"]["chips"]), "memory_peak_bytes": int(m["peak"])}
    result = {"correct": bool(correct), "attempted": len(stats["latency_ms"]),
              "failed": int(m["failed"]), "metrics": metrics, "device": device_info}
    if m["trace"] is not None:
        device_info["busy_s"] = m["trace"]["busy_s"]
        device_info["window_s"] = m["trace"]["window_s"]
        result["breakdown"] = {"device_ops": m["trace"]["device_ops"],
                               "idle_gaps": m["trace"]["idle_gaps"]}
    result["checks"] = checks
    return result


def _held_by_program(graphs) -> dict:
    """Captured graphs held, by program name."""
    held = {}
    for p in list(graphs._PROGRAMS):
        name = getattr(p.fn, "__qualname__", repr(p.fn))
        held[name] = held.get(name, 0) + len(p.captured)
    return held


def _captured_since(graphs, before: dict) -> dict:
    """Programs that captured since ``before`` (``_held_by_program``), with
    how many graphs each."""
    now = _held_by_program(graphs)
    return {k: v - before.get(k, 0) for k, v in now.items() if v > before.get(k, 0)}


def _traced_stretch(drv: Driver, frames: int, dev, log=print):
    """``frames`` timed frames under ``torch.profiler`` (events kept in
    memory), inside the host span ``STRETCH``, synchronised at its end so
    the stretch's device work falls inside it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    t0 = time.perf_counter()
    try:
        with record_function(STRETCH):
            for _ in range(frames):
                drv.submit(timed=True)
            sync(dev)
    finally:
        drv.stretch = (t0, time.perf_counter())
        prof.stop()
        log(f"[trace] {frames} frames in {drv.stretch[1] - drv.stretch[0]:.3f} s, the "
            f"profiler's stop {time.perf_counter() - drv.stretch[1]:.3f} s", file=sys.stderr)
    return prof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("bench_port.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    repo = finder.REPO_DIR
    cache_dirs(repo)
    cell = finder.cell(finder.manifest(repo), args.workload)
    import torch

    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"bench_port: the cell needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: modules loaded that the port must not load: {bad}",
              file=sys.stderr)
        return 3
    print(f"[card] {card_line()}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"[check] {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
