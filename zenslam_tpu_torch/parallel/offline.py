"""Data-parallel offline mode over chunks of a sequence — counterpart of
``zenslam_tpu/parallel/offline.py``.

The sequence is split into overlapping chunks, each chunk runs the full
front end on its own (one chunk per process or GPU; ``worker_fn`` is the
hook), and the per-chunk trajectories, each in its own gauge, are stitched
through the shared overlap frames into one trajectory, with the per-chunk
maps re-expressed in the global frame and merged. ``split_chunks`` and
``stitch_chunks`` are numpy and give the reference's outputs. (The
reference's private ``_se3_chain`` helper, which nothing calls, is not
carried over.)
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from zenslam_tpu_torch.pipeline.runner import run_sequence


def split_chunks(n_frames: int, n_chunks: int, overlap: int):
    """Chunk boundaries [(start, end)) with ``overlap`` shared frames between
    consecutive chunks (chunk k re-processes the last ``overlap`` frames of
    chunk k-1 to observe the same poses for stitching)."""
    assert n_chunks >= 1 and overlap >= 1
    base = int(np.ceil((n_frames + (n_chunks - 1) * overlap) / n_chunks))
    bounds = []
    start = 0
    for c in range(n_chunks):
        end = min(start + base, n_frames)
        bounds.append((start, end))
        if end >= n_frames:
            break
        start = end - overlap
    return bounds


def _chunk_result(tel, st):
    """(R_cw, t_cw, map_xyz, map_valid, map_desc) of one chunk as numpy."""
    lm = st.lmap
    return (np.asarray(tel.R_cw), np.asarray(tel.t_cw), lm.xyz.cpu().numpy(),
            lm.valid.cpu().numpy(), lm.desc.cpu().numpy())


def run_offline_chunks(cfg, rig, left: np.ndarray, right: np.ndarray, n_chunks: int,
                       overlap: int = 3, imu=None, worker_fn: Optional[Callable] = None,
                       seed: int = 0, device=None):
    """Run a (T, H, W) stereo sequence as ``n_chunks`` independent chunk jobs
    and stitch. Returns a dict with per-frame (R_cw, t_cw) in the GLOBAL
    (chunk-0) frame, the merged landmark cloud and descriptors (int32
    words), and the chunk bounds.

    worker_fn(chunk_idx, left, right, imu) -> (telemetry, final_state): hook
    for dispatching chunks elsewhere; default ``run_sequence`` here, in
    turn, with ``seed`` on ``device`` (default CUDA, raising when absent)."""
    T = left.shape[0]
    bounds = split_chunks(T, n_chunks, overlap)

    def default_worker(c, l, r, im):
        st, tel = run_sequence(cfg, rig, l, r, seed=seed, imu=im, device=device)
        return tel, st

    worker = worker_fn or default_worker
    results = []
    for c, (s, e) in enumerate(bounds):
        im = None if imu is None else tuple(x[s:e] for x in imu)
        tel, st = worker(c, left[s:e], right[s:e], im)
        results.append(_chunk_result(tel, st))
    return stitch_chunks(T, bounds, results, overlap)


def stitch_chunks(T: int, bounds, results, overlap: int):
    """Stitch per-chunk results (each in its own gauge) into the global
    (chunk-0) frame. ``results[c]`` = (R_cw (t,3,3), t_cw (t,3),
    map_xyz (M,3), map_valid (M,), map_desc (M,D)) as numpy arrays —
    shared by the in-process and multi-process paths."""
    R_all = np.zeros((T, 3, 3), np.float32)
    t_all = np.zeros((T, 3), np.float32)
    G_R = np.eye(3, dtype=np.float32)   # world_global -> world_chunk
    G_t = np.zeros(3, np.float32)
    maps = []
    for c, ((s, e), (Rs, ts, m_xyz, m_valid, m_desc)) in enumerate(zip(bounds, results)):
        if c > 0:
            _, e_prev = bounds[c - 1]
            # stitch at the LAST overlap frame: chunk c has tracked overlap-1
            # frames by then (its local frame 0 is its gauge anchor with an
            # identity pose, useless for alignment)
            f = e_prev - 1                # global index of the shared frame
            R_g, t_g = R_all[f], t_all[f]
            R_l, t_l = Rs[overlap - 1], ts[overlap - 1]
            # x_cam = R_l x_wC + t_l and x_cam = R_g x_wG + t_g
            # -> x_wC = R_l^T R_g x_wG + R_l^T (t_g - t_l)
            G_R = R_l.T @ R_g
            G_t = R_l.T @ (t_g - t_l)
        # x_cam = R x_wC + t with x_wC = G_R x_wG + G_t: R' = R G_R, t' = R G_t + t
        Rg = np.einsum("kij,jl->kil", Rs, G_R)
        tg = np.einsum("kij,j->ki", Rs, G_t) + ts
        lo = s + (overlap if c > 0 else 0)
        off = overlap if c > 0 else 0
        # overlap frames keep the previous chunk's pose (it had more history)
        R_all[lo:e] = Rg[off:]
        t_all[lo:e] = tg[off:]
        xyz_g = (m_xyz - G_t) @ G_R       # x_wG = G_R^T (x_wC - G_t)
        maps.append((xyz_g, m_valid, m_desc))

    merged_xyz = np.concatenate([m[0][m[1]] for m in maps], axis=0)
    merged_desc = np.concatenate([m[2][m[1]] for m in maps], axis=0)
    return {"R_cw": R_all, "t_cw": t_all, "map_xyz": merged_xyz, "map_desc": merged_desc,
            "bounds": bounds}


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rig_arrays(rig) -> dict:
    """The rig as the arrays ``offline_worker`` reads back."""
    arrays = {k: _host(getattr(rig, k)) for k in ("R_rl", "t_rl", "R_ci", "t_ci")}
    for p, cam in (("l_", rig.left), ("r_", rig.right)):
        arrays.update({p + k: _host(getattr(cam, k)) for k in ("fx", "fy", "cx", "cy", "dist")})
        arrays.update({p + "w": np.asarray(cam.width), p + "h": np.asarray(cam.height)})
    return arrays


def run_offline_multiprocess(cfg, rig, left: np.ndarray, right: np.ndarray, n_workers: int,
                             overlap: int = 3, imu=None, workdir: Optional[str] = None,
                             device=None, seed: int = 0, pin_cpus: bool = True,
                             cpus_per_worker: Optional[int] = None, timeout: float = 1200.0):
    """One OS process per chunk, all started together
    (``python -m zenslam_tpu_torch.parallel.offline_worker in.npz out.npz``):
    the single-machine stand-in for one chunk per host or GPU. Same chunks,
    seed and stitching as ``run_offline_chunks``, so the same numbers up to
    float determinism.

    device: where the workers run (default CUDA; ``"cpu"`` on request).
    Before CUDA workers start, the parent builds the CUDA kernels, so every
    worker loads the same libraries and none runs nvcc.
    pin_cpus: partition the machine's cores across the workers with
    ``sched_setaffinity`` (``cpus_per_worker`` each, default an equal
    share), so the workers do not thrash one core pool. Pinned or not, a
    worker runs that many torch threads: two unpinned CPU workers with a
    thread per core each ran 40x slower than one."""
    import json
    import subprocess
    import sys
    import tempfile

    from zenslam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        from zenslam_tpu_torch.ops.cuda_build import build

        build(["lk_fb", "orb"])
    T = left.shape[0]
    bounds = split_chunks(T, n_workers, overlap)
    workdir = workdir or tempfile.mkdtemp(prefix="zs_offline_")
    os.makedirs(workdir, exist_ok=True)
    all_cpus = sorted(os.sched_getaffinity(0))
    per = cpus_per_worker or max(1, len(all_cpus) // max(len(bounds), 1))
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")

    procs = []
    try:
        for c, (s, e) in enumerate(bounds):
            cpus = (all_cpus[c * per:(c + 1) * per] or all_cpus) if pin_cpus else None
            meta = {"cfg": dict(cfg._asdict()), "device": str(dev), "seed": seed, "cpus": cpus,
                    "threads": per}
            arrays = {"meta": np.asarray(json.dumps(meta)), "left": _host(left[s:e]),
                      "right": _host(right[s:e]), **_rig_arrays(rig)}
            if imu is not None:
                gyro, accel, imu_dts, imu_mask = (_host(x[s:e]) for x in imu)
                arrays.update(gyro=gyro, accel=accel, imu_dts=imu_dts, imu_mask=imu_mask)
            in_path = os.path.join(workdir, f"chunk{c}_in.npz")
            out_path = os.path.join(workdir, f"chunk{c}_out.npz")
            np.savez(in_path, **arrays)
            procs.append((c, out_path, subprocess.Popen(
                [sys.executable, "-m", "zenslam_tpu_torch.parallel.offline_worker",
                 in_path, out_path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)))
        results = [None] * len(bounds)
        for c, out_path, p in procs:
            out, _ = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(
                    f"offline worker {c} failed (rc={p.returncode}):\n{out[-4000:]}")
            blob = np.load(out_path)
            results[c] = (blob["R_cw"], blob["t_cw"], blob["map_xyz"], blob["map_valid"],
                          blob["map_desc"])
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return stitch_chunks(T, bounds, results, overlap)
