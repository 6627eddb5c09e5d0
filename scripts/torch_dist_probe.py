#!/usr/bin/env python3
"""Where the port's offline chunker and sharded BA part from their baselines.

    python3 scripts/torch_dist_probe.py strafe [--seeds 0 1 2 ...]   # on the card
    python3 scripts/torch_dist_probe.py orbit [--window N]           # on the card
    python3 scripts/torch_dist_probe.py strafe|orbit --device cpu [--reference]

``strafe`` runs the stage 2 of ``__graft_entry__.py:dryrun_multichip``
(the 10-frame 192x144 strafe at 0.5 m/s, ``SlamConfig(max_keypoints=192,
max_landmarks=1024, pnp_iters=64, rigid_iters=64)``) for each seed, on
the kernel path (on CUDA) and on the f32 path: the serial run over all 10
frames, each of the 2 chunks of ``split_chunks(10, 2, 3)`` alone, and
their stitch. It prints every frame's camera-centre x against the truth's
and the frame-to-frame steps, every frame's x error beside its yaw error
and their ratio, and per seed and path the stitched and serial dx against
the truth, the yaw-corrected error (x error + 6 m x yaw error, 6 m being
the end wall's distance) and the dry run's verdict (sign, 0.15 m).

``orbit`` runs the dry run's stage 3 (the 64-frame 320x240 orbit, seed 21,
BA every keyframe, loop closure on) with the dense solver and with 8-shard
``ba_solver="dist"``, records every windowed BA's inputs and outputs, and
teacher-forces the first window whose outputs part by more than 1e-5 (or
window ``--window``) on the dense run's inputs. It prints both solvers'
gap, how many landmarks the window constrains from one view, the first
LM step's reduced camera system's eigenvalues and Cholesky status, and for
1..n LM steps each solver's cost, accepted steps and largest landmark
coordinate beside the dense solver's on two other row orders of the same
observations (the 8-shard router's, and a seeded permutation).

``--reference`` (CPU only; imports ``zenslam_tpu``) adds the reference:
for ``strafe`` its f32 path's serial run and 2-chunk stitch, for ``orbit``
its dense solver on the window.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


WALL_Z = 6.0   # the corridor's end wall (io/synthetic.py make_corridor_world)


def _cx(R, t):
    """Camera centres (T, 3) of world->camera poses."""
    return np.einsum("kji,kj->ki", R, -t)


def _yaw(R):
    """Heading (rad) of world->camera rotations: the camera's z axis in the
    world's x-z plane."""
    return np.arctan2(R[:, 2, 0], R[:, 2, 2])


def _reference_strafe(seed: int, cfg) -> tuple:
    """The reference (JAX on the CPU, its default f32 path) on the same
    strafe: its serial run and its in-process 2-chunk stitch, as a
    ``strafe`` summary row."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from zenslam_tpu.io.synthetic import make_sequence
    from zenslam_tpu.parallel.offline import run_offline_chunks
    from zenslam_tpu.pipeline import SlamConfig
    from zenslam_tpu.pipeline.runner import run_sequence

    seq = make_sequence(np.random.default_rng(seed), n_frames=10, width=192, height=144,
                        motion="strafe", speed=0.5)
    jcfg = SlamConfig(**cfg._asdict())
    gt = _cx(seq.R_lw, seq.t_lw)[:, 0]
    gt_x, gt_yaw = gt - gt[0], _yaw(seq.R_lw)
    _, tel = run_sequence(jcfg, seq.rig, seq.left, seq.right)
    R, t = np.asarray(tel.R_cw), np.asarray(tel.t_cw)
    x = _cx(R, t)[:, 0]
    ex, eyaw = x - x[0] - gt_x, _yaw(R) - gt_yaw
    print(f"[strafe] seed {seed} reference f32: serial x error {ex} yaw error (mrad) "
          f"{eyaw * 1e3} x error / yaw error (m) {ex[1:] / eyaw[1:]}")
    out = run_offline_chunks(jcfg, seq.rig, seq.left, seq.right, n_chunks=2, overlap=3)
    sx = _cx(out["R_cw"], out["t_cw"])[:, 0]
    syaw = _yaw(out["R_cw"]) - gt_yaw
    wall = (sx[-1] - sx[0] - gt_x[-1]) + WALL_Z * (syaw[-1] - syaw[0])
    return (seed, "reference f32", sx[-1] - sx[0], x[-1] - x[0], gt_x[-1],
            float(np.abs(ex).max()), wall, float(np.abs(ex + WALL_Z * eyaw).max()))


def strafe(dev, seeds, reference=False) -> None:
    import torch

    from zenslam_tpu_torch.io.synthetic import make_sequence
    from zenslam_tpu_torch.parallel.offline import split_chunks, stitch_chunks
    from zenslam_tpu_torch.pipeline import SlamConfig
    from zenslam_tpu_torch.pipeline.runner import run_sequence

    cfg = SlamConfig(max_keypoints=192, max_landmarks=1024, pnp_iters=64, rigid_iters=64)
    np.set_printoptions(precision=4, suppress=True, linewidth=160)
    summary = []
    for seed in seeds:
        seq = make_sequence(np.random.default_rng(seed), n_frames=10, width=192, height=144,
                            motion="strafe", speed=0.5, device=dev)
        gt = _cx(seq.R_lw, seq.t_lw)
        gt_x = gt[:, 0] - gt[0, 0]
        bounds = split_chunks(10, 2, 3)
        paths = (("kernel", cfg),) if torch.device(dev).type == "cuda" else ()
        for path, c in paths + (("f32", cfg._replace(use_pallas_lk=False)),):
            st, tel = run_sequence(c, seq.rig, seq.left, seq.right, device=dev)
            serial = _cx(tel.R_cw, tel.t_cw)
            print(f"[strafe] seed {seed} {path}: truth x {gt_x}")
            ex = serial[:, 0] - serial[0, 0] - gt_x
            eyaw = _yaw(tel.R_cw) - _yaw(seq.R_lw)
            print(f"[strafe] seed {seed} {path}: serial x {serial[:, 0] - serial[0, 0]} "
                  f"tracked {np.asarray(tel.n_tracked)} inliers {np.asarray(tel.n_pose_inliers)}")
            print(f"[strafe] seed {seed} {path}: serial x error {ex} yaw error (mrad) "
                  f"{eyaw * 1e3} x error / yaw error (m) {ex[1:] / eyaw[1:]}")
            results = []
            for k, (s, e) in enumerate(bounds):
                st, tel = run_sequence(c, seq.rig, seq.left[s:e], seq.right[s:e], device=dev)
                ch = _cx(tel.R_cw, tel.t_cw)
                print(f"[strafe] seed {seed} {path}: chunk {k} frames {s}-{e - 1} local x "
                      f"{ch[:, 0] - ch[0, 0]} (truth {gt_x[s:e] - gt_x[s]}) steps "
                      f"{np.diff(ch[:, 0])} tracked {np.asarray(tel.n_tracked)} inliers "
                      f"{np.asarray(tel.n_pose_inliers)}")
                lm = st.lmap
                results.append((np.asarray(tel.R_cw), np.asarray(tel.t_cw), lm.xyz.cpu().numpy(),
                                lm.valid.cpu().numpy(), lm.desc.cpu().numpy()))
            out = stitch_chunks(10, bounds, results, 3)
            sx = _cx(out["R_cw"], out["t_cw"])[:, 0]
            print(f"[strafe] seed {seed} {path}: stitched x {sx - sx[0]} dx {sx[-1] - sx[0]:.4f} "
                  f"serial dx {serial[-1, 0] - serial[0, 0]:.4f} truth {gt_x[-1]:.4f}")
            syaw = _yaw(out["R_cw"]) - _yaw(seq.R_lw)
            wall = (sx[-1] - sx[0] - gt_x[-1]) + WALL_Z * (syaw[-1] - syaw[0])
            summary.append((seed, path, sx[-1] - sx[0], serial[-1, 0] - serial[0, 0], gt_x[-1],
                            float(np.abs(ex).max()), wall,
                            float(np.abs(ex + WALL_Z * eyaw).max())))
        if reference:
            summary.append(_reference_strafe(seed, cfg))
    for seed, path, sdx, ser, gt, emax, wall, wmax in summary:
        held = np.sign(sdx) == np.sign(gt) and abs(sdx - gt) < 0.15
        print(f"[strafe] summary seed {seed} {path}: stitched dx {sdx:.4f} (error {sdx - gt:+.4f}) "
              f"serial dx {ser:.4f} (error {ser - gt:+.4f}), serial max |x error| {emax:.4f}; "
              f"x error + {WALL_Z:g} m x yaw error: stitched {wall:+.4f}, serial max {wmax:.4f}; "
              f"dry-run bar {'held' if held else 'MISSED'}")


def orbit(dev, window_at=None, reference=False) -> None:
    import torch

    from zenslam_tpu_torch.io.synthetic import make_sequence
    from zenslam_tpu_torch.pipeline import SlamConfig, eager, system
    from zenslam_tpu_torch.pipeline.system import BackendConfig, create_system, run_system

    seq = make_sequence(np.random.default_rng(21), n_frames=64, width=320, height=240,
                        motion="orbit", pixel_noise=0.01, orbit_radius=1.0, device=dev)
    cfg = SlamConfig(max_keypoints=256, max_landmarks=4096, kf_min_frames=2,
                     kf_min_translation=0.05)
    window = system._windowed_ba
    records = {}
    for name, solver, n in (("dense", "dense", 0), ("dist8", "dist", 8)):
        calls = records[name] = []

        def rec(*args, calls=calls, **kwargs):
            out = window(*args, **kwargs)
            calls.append((args, kwargs, out))
            return out

        bc = BackendConfig(ba_every_kf=True, enable_loop_closure=True, ba_solver=solver,
                           dist_devices=n, bow_branch=32, bow_top_k=5, bow_min_score=0.20,
                           bow_min_frame_gap=15, loop_min_inliers=12)
        s = create_system(cfg, bc, seq.rig, (240, 320), device=dev)
        system._windowed_ba = rec
        try:
            tel, _ = run_system(s, seq.left, seq.right)
        finally:
            system._windowed_ba = window
        print(f"[orbit] {name}: {len(calls)} windows, {s.n_loop_closures} loops, last "
              f"frame t {tel.t_cw[-1]}")
    first = None
    for i, (a, b) in enumerate(zip(records["dense"], records["dist8"])):
        d_in = max(float((x - y).abs().max()) for x, y in zip(a[0][:6], b[0][:6])
                   if torch.is_tensor(x) and x.dtype.is_floating_point)
        d_out = max(float((x - y).abs().max()) for x, y in zip(a[2][:5], b[2][:5]))
        print(f"[orbit] window {i}: inputs part by {d_in:.3e}, outputs by {d_out:.3e}; rmse "
              f"dense {a[2][5].cpu().numpy()} dist8 {b[2][5].cpu().numpy()}")
        if first is None and d_out > 1e-5:
            first = i
    if first is None:
        print("[orbit] no window parts by more than 1e-5")
        if window_at is None:
            return
    first = first if window_at is None else window_at
    args, kwargs, _ = records["dense"][first]
    dv = torch.device(dev)
    print(f"[orbit] first window over 1e-5: {first}; teacher-forced on the dense run's inputs")
    caught = {}

    def catch(name, fn):
        def f(p, *a, **k):
            caught[name] = (p, a)
            return fn(p, *a, **k)
        return f

    solvers = (system.bundle_adjust, system.dist_bundle_adjust)
    system.bundle_adjust = catch("dense", solvers[0])
    system.dist_bundle_adjust = catch("dist", solvers[1])
    outs = {}
    try:
        # eagerly: a captured window's replay calls no Python, so nothing is caught
        with eager():
            for name, kw in (("dense", dict(kwargs, solver="dense", mesh=None)),
                             ("dist1", dict(kwargs, solver="dist",
                                            mesh=system._live_ba_mesh(1, dv))),
                             ("dist8", dict(kwargs, solver="dist",
                                            mesh=system._live_ba_mesh(8, dv)))):
                outs[name] = window(*args, **kw)
                if name != "dense":
                    caught[name] = caught.pop("dist")
    finally:
        system.bundle_adjust, system.dist_bundle_adjust = solvers
    for name in ("dist1", "dist8"):
        gap = [float((x - y).abs().max()) for x, y in zip(outs[name][:5], outs["dense"][:5])]
        print(f"[orbit] window {first} teacher-forced {name} vs dense: max|d| R {gap[0]:.3e} "
              f"t {gap[1]:.3e} xyz {gap[2]:.3e} R_cur {gap[3]:.3e} t_cur {gap[4]:.3e}; rmse "
              f"{outs[name][5].cpu().numpy()} (dense {outs['dense'][5].cpu().numpy()})")
    # the same window through the dense solver on other row orders of the
    # same observations, and each LM step (the solvers rerun with 1..n
    # iterations on the caught problems)
    pd, _ = caught["dense"]
    ps8, (mesh8,) = caught["dist8"][0], caught["dist8"][1][:1]
    ops = ps8.obs_kf.shape[0] // mesh8.n_shards
    ms = ps8.xyz.shape[0] // mesh8.n_shards
    shard = torch.arange(ps8.obs_kf.shape[0], device=ps8.obs_kf.device) // ops
    perm = torch.from_numpy(np.random.default_rng(0).permutation(pd.obs_kf.shape[0])).to(
        pd.obs_kf.device)
    obs = ("obs_kf", "obs_lm", "obs_uv", "obs_cam", "obs_valid")
    variants = {
        "dense on dist8's row order": pd._replace(
            **dict({k: getattr(ps8, k) for k in obs},
                   obs_lm=(ps8.obs_lm + shard * ms).to(torch.int32))),
        "dense on permuted rows": pd._replace(**{k: getattr(pd, k)[perm] for k in obs}),
    }
    from zenslam_tpu_torch.backend.ba import (
        _apply_gauge, _build_blocks, _eliminate_landmarks, _reduced_system)
    U, g_p, V, g_l, A = _build_blocks(pd, pd.R, pd.t, pd.xyz, 1.0)
    ev = torch.linalg.eigvalsh(V[pd.lm_valid].double())
    weak = int((ev[:, 0] < 1e-6 * ev[:, 2].clamp(min=1e-30)).sum())
    lam = torch.tensor(1e-3, device=U.device)
    _, S_off, g_off = _eliminate_landmarks(V, g_l, A, pd.lm_valid, lam)
    free = (pd.kf_valid & ~pd.kf_fixed).repeat_interleave(6)
    S, _ = _apply_gauge(*_reduced_system(U, g_p, S_off, g_off, lam), free)
    s_ev = torch.linalg.eigvalsh(S[free][:, free].double()).cpu().numpy()
    info = int(torch.linalg.cholesky_ex(0.5 * (S + S.T) + 1e-8 * torch.eye(
        S.shape[0], device=S.device))[1])
    print(f"[orbit] window {first}: {int(pd.kf_valid.sum())} keyframes ({int(pd.kf_fixed.sum())} "
          f"fixed), {int(pd.lm_valid.sum())} valid landmarks, {int(pd.obs_valid.sum())} valid "
          f"observations; landmarks whose V has its least eigenvalue under 1e-6 of its largest "
          f"(one view or none): {weak}; the first LM step's reduced camera system (free "
          f"part) has eigenvalues {np.array2string(s_ev, precision=2)}, Cholesky info {info}")
    n_it = kwargs["iterations"]
    for it in range(1, n_it + 1):
        rd = solvers[0](pd, iterations=it)
        line = (f"[orbit] window {first}, {it} LM step(s): dense cost "
                f"{float(rd['cost_after']):.6f} accepted {int(rd['n_accepted'])} max|xyz| "
                f"{float(rd['xyz'].abs().max()):.3e}")
        runs = {name: solvers[0](q, iterations=it) for name, q in variants.items()}
        for name in ("dist1", "dist8"):
            ps, (mesh,) = caught[name][0], caught[name][1][:1]
            runs[name] = solvers[1](ps, mesh, iterations=it)
        if reference:
            runs["the reference's bundle_adjust"] = _reference_ba(pd, it)
        for name, r in runs.items():
            line += (f"; {name} cost {float(r['cost_after']):.6f} accepted "
                     f"{int(r['n_accepted'])} max|dt| {float((r['t'] - rd['t']).abs().max()):.3e} "
                     f"max|xyz| {float(r['xyz'].abs().max()):.3e}")
        print(line)


def _reference_ba(p, iterations: int) -> dict:
    """``zenslam_tpu.backend.ba.bundle_adjust`` (JAX on the CPU) on the port's
    problem ``p``; the result as CPU tensors."""
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    from zenslam_tpu.backend.ba import BAProblem, bundle_adjust

    jp = BAProblem(**{k: jax.numpy.asarray(v.cpu().numpy()) for k, v in p._asdict().items()})
    out = bundle_adjust(jp, iterations=iterations)
    return {k: torch.from_numpy(np.asarray(out[k])) for k in ("t", "xyz", "cost_after",
                                                               "n_accepted")}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("strafe", "orbit"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=[4])
    ap.add_argument("--reference", action="store_true",
                    help="also run the reference (JAX, CPU only): strafe, its serial run "
                         "and 2-chunk stitch; orbit, its dense solver on the window")
    ap.add_argument("--window", type=int, default=None,
                    help="orbit: teacher-force this window instead of the first that parts")
    args = ap.parse_args()
    import torch

    torch.set_num_threads(4)
    if args.what == "strafe":
        strafe(args.device, args.seeds, args.reference)
    else:
        orbit(args.device, args.window, args.reference)


if __name__ == "__main__":
    main()
