#!/usr/bin/env python3
"""Accuracy of the port's two front-end paths, and of the two apps, on the CPU.

    python3 scripts/torch_cpu_paths.py orbit       # ~6 minutes
    python3 scripts/torch_cpu_paths.py recipe      # ~4 minutes
    python3 scripts/torch_cpu_paths.py orbit-ref   # the reference's Pallas path
    python3 scripts/torch_cpu_paths.py orbit-ref --workload kidnap   # ~5 minutes
    python3 scripts/torch_cpu_paths.py arc-parity  # ~2 minutes

``orbit`` runs zenslam_tpu_torch on two rotation-heavy workloads, once on
the f32 path the CPU runs by default (f32 pyramid, the gather LK) and once
with ``use_pallas_lk=True`` (the kernel path's arithmetic: bf16 pyramid and
the plain versions of the LK and ORB kernels), and prints:

- the 64-frame 320x240 loop orbit of tests/test_loop_closure.py (seed 21),
  loops off and on: keyframe ATE of each and their ratio, the loop events;
- the 112-frame 448x336 kidnap orbit of tests/test_place_recognition.py
  (seed 33, frames 80-95 skipped), reloc off and on: the tail revisit
  error and every relocalisation attempt.

``recipe`` exports an 80-frame 752x480 EuRoC-layout folder rendered
through options/euroc_camchain.yaml (the chip_smoke.py app phase's
dataset, rendered on the host) and runs ``python -m zenslam_tpu_torch.app
--device cpu`` and ``python -m zenslam_tpu.app`` on it with
options/euroc_mh.yaml's slam and backend sections, ``--no-imu --no-scene``,
printing each app's summary lines. The reference app runs in its own
process.

``orbit-ref`` runs the reference's system (``zenslam_tpu``, JAX on the CPU)
on the loop orbit with ``SlamConfig(use_pallas_lk=True)``: its Pallas LK and
ORB kernels run in interpret mode (``interpret=True`` is bound into the
reference's ``lk_ragged_pallas`` and ``orb_descriptors_pallas`` inside this
script only). It prints the loop gain (keyframe ATE with loops over
without) beside the reference's f32 path's and the port's kernel
arithmetic's on the same frames, each run's camera-centre error against
the truth, and the first frame where the reference's Pallas run and the
port's part by more than 1 cm. ``--workload kidnap`` runs the same three on
frames 0-40 of the kidnap orbit (before the kidnap at 80) with the kidnap
test's back end and relocalisation off, and prints each run's per-frame
centre error, tracked count and pose inliers.

``arc-parity`` measures, against the reference, the float sensitivities the
VIO parity tests state tolerances for: on tests/test_torch_vio.py's 12-frame
320x240 arc (seed 11, the reference's draws) the teacher-forced pose gap
per frame, vision-only, with IMU, and with IMU from a state whose gravity
is known (as that test's two slam_step tests run); on frame 2 the PnP cam0
DLT hypotheses
of both packages on the same samples and where the Huber polish lands from
each package's RANSAC winner; the manifold preintegration's largest
relative difference on tests/test_torch_imu.py's batch; and how far each
package's float32 ugpm GP posterior mean lies from the float64 one.

``orbit-ref`` and ``arc-parity`` import the reference; the other modes do
not.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def kf_ate(s, seq) -> float:
    fi, v = s.kf_db.frame_idx.numpy(), s.kf_db.valid.numpy()
    R, t = s.kf_db.R.numpy()[v], s.kf_db.t.numpy()[v]
    est = np.einsum("kij,kj->ki", np.transpose(R, (0, 2, 1)), -t)
    gt = np.stack([-seq.R_lw[f].T @ seq.t_lw[f] for f in fi[v]])
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, -1))))


def orbit() -> None:
    from zenslam_tpu_torch.io.synthetic import make_sequence
    from zenslam_tpu_torch.pipeline.state import SlamConfig
    from zenslam_tpu_torch.pipeline.system import (
        BackendConfig, create_system, process_frame, run_system)

    cfg = SlamConfig(max_keypoints=256, max_landmarks=4096, kf_min_frames=2,
                     kf_min_translation=0.05)
    loop = make_sequence(np.random.default_rng(21), n_frames=64, width=320, height=240,
                         motion="orbit", pixel_noise=0.01, orbit_radius=1.0, device="cpu",
                         device_render=True)
    kid = make_sequence(np.random.default_rng(33), n_frames=112, width=448, height=336,
                        motion="orbit", pixel_noise=0.01, orbit_radius=1.0,
                        orbit_revolutions=1.75, device="cpu", device_render=True)
    for path, pcfg in (("f32", cfg), ("kernel arithmetic", cfg._replace(use_pallas_lk=True))):
        ates = {}
        for name, bc in (("off", BackendConfig(ba_every_kf=False, enable_loop_closure=False)),
                         ("on", BackendConfig(ba_every_kf=False, enable_loop_closure=True,
                                              bow_branch=32, bow_top_k=5, bow_min_score=0.20,
                                              bow_min_frame_gap=15, loop_min_inliers=12))):
            s = create_system(pcfg, bc, loop.rig, (240, 320), device="cpu")
            run_system(s, loop.left, loop.right)
            ates[name] = kf_ate(s, loop)
            print(f"[orbit] {path} path, loops {name}: keyframe ATE {ates[name]:.5f} m, "
                  f"loops {[d for d in s.loop_debug if d['fired']]}", flush=True)
        print(f"[orbit] {path} path: ratio on/off {ates['on'] / ates['off']:.4f}", flush=True)
        order = list(range(0, 80)) + list(range(96, 112))
        for reloc in (False, True):
            bc = BackendConfig(ba_every_kf=False, enable_loop_closure=True,
                               enable_relocalization=reloc, reloc_lost_frames=1,
                               reloc_min_inliers=12, reloc_cooldown=10, bow_levels=2,
                               bow_branch=32, bow_min_score=0.20, bow_min_frame_gap=100000,
                               bow_top_k=3, loop_min_inliers=12, vocab_retrain_kfs=8)
            s = create_system(pcfg, bc, kid.rig, (336, 448), device="cpu")
            centers = {}
            for fi in order:
                tel, _ = process_frame(s, kid.left[fi], kid.right[fi])
                centers[fi] = -tel.R_cw.T @ tel.t_cw
            err = float(np.mean([np.linalg.norm(centers[f] - centers[f - 64])
                                 for f in range(109, 112)]))
            print(f"[kidnap] {path} path, reloc {'on' if reloc else 'off'}: relocs "
                  f"{s.n_relocs}, tail revisit error {err:.4f} m, attempts (frame = frames "
                  f"processed, the kidnap at 80) {s.reloc_debug}", flush=True)


def orbit_ref(workload: str = "loop") -> None:
    import functools
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    import zenslam_tpu.ops.orb_pallas as jorb
    import zenslam_tpu.pipeline.step as jstep
    from zenslam_tpu.io.synthetic import make_sequence as jmake_sequence
    from zenslam_tpu.pipeline import system as jsystem
    from zenslam_tpu.pipeline.state import SlamConfig as JaxConfig
    from zenslam_tpu_torch import convert
    from zenslam_tpu_torch.pipeline.state import SlamConfig
    from zenslam_tpu_torch.pipeline.system import BackendConfig, create_system, run_system

    jstep.lk_ragged_pallas = functools.partial(jstep.lk_ragged_pallas, interpret=True)
    jorb.orb_descriptors_pallas = functools.partial(jorb.orb_descriptors_pallas,
                                                    interpret=True)
    kw = dict(max_keypoints=256, max_landmarks=4096, kf_min_frames=2, kf_min_translation=0.05)
    if workload == "loop":
        seq = jmake_sequence(np.random.default_rng(21), n_frames=64, width=320, height=240,
                             motion="orbit", pixel_noise=0.01, orbit_radius=1.0)
        backends = {"off": dict(ba_every_kf=False, enable_loop_closure=False),
                    "on": dict(ba_every_kf=False, enable_loop_closure=True, bow_branch=32,
                               bow_top_k=5, bow_min_score=0.20, bow_min_frame_gap=15,
                               loop_min_inliers=12)}
        n = 64
    else:
        # the kidnap orbit's frames 0-40, before the kidnap at 80, with the
        # kidnap test's back end and relocalisation off
        seq = jmake_sequence(np.random.default_rng(33), n_frames=112, width=448, height=336,
                             motion="orbit", pixel_noise=0.01, orbit_radius=1.0,
                             orbit_revolutions=1.75)
        backends = {"off": dict(ba_every_kf=False, enable_loop_closure=True,
                                enable_relocalization=False, bow_levels=2, bow_branch=32,
                                bow_min_score=0.20, bow_min_frame_gap=100000, bow_top_k=3,
                                loop_min_inliers=12, vocab_retrain_kfs=8)}
        n = 41
    left, right = seq.left[:n], seq.right[:n]
    R_lw, t_lw = seq.R_lw[:n], seq.t_lw[:n]
    prig = convert.rig_from_numpy(jax.tree.map(np.asarray, seq.rig), "cpu")
    # the true camera centres in the first camera's frame (the SLAM world)
    c_gt = np.einsum("kij,kj->ki", np.transpose(R_lw, (0, 2, 1)), -t_lw)
    c_true = (c_gt - c_gt[0]) @ R_lw[0].T
    runs = (("reference Pallas (interpret)", "ref", True), ("reference f32", "ref", False),
            ("port kernel arithmetic", "port", True))
    centres, tracked = {}, {}
    tag = f"[orbit-ref {workload}]"
    for label, pkg, kernel in runs:
        ates = {}
        for name, bc in backends.items():
            t0 = time.time()
            if pkg == "ref":
                s = jsystem.create_system(JaxConfig(use_pallas_lk=kernel, **kw),
                                          jsystem.BackendConfig(**bc), seq.rig, left[0].shape)
                tel, _ = jsystem.run_system(s, left, right)
                kf = s.kf_db
                fi, v = np.asarray(kf.frame_idx), np.asarray(kf.valid)
                R, t = np.asarray(kf.R)[v], np.asarray(kf.t)[v]
            else:
                s = create_system(SlamConfig(use_pallas_lk=kernel, **kw), BackendConfig(**bc),
                                  prig, left[0].shape, device="cpu")
                tel, _ = run_system(s, left.astype(np.float32), right.astype(np.float32))
                fi, v = s.kf_db.frame_idx.numpy(), s.kf_db.valid.numpy()
                R, t = s.kf_db.R.numpy()[v], s.kf_db.t.numpy()[v]
            est = np.einsum("kij,kj->ki", np.transpose(R, (0, 2, 1)), -t)
            gt = np.stack([-R_lw[f].T @ t_lw[f] for f in fi[v]])
            ates[name] = float(np.sqrt(np.mean(np.sum((est - gt) ** 2, -1))))
            print(f"{tag} {label}, loops {name}: {len(left)} frames in "
                  f"{time.time() - t0:.0f} s, keyframe ATE {ates[name]:.5f} m, "
                  f"loops {[d for d in s.loop_debug if d['fired']]}", flush=True)
            if name == "off":
                Rc, tc = np.asarray(tel.R_cw), np.asarray(tel.t_cw)
                centres[label] = np.einsum("kij,kj->ki", np.transpose(Rc, (0, 2, 1)), -tc)
                tracked[label] = np.asarray(tel.n_tracked)
                err = np.linalg.norm(centres[label] - c_true, axis=-1)
                lost = np.flatnonzero(err > 0.05)
                frames = [i for i in (1, 8, 16, 24, 32, 40, 63) if i < n]
                print(f"{tag} {label}, loops off: centre error vs truth (m) at frames "
                      f"{frames}: {[round(float(err[i]), 4) for i in frames]}; first frame "
                      f"over 5 cm: {int(lost[0]) if lost.size else None}; pose_ok false at "
                      f"{np.flatnonzero(~np.asarray(tel.pose_ok, bool)).tolist()}", flush=True)
                if workload == "kidnap":
                    print(f"{tag} {label}: per frame centre error (m) "
                          f"{np.round(err, 4).tolist()}; n_tracked {tracked[label].tolist()}; "
                          f"n_pose_inliers {np.asarray(tel.n_pose_inliers).tolist()}",
                          flush=True)
        if "on" in ates:
            print(f"{tag} {label}: loop gain (ATE on / off) {ates['on'] / ates['off']:.4f}",
                  flush=True)
    a, b = centres[runs[0][0]], centres[runs[2][0]]
    gap = np.linalg.norm(a - b, axis=-1)
    first = np.flatnonzero(gap > 0.01)
    frames = [i for i in (1, 8, 16, 24, 32, 40, 63) if i < n]
    print(f"{tag} reference Pallas vs port kernel arithmetic, loops off: first frame "
          f"apart by > 1 cm: {int(first[0]) if first.size else None}; gap (m) at frames "
          f"{frames}: {[round(float(gap[i]), 4) for i in frames]}", flush=True)


def _smooth_signal(T=240, dt=0.005, pad=16):
    """tests/test_torch_imu.py's noisy smooth IMU signal, shuffled and padded."""
    ts = np.arange(T, dtype=np.float32) * dt
    gyro = np.stack([0.4 * np.sin(2 * np.pi * 0.8 * ts), 0.2 * np.cos(2 * np.pi * 0.5 * ts),
                     0.3 * np.sin(2 * np.pi * 0.3 * ts + 0.7)], -1)
    accel = np.stack([np.sin(2 * np.pi * 0.6 * ts), 0.5 * np.cos(2 * np.pi * 0.9 * ts),
                      9.8 + 0.3 * np.sin(2 * np.pi * 0.4 * ts)], -1)
    rng = np.random.default_rng(7)
    gyro = gyro + rng.normal(0, 0.05, gyro.shape)
    accel = accel + rng.normal(0, 0.3, accel.shape)
    perm = rng.permutation(T)
    cat = np.concatenate
    return (cat([ts[perm], np.full(pad, 777.0)]).astype(np.float32),
            cat([gyro[perm], np.full((pad, 3), 999.0)]).astype(np.float32),
            cat([accel[perm], np.full((pad, 3), 999.0)]).astype(np.float32),
            cat([np.ones(T, bool), np.zeros(pad, bool)]))


def arc_parity() -> None:
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    from zenslam_tpu.estimation import pnp as JP
    from zenslam_tpu.imu import continuous as JC
    from zenslam_tpu.imu.preintegration import preintegrate as jpre
    from zenslam_tpu.io.synthetic import make_sequence
    from zenslam_tpu.pipeline import SlamConfig as JaxConfig
    from zenslam_tpu.pipeline import init_state
    from zenslam_tpu.pipeline.step import slam_step as jax_step
    from zenslam_tpu_torch import convert
    from zenslam_tpu_torch.estimation import pnp as PP
    from zenslam_tpu_torch.estimation.cascade import CascadeNoise
    from zenslam_tpu_torch.estimation.ransac import gather_rows, ransac_sample_indices
    from zenslam_tpu_torch.imu import continuous as PC
    from zenslam_tpu_torch.imu.preintegration import preintegrate
    from zenslam_tpu_torch.pipeline import step as pstep

    T, H, W, I = 12, 240, 320, 64
    seq = make_sequence(np.random.default_rng(11), n_frames=T, width=W, height=H, motion="arc",
                        with_imu=True)
    cfg = JaxConfig(use_pallas_lk=False, max_keypoints=128, max_landmarks=1024, pnp_iters=I,
                    rigid_iters=I, essential_iters=I)
    pcfg = convert.config_from_dict(cfg._asdict())
    prig = convert.rig_from_numpy(jax.tree.map(np.asarray, seq.rig), "cpu")

    def draws(key):
        """The reference's cascade draws: slam_step splits the state key,
        the cascade splits k_est into three and folds in 3."""
        _, k_est = jax.random.split(key)
        k0, k1, k2 = jax.random.split(k_est, 3)

        def g(k):
            return torch.from_numpy(np.array(jax.random.gumbel(k, (I, cfg.max_keypoints))))

        return CascadeNoise(g(k0), g(k1), g(k2), g(jax.random.fold_in(k_est, 3)))

    captured = []
    cascade = pstep.estimate_pose_cascade

    def capture(*args, **kwargs):
        captured.append(args)
        return cascade(*args, **kwargs)

    pstep.estimate_pose_cascade = capture
    for label, with_imu, known in (("vision only", False, False), ("with IMU", True, False),
                                   ("with IMU, gravity known", True, True)):
        state, gaps = init_state(cfg, (H, W)), []
        if known:
            state = state._replace(vio=state.vio._replace(
                gravity_w=jnp.asarray(seq.gravity_w), gravity_ok=jnp.asarray(True)))
        for t in range(T):
            imu = (seq.gyro[t], seq.accel[t], seq.imu_dts[t], seq.imu_mask[t]) if with_imu \
                else None
            before = jax.tree.map(np.asarray, state)
            _, ptel = pstep.slam_step(
                pcfg, prig, convert.state_from_numpy(before, "cpu", image_shape=(H, W)),
                torch.from_numpy(seq.left[t].astype(np.float32)),
                torch.from_numpy(seq.right[t].astype(np.float32)),
                noise=draws(jnp.asarray(before.rng_key)),
                imu=None if imu is None else tuple(torch.from_numpy(x) for x in imu))
            state, tel = jax_step(cfg, seq.rig, state, jnp.asarray(seq.left[t]),
                                  jnp.asarray(seq.right[t]), imu=imu)
            gaps.append(max(float(np.abs(ptel.R_cw.numpy() - np.asarray(tel.R_cw)).max()),
                            float(np.abs(ptel.t_cw.numpy() - np.asarray(tel.t_cw)).max())))
        print(f"[arc-parity] {label}: teacher-forced pose gap per frame (max |dR|, |dt|) "
              f"{np.array2string(np.asarray(gaps), precision=7)}; frames over 1e-4: "
              f"{[t for t, g in enumerate(gaps) if g > 1e-4]}", flush=True)
    pstep.estimate_pose_cascade = cascade

    # frame 2 of the vision-only run: PnP cam0 on the port's own inputs
    noise, rig, X, uv, valid = captured[2][:5]
    R_pred, t_pred = captured[2][11], captured[2][12]
    K = rig.left.K
    idx = ransac_sample_indices(noise.pnp0[None], valid[None], 6)[0]
    xn = PP.normalize_pixels(K, uv)
    Rp, tp = PP.pnp_dlt(gather_rows(X[None], idx[None])[0], gather_rows(xn[None], idx[None])[0])
    Xj, xj = jnp.asarray(X.numpy()), jnp.asarray(xn.numpy())
    Rj, tj = jax.vmap(lambda i: JP.pnp_dlt(Xj[i], xj[i]))(jnp.asarray(idx.numpy()))
    Rj, tj = torch.from_numpy(np.array(Rj)), torch.from_numpy(np.array(tj))
    err = PP.reprojection_errors(K, Rp, tp, X[None], uv[None])
    best = int(torch.argmax(((err < 3.0) & valid).sum(-1)))
    landing = {}
    for who, (R0, t0) in (("port", (Rp[best], tp[best])), ("reference", (Rj[best], tj[best]))):
        inl = (PP.reprojection_errors(K, R0, t0, X, uv) < 3.0) & valid
        for iters in (8, 100):
            _, t_out = PP.refine_pnp_gn(K, R0, t0, X, uv, inl, iters=iters)
            landing[who, iters] = t_out
    print(f"[arc-parity] frame 2, PnP cam0 on the same {I} samples: the two packages' DLT "
          f"hypotheses differ by up to {float((tp - tj).abs().max()):.4f} m in t; from each "
          f"package's winner (hypothesis {best}) the Huber polish lands "
          f"{float((landing['port', 8] - landing['reference', 8]).abs().max()):.5f} m apart "
          f"(8 iterations; each within "
          f"{max(float((landing[w, 8] - landing[w, 100]).abs().max()) for w in ('port', 'reference')):.1e}"
          f" m of its 100-iteration answer)", flush=True)

    rng = np.random.default_rng(0)
    g = rng.normal(0, 1.0, (64, 3)).astype(np.float32)
    a = (rng.normal(0, 2.0, (64, 3)) + [0, 9.81, 0]).astype(np.float32)
    d = (0.005 * rng.uniform(0.8, 1.2, 64)).astype(np.float32)
    m = np.arange(64) < 10
    g[10:], a[10:] = 999.0, -999.0
    bg, ba = rng.normal(0, 0.02, 3).astype(np.float32), rng.normal(0, 0.1, 3).astype(np.float32)
    j = jpre(*(jnp.asarray(x) for x in (g, a, d, m)), bias_gyro=jnp.asarray(bg),
             bias_accel=jnp.asarray(ba))
    p = preintegrate(*(torch.from_numpy(x) for x in (g, a, d, m)), bias_gyro=torch.from_numpy(bg),
                     bias_accel=torch.from_numpy(ba))
    rel = max(float(np.abs(getattr(p, f).numpy() - np.asarray(getattr(j, f))).max()
                    / max(float(np.abs(np.asarray(getattr(j, f))).max()), 1e-30))
              for f in p._fields)
    print(f"[arc-parity] preintegrate (64 rows, 10 valid): largest difference from the "
          f"reference's scan, relative to each field's largest entry, {rel:.2e}", flush=True)

    ts, gyro, accel, mask = _smooth_signal()
    n, span = mask.sum(), ts[mask].max() - ts[mask].min()
    grid = (0.4 + (np.arange(64) + 0.5) * 0.4 / 64).astype(np.float32)
    for name, x, density in (("gyro", gyro, 1.6e-4), ("accel", accel, 2.8e-3)):
        hyper = np.float32([3 * span / n, max(np.where(mask[:, None], x, 0).std(), 1e-3),
                            density * np.sqrt(n / span)])
        ref = np.asarray(JC.gp_posterior_mean(*(jnp.asarray(v) for v in (ts, x, mask, grid,
                                                                           *hyper))))
        port = PC.gp_posterior_mean(*(torch.from_numpy(np.asarray(v)) for v in (
            ts, x, mask, grid, *hyper))).numpy()
        f64 = [torch.as_tensor(np.asarray(v, np.float64)) for v in (ts, x, grid, *hyper)]
        exact = PC.gp_posterior_mean(f64[0], f64[1], torch.from_numpy(mask), *f64[2:]).numpy()
        print(f"[arc-parity] ugpm GP posterior mean, {name} (float32 vs float64): reference "
              f"{np.abs(ref - exact).max():.2e}, port {np.abs(port - exact).max():.2e}, the "
              f"two apart {np.abs(ref - port).max():.2e} (largest entry "
              f"{np.abs(exact).max():.2e})", flush=True)


def recipe() -> None:
    import yaml

    from zenslam_tpu_torch.io.calibration import load_kalibr_yaml
    from zenslam_tpu_torch.io.synthetic import export_dataset, make_distorted_sequence

    camchain = ROOT / "options" / "euroc_camchain.yaml"
    rig, models = load_kalibr_yaml(str(camchain), device="cpu")
    seq = make_distorted_sequence(np.random.default_rng(9), rig, models, n_frames=80,
                                  motion="strafe", pixel_noise=0.005)
    recipe = yaml.safe_load((ROOT / "options" / "euroc_mh.yaml").read_text())
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "mav0"
        export_dataset(seq, str(root))
        for pkg, extra in (("zenslam_tpu_torch", ["--device", "cpu"]), ("zenslam_tpu", [])):
            opts = Path(tmp) / f"{pkg}.yaml"
            opts.write_text(yaml.safe_dump({
                "folder": {"root": str(root), "output": str(Path(tmp) / f"out_{pkg}"),
                           "calibration_file": str(camchain),
                           "groundtruth_file": str(root / "groundtruth.csv")},
                "slam": recipe["slam"], "backend": recipe["backend"]}))
            env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
            out = subprocess.run([sys.executable, "-m", f"{pkg}.app", "--options-file",
                                  str(opts), "--no-imu", "--no-scene", *extra], cwd=ROOT,
                                 env=env, capture_output=True, text=True, check=True).stdout
            for line in out.splitlines():
                if line.startswith(("processed", "final pose", "keyframes", "ATE")):
                    print(f"[recipe] {pkg}: {line}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("orbit", "recipe", "orbit-ref", "arc-parity"))
    ap.add_argument("--workload", choices=("loop", "kidnap"), default="loop",
                    help="orbit-ref: the 64-frame loop orbit or frames 0-40 of the kidnap "
                         "orbit")
    args = ap.parse_args()
    import torch

    torch.set_num_threads(4)
    if args.what == "orbit-ref":
        orbit_ref(args.workload)
        return
    {"orbit": orbit, "recipe": recipe, "arc-parity": arc_parity}[args.what]()


if __name__ == "__main__":
    main()
