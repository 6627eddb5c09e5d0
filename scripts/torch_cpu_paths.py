#!/usr/bin/env python3
"""Accuracy of the port's two front-end paths, and of the two apps, on the CPU.

    python3 scripts/torch_cpu_paths.py orbit    # ~6 minutes
    python3 scripts/torch_cpu_paths.py recipe   # ~4 minutes

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
process; this script imports only zenslam_tpu_torch.
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
    ap.add_argument("what", choices=("orbit", "recipe"))
    import torch

    torch.set_num_threads(4)
    {"orbit": orbit, "recipe": recipe}[ap.parse_args().what]()


if __name__ == "__main__":
    main()
