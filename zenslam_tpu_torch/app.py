"""zenslam_tpu_torch application entry — counterpart of ``zenslam_tpu/app.py``.

    python -m zenslam_tpu_torch.app --options-file options.yaml --no-imu
    python -m zenslam_tpu_torch.app --options-file options.yaml --no-imu --device cpu
    python -m zenslam_tpu_torch.app --version / --help

Runs the full keyframe SLAM system over the dataset the options name:
native prefetch reader -> uint8 upload (pinned memory on CUDA) and rescale
on the device -> rectification (``remap``) when a Kalibr camchain is given
-> ``process_frame`` (the per-frame step and the keyframe back end, with
lagged telemetry) -> telemetry CSV, ``trajectory.csv``, the final pose,
ATE/RPE against groundtruth, the scene export, and the effective options
written back. Runs on CUDA unless ``--device cpu`` is given; with no CUDA
device and no ``--device`` it raises.

Not ported yet, each raising NotImplementedError naming its ROADMAP.md item:
an IMU stream without ``--no-imu`` (item 11), ``--viz`` (item 18) and
``backend.ba_solver: dist`` (item 17).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser("zenslam_tpu_torch")
    ap.add_argument("--options-file", default=None)
    ap.add_argument("--no-backend", action="store_true")
    ap.add_argument("--no-imu", action="store_true", help="ignore the IMU stream (vision-only)")
    ap.add_argument("--take", type=int, default=0, help="override take_frames")
    ap.add_argument("--no-scene", action="store_true",
                    help="skip the 3D scene export (PLY/HTML/PNG)")
    ap.add_argument("--viz", action="store_true",
                    help="per-keyframe match overlays and timing plots (not ported yet)")
    ap.add_argument("--save-vocab", default="",
                    help="write the run's trained BoW vocabulary to this .npz "
                         "(reload via backend.vocab_file)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda, raising when absent)")
    ap.add_argument("--version", action="store_true")
    args = ap.parse_args(argv)

    import zenslam_tpu_torch

    if args.version:
        print(f"zenslam_tpu_torch {zenslam_tpu_torch.__version__}")
        return 0
    if args.viz:
        raise NotImplementedError(
            "--viz (keyframe match overlays, diagnostics report, timing plots) is not ported "
            "to zenslam_tpu_torch yet, see ROADMAP.md Queue 1 item 18")

    import torch

    from zenslam_tpu_torch.config import AllOptions, load_options, save_options
    from zenslam_tpu_torch.eval.metrics import ate_rmse, rpe_rmse
    from zenslam_tpu_torch.io.calibration import (
        compute_rectify_maps, load_kalibr_yaml, parse_imu_config)
    from zenslam_tpu_torch.io.dataset import FolderReader, Groundtruth
    from zenslam_tpu_torch.io.synthetic import default_rig
    from zenslam_tpu_torch.io.telemetry import TelemetryWriter
    from zenslam_tpu_torch.ops.image import remap
    from zenslam_tpu_torch.pipeline.state import check_supported, resolve_device
    from zenslam_tpu_torch.pipeline.system import (
        check_backend_supported, create_system, flush_pipeline, process_frame)

    dev = resolve_device(args.device)
    opts = load_options(args.options_file) if args.options_file else AllOptions()
    if args.take:
        opts.folder.take_frames = args.take
    if args.no_backend:
        opts.backend.ba_every_kf = False
        opts.backend.enable_loop_closure = False
    check_supported(opts.slam)
    check_backend_supported(opts.slam, opts.backend)

    reader = FolderReader(
        root=opts.folder.root, left_dir=opts.folder.left, right_dir=opts.folder.right,
        imu_file=opts.folder.imu_file, timescale=opts.folder.timescale,
        skip_frames=opts.folder.skip_frames, take_frames=opts.folder.take_frames)
    if reader.has_imu() and not args.no_imu:
        raise NotImplementedError(
            f"the dataset carries an IMU stream ({opts.folder.imu_file}) and the VIO branch "
            "is not ported to zenslam_tpu_torch yet (ROADMAP.md Queue 1 item 11); pass "
            "--no-imu to run vision-only")

    os.makedirs(opts.folder.output, exist_ok=True)
    maps = None
    if opts.folder.calibration_file:
        rig_raw, models = load_kalibr_yaml(opts.folder.calibration_file, device=dev)
        maps = compute_rectify_maps(rig_raw, models)
        rig = maps.rig_rectified
        print(f"calibration: {opts.folder.calibration_file} (rectifying, "
              f"baseline {float(rig.baseline):.4f} m)")
    else:
        rig = None  # resolved once the first frame's shape is known

    if opts.folder.imu_calibration_file:
        import yaml

        with open(opts.folder.imu_calibration_file) as f:
            noise = parse_imu_config(yaml.safe_load(f) or {})
        opts.slam = opts.slam._replace(
            imu_gyro_noise=noise.gyro_noise, imu_accel_noise=noise.accel_noise,
            imu_gyro_bias_walk=noise.gyro_bias_walk, imu_accel_bias_walk=noise.accel_bias_walk)
        print(f"imu calibration: {opts.folder.imu_calibration_file} "
              f"(gyro {noise.gyro_noise:.2e} rad/s/√Hz, "
              f"accel {noise.accel_noise:.2e} m/s²/√Hz)")

    gt = Groundtruth(opts.folder.groundtruth_file) if opts.folder.groundtruth_file else None
    telemetry = TelemetryWriter(os.path.join(opts.folder.output, "frame_data.csv"))
    traj_f = open(os.path.join(opts.folder.output, "trajectory.csv"), "w")
    traj_f.write("# timestamp, px, py, pz (camera center, world frame)\n")

    system = None
    est_pos, gt_pos, times = [], [], []
    meta = []   # per-frame (timestamp, wait_ms): lagged telemetry is realigned by index
    n = 0
    t_start = time.time()
    mx_l = my_l = mx_r = my_r = None

    def emit(tel, info, dt_ms):
        ts, wait_ms = meta[info["frame"]]
        telemetry.write(tel, timestamp=ts, duration_ms=dt_ms, wait_ms=wait_ms,
                        step_ms=info["step_ms"], backend_ms=info["backend_ms"])
        R = np.asarray(tel.R_cw)
        t = np.asarray(tel.t_cw)
        c = -R.T @ t
        est_pos.append(c)
        traj_f.write(f"{ts:.9f}, {c[0]:.6f}, {c[1]:.6f}, {c[2]:.6f}\n")
        if gt is not None:
            gt_pos.append(gt.pose_at(ts)[1])
        return R, t

    R = t = None
    try:
        for frame in _timed(reader.frames_prefetch()):
            frame, wait_ms = frame
            il = upload(frame.left, dev)
            ir = upload(frame.right, dev)
            if maps is not None:
                if mx_l is None:
                    mx_l, my_l, mx_r, my_r = (torch.from_numpy(m).to(dev) for m in (
                        maps.left_x, maps.left_y, maps.right_x, maps.right_y))
                il = remap(il, mx_l, my_l)
                ir = remap(ir, mx_r, my_r)
            if system is None:
                if rig is None:
                    H, W = frame.left.shape
                    rig = default_rig(width=W, height=H, device=dev)
                    print(f"no calibration file — default rig for {W}x{H}")
                system = create_system(opts.slam, opts.backend, rig, tuple(il.shape),
                                       device=dev)
            meta.append((frame.timestamp, wait_ms))
            t0 = time.time()
            tel, info = process_frame(system, il, ir)
            dt_ms = (time.time() - t0) * 1000 + wait_ms
            times.append(dt_ms)
            n += 1
            if tel is None:
                continue
            R, t = emit(tel, info, dt_ms)
            if n % 50 == 0:
                print(f"frame {n}: {np.mean(times[-50:]):.1f} ms/frame, "
                      f"map {int(tel.map_size)}, inliers {int(tel.n_pose_inliers)}")
        if system is not None:
            for tel, info in flush_pipeline(system):
                R, t = emit(tel, info, 0.0)
    finally:
        telemetry.close()
        traj_f.close()
    wall = time.time() - t_start
    print(f"\nprocessed {n} frames in {wall:.1f}s "
          f"({n / max(wall, 1e-9):.1f} fps, steady {np.median(times):.1f} ms/frame)")
    if n:
        from zenslam_tpu_torch.utils import format_pose

        print(f"final pose (camera in world): {format_pose(R.T, -R.T @ t)}")
    if system is not None:
        print(f"keyframes: {int(system.kf_db.valid.sum())}, "
              f"BA runs: {system.n_ba_runs}, loop closures: {system.n_loop_closures}")
    if gt is not None and len(gt_pos) > 2:
        ate = ate_rmse(np.asarray(est_pos), np.asarray(gt_pos))
        rpe = rpe_rmse(np.asarray(est_pos), np.asarray(gt_pos))
        print(f"ATE RMSE: {ate * 1000:.1f} mm   RPE RMSE: {rpe * 1000:.1f} mm")
    if system is not None and not args.no_scene:
        from zenslam_tpu_torch.analysis.scene_export import export_scene

        scene = export_scene(opts.folder.output, system, est_positions=est_pos,
                             gt_positions=gt_pos)
        print(f"scene export: {len(scene['points'])} landmarks -> "
              f"{opts.folder.output}/scene.{{ply,html}} + scene_3d.png")
    if args.save_vocab and system is not None and system.vocab is not None:
        from zenslam_tpu_torch.backend.bow import save_vocabulary

        save_vocabulary(args.save_vocab, system.vocab)
        print(f"vocabulary saved: {args.save_vocab}")
    if args.options_file:
        save_options(opts, os.path.join(opts.folder.output, "effective_options.yaml"))
    return 0


def upload(img: np.ndarray, device):
    """A host frame in [0, 1] as the step's input on ``device``: quantised
    to 8 bits on the host, copied as uint8 (from pinned memory on CUDA),
    rescaled on the device by the f32 constant 1/255, as the reference
    does (CLAHE's bins follow these operations)."""
    import torch

    u8 = torch.from_numpy(np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8))
    pin = torch.device(device).type == "cuda"
    if pin:
        u8 = u8.pin_memory()
    return u8.to(device, non_blocking=pin).to(torch.float32) * (1.0 / 255.0)


def _timed(frames):
    """Yield (frame, ms the consumer waited for it)."""
    while True:
        t0 = time.time()
        frame = next(frames, None)
        if frame is None:
            return
        yield frame, (time.time() - t0) * 1000


if __name__ == "__main__":
    raise SystemExit(main())
