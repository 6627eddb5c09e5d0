"""zenslam_tpu_torch application entry — counterpart of ``zenslam_tpu/app.py``.

    python -m zenslam_tpu_torch.app --options-file options.yaml
    python -m zenslam_tpu_torch.app --options-file options.yaml --device cpu
    python -m zenslam_tpu_torch.app --options-file options.yaml --no-imu
    python -m zenslam_tpu_torch.app --options-file options/euroc_mh_lines.yaml
    python -m zenslam_tpu_torch.app --version / --help

Runs the full keyframe SLAM system over the dataset the options name:
native prefetch reader -> uint8 upload (pinned memory on CUDA) and rescale
on the device -> rectification (``remap``) when a Kalibr camchain is given
-> ``process_frame`` (the per-frame step and the keyframe back end, with
lagged telemetry) -> telemetry CSV, ``trajectory.csv``, the final pose,
ATE/RPE against groundtruth, the scene export, and the effective options
written back. When the folder carries an IMU stream (``folder.imu_file``)
and ``--no-imu`` is absent, each frame's padded IMU slice goes up with it
(one pinned buffer) and the VIO branch runs; ``slam.use_keylines`` (the
keylines recipe) runs the keyline branch; ``slam.detector`` (``fast``,
``harris``, ``dog``), ``slam.descriptor`` (``orb``, ``sift``, ``freak``) and
``slam.describe_refresh`` pick the front end's families. Runs on CUDA unless ``--device
cpu`` is given; with no CUDA device and no ``--device`` it raises.

``backend.ba_solver: dist`` runs the windowed BA sharded (``parallel/``;
``backend.dist_devices`` shards, all on this process).

``--viz`` keeps each frame's rectified device images until its (lagged)
telemetry arrives; at a keyframe it writes the spatial and temporal overlay
PNGs under ``<output>/viz`` from the system's keyframe snapshot (one packed
device->host copy), then ``diagnostics.html`` with the timing plots (skipped
without matplotlib, as the scene's PNG is). Without ``--viz`` nothing is
kept and nothing more is read.
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
                    help="write per-keyframe 2D match-overlay PNGs (stereo + temporal) and a "
                         "diagnostics.html report into the output folder")
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

    import torch

    from zenslam_tpu_torch.config import AllOptions, load_options, save_options
    from zenslam_tpu_torch.eval.metrics import ate_rmse, rpe_rmse
    from zenslam_tpu_torch.io.calibration import (
        compute_rectify_maps, load_kalibr_yaml, parse_imu_config)
    from zenslam_tpu_torch.io.dataset import FolderReader, Groundtruth
    from zenslam_tpu_torch.io.synthetic import default_rig
    from zenslam_tpu_torch.io.telemetry import TelemetryWriter
    from zenslam_tpu_torch.ops.image import remap
    from zenslam_tpu_torch.pipeline.state import resolve_device
    from zenslam_tpu_torch.pipeline.system import (
        check_backend_supported, create_system, flush_pipeline, process_frame)

    dev = resolve_device(args.device)
    opts = load_options(args.options_file) if args.options_file else AllOptions()
    if args.take:
        opts.folder.take_frames = args.take
    if args.no_backend:
        opts.backend.ba_every_kf = False
        opts.backend.enable_loop_closure = False
    check_backend_supported(opts.slam, opts.backend)

    reader = FolderReader(
        root=opts.folder.root, left_dir=opts.folder.left, right_dir=opts.folder.right,
        imu_file=opts.folder.imu_file, timescale=opts.folder.timescale,
        skip_frames=opts.folder.skip_frames, take_frames=opts.folder.take_frames)

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

    has_imu = reader.has_imu() and not args.no_imu
    if has_imu:
        print("IMU stream found — VIO branch enabled")
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

    def draw(tel, info):
        """--viz: the overlays of a keyframe whose frame is still held."""
        nonlocal viz_prev_snap
        if bool(tel.is_keyframe) and system.last_kf_snap is not None \
                and info["frame"] in viz_imgs:
            from zenslam_tpu_torch.analysis.overlays import save_keyframe_overlays

            viz_entries.append(save_keyframe_overlays(
                os.path.join(opts.folder.output, "viz"), info["frame"], *viz_imgs[info["frame"]],
                system.last_kf_snap, viz_prev_snap))
            viz_prev_snap = system.last_kf_snap

    R = t = None
    # --viz: recent rectified device frames, so that a (telemetry-lagged)
    # keyframe's overlay finds its images, and the previous keyframe's
    # snapshot for the temporal join
    viz_entries, viz_imgs, viz_prev_snap = [], {}, None
    try:
        for frame in _timed(reader.frames_prefetch()):
            frame, wait_ms = frame
            il = upload(frame.left, dev)
            ir = upload(frame.right, dev)
            imu = upload_imu(frame, dev) if has_imu else None
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
            tel, info = process_frame(system, il, ir, imu=imu)
            dt_ms = (time.time() - t0) * 1000 + wait_ms
            times.append(dt_ms)
            n += 1
            if args.viz:
                viz_imgs[n - 1] = (il, ir)
            if tel is None:
                continue
            R, t = emit(tel, info, dt_ms)
            if args.viz:
                draw(tel, info)
                for k in [k for k in viz_imgs if k < info["frame"] - 1]:
                    del viz_imgs[k]
            if n % 50 == 0:
                print(f"frame {n}: {np.mean(times[-50:]):.1f} ms/frame, "
                      f"map {int(tel.map_size)}, inliers {int(tel.n_pose_inliers)}")
        if system is not None:
            for tel, info in flush_pipeline(system):
                R, t = emit(tel, info, 0.0)
                if args.viz:
                    draw(tel, info)
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
              f"{opts.folder.output}/scene.{{ply,html}}"
              + (" + scene_3d.png" if scene["png"] else ""))
    if args.viz and viz_entries:
        from zenslam_tpu_torch.analysis.overlays import export_viz_report

        # timing plots from the run's own telemetry feed the report
        timing_pngs = []
        try:
            from zenslam_tpu_torch.analysis.plot_timing_breakdown import main as plot_main

            plot_main(["--csv", os.path.join(opts.folder.output, "frame_data.csv"),
                       "--output", os.path.join(opts.folder.output, "plots")])
            if os.path.exists(os.path.join(opts.folder.output, "plots", "timing_stacked.png")):
                timing_pngs.append(os.path.join("plots", "timing_stacked.png"))
            print("viz: timing plots written")
        except Exception as e:  # plots are garnish; overlays are the product
            print(f"viz: timing plots skipped ({e})")
        report = export_viz_report(opts.folder.output, viz_entries, timing_pngs)
        print(f"viz: {len(viz_entries)} keyframe overlay pairs -> {report}")
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


def upload_imu(frame, device):
    """A frame's padded IMU slice as the step's (gyro, accel, dts, mask) on
    ``device``: the four arrays packed into one (S, 8) float32 host buffer
    (pinned on CUDA), one copy, split on the device."""
    import torch

    buf = np.concatenate([frame.imu_gyro, frame.imu_accel, frame.imu_dt[:, None],
                          frame.imu_mask[:, None]], axis=1).astype(np.float32)
    t = torch.from_numpy(buf)
    pin = torch.device(device).type == "cuda"
    if pin:
        t = t.pin_memory()
    t = t.to(device, non_blocking=pin)
    return t[:, 0:3], t[:, 3:6], t[:, 6], t[:, 7] > 0.5


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
