"""Dataset reading: EuRoC / TUM-VI style stereo folders, the IMU CSV and
groundtruth — counterpart of ``zenslam_tpu/io/dataset.py``.

- ``FolderReader``: sorted stereo image folders, filename-nanosecond
  timestamps times ``timescale``, timestamp pairing, skip/take windowing and
  the fixed-capacity IMU slice of each frame interval (numpy);
- ``frames_prefetch``: the same frames decoded by the native threaded
  prefetcher (``native/loader.py``) ahead of the consumer;
- ``Groundtruth``: CSV poses with SLERP interpolation.

PNG goes through the native decoder; PGM and NPY are read in Python. Frames
are host float32 arrays in [0, 1].
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, NamedTuple

import numpy as np
import torch

from zenslam_tpu_torch.geometry.lie import quat_slerp, quat_to_rotmat


class StereoFrame(NamedTuple):
    timestamp: float         # seconds
    left: np.ndarray         # (H, W) float32 [0, 1]
    right: np.ndarray
    imu_gyro: np.ndarray     # (S, 3) samples in (prev, current]
    imu_accel: np.ndarray    # (S, 3)
    imu_dt: np.ndarray       # (S,)
    imu_mask: np.ndarray     # (S,) bool


def _decode_image(path: str) -> np.ndarray:
    """Decode PGM / PNG / NPY to float32 [0, 1] grayscale."""
    if path.endswith(".npy"):
        img = np.load(path)
    elif path.endswith(".pgm"):
        img = _read_pgm(path)
    elif path.endswith(".png"):
        from zenslam_tpu_torch.native import loader

        img = loader.decode_png_gray(path)
    else:
        raise ValueError(f"unsupported image format: {path}")
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


def _read_pgm(path: str) -> np.ndarray:
    """Binary (P5) PGM, 8 or 16 bit, '#' comment lines skipped."""
    with open(path, "rb") as f:
        data = f.read()
    first, rest = data.split(b"\n", 1)
    if first.strip() != b"P5":
        raise ValueError(f"only binary PGM (P5) is supported: {path}")
    tokens, pos = [], 0
    while len(tokens) < 3:
        nl = rest.index(b"\n", pos)
        line = rest[pos:nl].strip()
        pos = nl + 1
        if not line.startswith(b"#"):
            tokens += line.split()
    w, h, maxval = int(tokens[0]), int(tokens[1]), int(tokens[2])
    dt = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
    img = np.frombuffer(rest[pos:pos + w * h * dt.itemsize], dtype=dt)
    return img.astype(np.uint16 if maxval > 255 else np.uint8).reshape(h, w)


@dataclass
class FolderReader:
    """EuRoC mav0-style layout: root/cam0/data/<ns>.png,
    root/cam1/data/<ns>.png, root/imu0/data.csv (ns, wx, wy, wz, ax, ay, az)."""

    root: str
    left_dir: str = "cam0/data"
    right_dir: str = "cam1/data"
    imu_file: str = "imu0/data.csv"
    timescale: float = 1e-9
    skip_frames: int = 0
    take_frames: int = 0       # 0 = all
    max_imu_per_frame: int = 64

    def _list(self, sub: str):
        d = os.path.join(self.root, sub)
        out = []
        for n in os.listdir(d):
            stem = n.rsplit(".", 1)[0]
            try:
                ts = int(stem) * self.timescale
            except ValueError:
                continue
            out.append((ts, os.path.join(d, n)))
        # numeric order, never filename order: names need not be zero-padded
        out.sort(key=lambda p: p[0])
        return out

    def has_imu(self) -> bool:
        """Whether the dataset carries an IMU stream."""
        return os.path.exists(os.path.join(self.root, self.imu_file))

    def _load_imu(self):
        path = os.path.join(self.root, self.imu_file)
        if not os.path.exists(path):
            return None
        rows = np.loadtxt(path, delimiter=",", comments="#", ndmin=2)
        ts = rows[:, 0] * self.timescale
        return ts, rows[:, 1:4].astype(np.float32), rows[:, 4:7].astype(np.float32)

    def frame_index(self):
        """Paired (timestamp, left_path, right_path) list after skip/take."""
        right = {round(ts, 6): p for ts, p in self._list(self.right_dir)}
        pairs = [(ts, lp, right[round(ts, 6)]) for ts, lp in self._list(self.left_dir)
                 if round(ts, 6) in right]
        pairs = pairs[self.skip_frames:]
        if self.take_frames:
            pairs = pairs[:self.take_frames]
        return pairs

    def _imu_slice(self, imu, prev_ts, ts):
        """Fixed-capacity IMU slice of the (prev_ts, ts] interval."""
        S = self.max_imu_per_frame
        g = np.zeros((S, 3), np.float32)
        a = np.zeros((S, 3), np.float32)
        dt = np.zeros(S, np.float32)
        m = np.zeros(S, bool)
        if imu is not None:
            its, gyro, accel = imu
            sel = np.flatnonzero((its > prev_ts) & (its <= ts))[:S]
            n = sel.size
            if n:
                g[:n] = gyro[sel]
                a[:n] = accel[sel]
                dt[:n] = np.diff(np.concatenate([[prev_ts], its[sel]])).astype(np.float32)
                m[:n] = True
        return g, a, dt, m

    def frames(self) -> Iterator[StereoFrame]:
        pairs = self.frame_index()
        imu = self._load_imu()
        prev_ts = pairs[0][0] if pairs else 0.0
        for ts, lp, rp in pairs:
            g, a, dt, m = self._imu_slice(imu, prev_ts, ts)
            yield StereoFrame(timestamp=ts, left=_decode_image(lp), right=_decode_image(rp),
                              imu_gyro=g, imu_accel=a, imu_dt=dt, imu_mask=m)
            prev_ts = ts

    def frames_prefetch(self, queue_cap: int = 4, n_threads: int = 2) -> Iterator[StereoFrame]:
        """Like :meth:`frames`, with PNG decode on native worker threads
        ahead of the consumer. Folders of other formats are read serially."""
        pairs = self.frame_index()
        if not pairs:
            return
        if not pairs[0][1].endswith(".png"):
            yield from self.frames()
            return
        from zenslam_tpu_torch.native.loader import PrefetchReader

        H, W = _decode_image(pairs[0][1]).shape
        imu = self._load_imu()
        ts_list = [p[0] for p in pairs]
        reader = PrefetchReader([p[1] for p in pairs], [p[2] for p in pairs], width=W,
                                height=H, queue_cap=queue_cap, n_threads=n_threads)
        prev_ts = ts_list[0]
        for idx, left, right in reader:
            ts = ts_list[idx]
            g, a, dt, m = self._imu_slice(imu, prev_ts, ts)
            yield StereoFrame(timestamp=ts, left=left, right=right,
                              imu_gyro=g, imu_accel=a, imu_dt=dt, imu_mask=m)
            prev_ts = ts


class Groundtruth:
    """CSV pose file (ts, px py pz, qw qx qy qz, ...) with SLERP
    interpolation; the quaternion math in float32 on the CPU."""

    def __init__(self, path: str, timescale: float = 1e-9):
        rows = np.loadtxt(path, delimiter=",", comments="#", ndmin=2)
        self.ts = rows[:, 0] * timescale
        self.pos = rows[:, 1:4].astype(np.float64)
        self.quat = rows[:, 4:8].astype(np.float64)  # (w, x, y, z)

    def pose_at(self, t: float):
        """Interpolated (R_wb, p_wb) at time t (body pose in world)."""
        i = int(np.clip(np.searchsorted(self.ts, t), 1, len(self.ts) - 1))
        t0, t1 = self.ts[i - 1], self.ts[i]
        alpha = 0.0 if t1 <= t0 else float(np.clip((t - t0) / (t1 - t0), 0.0, 1.0))
        p = (1 - alpha) * self.pos[i - 1] + alpha * self.pos[i]
        q = quat_slerp(torch.tensor(self.quat[i - 1], dtype=torch.float32),
                       torch.tensor(self.quat[i], dtype=torch.float32), alpha)
        return quat_to_rotmat(q).numpy(), p.astype(np.float32)
