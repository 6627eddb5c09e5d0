"""Synthetic stereo sequences — the port's own copy of the parts of
``zenslam_tpu/io/synthetic.py`` the port needs: the textured corridor world,
the closed room of the loop workload, the host (numpy) renderer, a device
(torch) renderer, the default rig, ``make_sequence`` for the 'strafe',
'forward', 'arc' and 'orbit' motions with optional pixel noise (no IMU, no
lines, no photometric effects), and the dataset writers: sequences rendered
through a distorted camchain (``make_distorted_sequence``,
``distort_sequence``), Kalibr YAML, PNG and EuRoC-layout folders
(``export_dataset``).

The numpy parts are the reference's code as it stands, so the same
generator state renders the same images in both packages.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from zenslam_tpu_torch.geometry.camera import PinholeCamera, StereoRig
from zenslam_tpu_torch.pipeline.state import resolve_device


def smooth_texture(rng: np.random.Generator, h: int, w: int, octaves: int = 7,
                   roughness: float = 0.65) -> np.ndarray:
    """Multi-octave random texture in [0,1], float32 (h, w)."""
    tex = np.zeros((h, w), np.float32)
    for o in range(octaves):
        shift = max(octaves - 1 - o, 0)
        hs, ws = max(2, h >> shift), max(2, w >> shift)
        coarse = rng.standard_normal((hs, ws)).astype(np.float32)
        yi = np.linspace(0, hs - 1, h, dtype=np.float32)
        xi = np.linspace(0, ws - 1, w, dtype=np.float32)
        y0 = np.clip(yi.astype(np.int32), 0, hs - 2)
        x0 = np.clip(xi.astype(np.int32), 0, ws - 2)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        up = (coarse[y0][:, x0] * (1 - fy) * (1 - fx)
              + coarse[y0][:, x0 + 1] * (1 - fy) * fx
              + coarse[y0 + 1][:, x0] * fy * (1 - fx)
              + coarse[y0 + 1][:, x0 + 1] * fy * fx)
        tex += up * (roughness ** (octaves - 1 - o))
    tex -= tex.min()
    tex /= max(tex.max(), 1e-6)
    return tex.astype(np.float32)


class PlaneWorld(NamedTuple):
    """Textured planes n·X + d = 0 with in-plane texture axes."""

    normals: np.ndarray    # (P, 3)
    offsets: np.ndarray    # (P,)
    origins: np.ndarray    # (P, 3)
    u_axes: np.ndarray     # (P, 3)
    v_axes: np.ndarray     # (P, 3)
    textures: np.ndarray   # (P, TH, TW)
    tex_scale: float       # texture pixels per metre


def make_corridor_world(rng: np.random.Generator, tex_size: int = 1024) -> PlaneWorld:
    """End wall (z=6), floor (y=+1.5) and ceiling (y=-1.2)."""
    textures = np.stack([smooth_texture(rng, tex_size, tex_size) for _ in range(3)])
    normals = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    points = np.array([[0, 0, 6.0], [0, 1.5, 0], [0, -1.2, 0]], np.float32)
    offsets = -np.einsum("pi,pi->p", normals, points).astype(np.float32)
    u_axes = np.array([[1, 0, 0], [1, 0, 0], [1, 0, 0]], np.float32)
    v_axes = np.array([[0, 1, 0], [0, 0, 1], [0, 0, 1]], np.float32)
    return PlaneWorld(normals, offsets, points, u_axes, v_axes, textures, tex_scale=96.0)


def make_room_world(rng: np.random.Generator, tex_size: int = 1024,
                    half: float = 3.0) -> PlaneWorld:
    """A closed room (walls x = ±half, z = ±half, floor y = +1.5, ceiling
    y = -1.2), each plane with its own texture: an orbit inside it revisits
    its starting view."""
    textures = np.stack([smooth_texture(rng, tex_size, tex_size) for _ in range(6)])
    normals = np.array([[1.0, 0, 0], [1.0, 0, 0], [0, 0, 1.0], [0, 0, 1.0],
                        [0, 1.0, 0], [0, 1.0, 0]], np.float32)
    points = np.array([[half, 0, 0], [-half, 0, 0], [0, 0, half], [0, 0, -half],
                       [0, 1.5, 0], [0, -1.2, 0]], np.float32)
    offsets = -np.einsum("pi,pi->p", normals, points).astype(np.float32)
    u_axes = np.array([[0, 0, 1], [0, 0, 1], [1, 0, 0], [1, 0, 0], [1, 0, 0], [1, 0, 0]],
                      np.float32)
    v_axes = np.array([[0, 1, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1]],
                      np.float32)
    return PlaneWorld(normals, offsets, points, u_axes, v_axes, textures, tex_scale=96.0)


def render_view(world: PlaneWorld, cam: PinholeCamera, R_cw: np.ndarray,
                t_cw: np.ndarray, height: int, width: int, rays_cam=None) -> np.ndarray:
    """Host render of one view by ray-plane intersection + bilinear texture
    lookup; float32 (H, W) in [0, 1]. ``rays_cam`` (H, W, 3): per-pixel
    camera rays of a distorted camera (default: the pinhole rays)."""
    fx, fy, cx, cy = float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy)
    R_wc = R_cw.T
    c = -R_wc @ t_cw
    if rays_cam is None:
        u, v = np.meshgrid(np.arange(width, dtype=np.float32),
                           np.arange(height, dtype=np.float32))
        rays_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], axis=-1)
    rays_w = rays_cam @ R_wc.T
    img = np.zeros((height, width), np.float32)
    depth = np.full((height, width), np.inf, np.float32)
    for p in range(world.normals.shape[0]):
        n = world.normals[p]
        d = world.offsets[p]
        denom = rays_w @ n
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        tval = -(c @ n + d) / denom
        X = c[None, None, :] + tval[..., None] * rays_w
        hit = tval > 0.1
        rel = X - world.origins[p]
        tu = (rel @ world.u_axes[p]) * world.tex_scale
        tv = (rel @ world.v_axes[p]) * world.tex_scale
        TH, TW = world.textures[p].shape
        tui = np.mod(tu, TW - 1)
        tvi = np.mod(tv, TH - 1)
        x0 = tui.astype(np.int32)
        y0 = tvi.astype(np.int32)
        fxw = tui - x0
        fyw = tvi - y0
        tex = world.textures[p]
        val = (tex[y0, x0] * (1 - fxw) * (1 - fyw)
               + tex[y0, np.minimum(x0 + 1, TW - 1)] * fxw * (1 - fyw)
               + tex[np.minimum(y0 + 1, TH - 1), x0] * (1 - fxw) * fyw
               + tex[np.minimum(y0 + 1, TH - 1), np.minimum(x0 + 1, TW - 1)] * fxw * fyw)
        closer = hit & (tval < depth)
        img = np.where(closer, val, img)
        depth = np.where(closer, tval, depth)
    return img


def render_view_device(world: PlaneWorld, cam: PinholeCamera, R_cw, t_cw,
                       height: int, width: int, device, rays_cam=None) -> torch.Tensor:
    """The same ray-plane render in f32 torch on ``device`` (1024² frames in
    milliseconds on a card instead of seconds on the host). Returns (H, W).
    ``rays_cam``: as for ``render_view``."""
    f32 = torch.float32
    tex_all = torch.as_tensor(world.textures, dtype=f32, device=device)
    R_cw = torch.as_tensor(np.asarray(R_cw, np.float32), device=device)
    t_cw = torch.as_tensor(np.asarray(t_cw, np.float32), device=device)
    R_wc = R_cw.T
    c = -R_wc @ t_cw
    if rays_cam is None:
        v, u = torch.meshgrid(torch.arange(height, dtype=f32, device=device),
                              torch.arange(width, dtype=f32, device=device), indexing="ij")
        rays_cam = torch.stack([(u - float(cam.cx)) / float(cam.fx),
                                (v - float(cam.cy)) / float(cam.fy), torch.ones_like(u)], -1)
    else:
        rays_cam = torch.as_tensor(np.asarray(rays_cam, np.float32), device=device)
    rays_w = rays_cam @ R_wc.T
    img = torch.zeros((height, width), dtype=f32, device=device)
    depth = torch.full((height, width), float("inf"), dtype=f32, device=device)
    TH, TW = tex_all.shape[1], tex_all.shape[2]
    for p in range(world.normals.shape[0]):
        n = torch.as_tensor(world.normals[p], device=device)
        denom = rays_w @ n
        denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
        tval = -(c @ n + float(world.offsets[p])) / denom
        X = c + tval[..., None] * rays_w
        rel = X - torch.as_tensor(world.origins[p], device=device)
        tu = (rel @ torch.as_tensor(world.u_axes[p], device=device)) * world.tex_scale
        tv = (rel @ torch.as_tensor(world.v_axes[p], device=device)) * world.tex_scale
        tui = torch.remainder(tu, TW - 1)
        tvi = torch.remainder(tv, TH - 1)
        x0 = tui.to(torch.int64)
        y0 = tvi.to(torch.int64)
        fxw = tui - x0
        fyw = tvi - y0
        x1 = torch.clamp(x0 + 1, max=TW - 1)
        y1 = torch.clamp(y0 + 1, max=TH - 1)
        tex = tex_all[p]
        val = (tex[y0, x0] * (1 - fxw) * (1 - fyw) + tex[y0, x1] * fxw * (1 - fyw)
               + tex[y1, x0] * (1 - fxw) * fyw + tex[y1, x1] * fxw * fyw)
        closer = (tval > 0.1) & (tval < depth)
        img = torch.where(closer, val, img)
        depth = torch.where(closer, tval, depth)
    return img


def default_rig(width: int = 512, height: int = 384, device=None) -> StereoRig:
    """EuRoC-like rectified stereo rig (fx = fy = 380, 0.11 m baseline)."""
    dev = resolve_device(device)

    def s(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    cam = PinholeCamera(fx=s(380.0), fy=s(380.0), cx=s(width / 2.0), cy=s(height / 2.0),
                        dist=torch.zeros(4, dtype=torch.float32, device=dev),
                        width=width, height=height)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    return StereoRig(left=cam, right=cam, R_rl=eye, t_rl=s([-0.11, 0.0, 0.0]),
                     R_ci=eye.clone(), t_ci=torch.zeros(3, dtype=torch.float32, device=dev))


class SyntheticSequence(NamedTuple):
    left: object            # (T, H, W) float32 (numpy, or a tensor when device-rendered)
    right: object
    R_lw: np.ndarray        # (T, 3, 3) world->left-cam
    t_lw: np.ndarray        # (T, 3)
    timestamps: np.ndarray  # (T,)
    rig: StereoRig


def make_sequence(rng: np.random.Generator, n_frames: int = 20, width: int = 512,
                  height: int = 384, motion: str = "strafe", dt: float = 0.05,
                  speed: float = 0.4, device_render: bool = False, pixel_noise: float = 0.0,
                  orbit_radius: float = 1.5, orbit_revolutions: float = 1.0,
                  device=None) -> SyntheticSequence:
    """Render a stereo sequence with groundtruth. motion: 'strafe' (x
    translation), 'forward' (z), 'arc' (translation + yaw) or 'orbit'
    (``orbit_revolutions`` turns of radius ``orbit_radius`` inside the closed
    room, looking outward: it revisits its starting view, the loop-closure
    workload). pixel_noise: additive Gaussian image noise σ, drawn from
    ``rng`` after the world, left then right per frame. With device_render
    the frames are rendered on ``device`` and returned as (T, H, W) tensors
    there; the host renderer returns numpy arrays. The rig lives on
    ``device``."""
    if motion not in ("strafe", "forward", "arc", "orbit"):
        raise NotImplementedError(f"motion {motion!r} is not ported (strafe, forward, arc, orbit)")
    world = make_room_world(rng) if motion == "orbit" else make_corridor_world(rng)
    rig = default_rig(width, height, device)
    dev = rig.R_rl.device
    R_rl = rig.R_rl.double().cpu().numpy()
    t_rl = rig.t_rl.double().cpu().numpy()

    def so3_exp_np(w):
        th = np.linalg.norm(w)
        if th < 1e-12:
            return np.eye(3)
        k = w / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0.0]])
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)

    def pose_fn(t: float):
        s = t * speed
        if motion == "strafe":
            c_w = np.array([s, 0.0, 0.0])
            R_wc = np.eye(3)
        elif motion == "forward":
            c_w = np.array([0.0, 0.0, s])
            R_wc = np.eye(3)
        elif motion == "orbit":
            theta = 2.0 * np.pi * orbit_revolutions * t / (n_frames * dt)
            c_w = orbit_radius * np.array([np.sin(theta), 0.0, np.cos(theta)])
            R_wc = so3_exp_np(np.array([0.0, theta, 0.0]))
        else:
            R_wc = so3_exp_np(np.array([0.0, 0.2 * t, 0.0]))
            c_w = np.array([s, 0.02 * np.sin(0.5 * (t / dt)), 0.3 * s])
        R_cw = R_wc.T
        return R_cw, -R_cw @ c_w

    def noisy(img):
        """The image plus Gaussian noise, clipped to [0, 1], as float32."""
        if pixel_noise <= 0:
            return img.astype(np.float32) if isinstance(img, np.ndarray) else img
        n = rng.normal(0, pixel_noise, tuple(img.shape))
        if isinstance(img, np.ndarray):
            return np.clip(img + n, 0, 1).astype(np.float32)
        return torch.clamp(img.double() + torch.from_numpy(n).to(img.device), 0, 1).float()

    timestamps = np.arange(n_frames, dtype=np.float64) * dt
    lefts, rights, Rs, ts = [], [], [], []
    for i in range(n_frames):
        R_cw, t_cw = pose_fn(timestamps[i])
        R_rcw = R_rl @ R_cw
        t_rcw = R_rl @ t_cw + t_rl
        if device_render:
            li = render_view_device(world, rig.left, R_cw, t_cw, height, width, dev)
            ri = render_view_device(world, rig.right, R_rcw, t_rcw, height, width, dev)
        else:  # the host render is float64
            li = render_view(world, rig.left, R_cw, t_cw, height, width)
            ri = render_view(world, rig.right, R_rcw, t_rcw, height, width)
        lefts.append(noisy(li))
        rights.append(noisy(ri))
        Rs.append(R_cw.astype(np.float32))
        ts.append(t_cw.astype(np.float32))
    stack = torch.stack if device_render else np.stack
    return SyntheticSequence(left=stack(lefts), right=stack(rights), R_lw=np.stack(Rs),
                             t_lw=np.stack(ts), timestamps=timestamps, rig=rig)


def distort_sequence(seq: SyntheticSequence, dist, model: str = "radtan") -> SyntheticSequence:
    """The raw (lens-distorted) version of a pinhole-rendered sequence:
    RAW(p_d) = Ideal(K·undistort(K⁻¹·p_d)), remapped on the host (CPU
    float32). Feeding it through the rectification path must give back the
    ideal geometry."""
    from zenslam_tpu_torch.geometry.camera import (
        undistort_points_equidistant, undistort_points_radtan)
    from zenslam_tpu_torch.ops.image import remap

    cam = seq.rig.left
    H, W = seq.left.shape[1:]
    fx, fy, cx, cy = float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy)
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    nd = np.stack([(u - cx) / fx, (v - cy) / fy], -1).reshape(-1, 2)
    undist = undistort_points_radtan if model == "radtan" else undistort_points_equidistant
    nu = undist(torch.as_tensor(np.asarray(dist), dtype=torch.float32), torch.from_numpy(nd))
    mx = (nu[:, 0] * fx + cx).reshape(H, W)
    my = (nu[:, 1] * fy + cy).reshape(H, W)

    def warp(frames):
        return np.stack([remap(torch.as_tensor(np.asarray(f)).cpu(), mx, my).numpy()
                         for f in frames])

    return seq._replace(left=warp(seq.left), right=warp(seq.right))


def write_kalibr_yaml(seq: SyntheticSequence, dist, path: str, model: str = "radtan") -> None:
    """A Kalibr camchain YAML of the (distorted) synthetic rig, read back by
    ``io.calibration.load_kalibr_yaml``."""
    import yaml

    cam = seq.rig.left
    H, W = seq.left.shape[1:]
    T_rl = np.eye(4)
    T_rl[:3, :3] = seq.rig.R_rl.cpu().numpy()
    T_rl[:3, 3] = seq.rig.t_rl.cpu().numpy()
    entry = {
        "camera_model": "pinhole",
        "intrinsics": [float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy)],
        "distortion_model": model,
        "distortion_coeffs": [float(x) for x in dist],
        "resolution": [int(W), int(H)],
    }
    d = {"cam0": dict(entry, T_cam_imu=np.eye(4).tolist()),
         "cam1": dict(entry, T_cn_cnm1=T_rl.tolist())}
    with open(path, "w") as f:
        yaml.safe_dump(d, f)


def write_png_gray(path: str, img: np.ndarray) -> None:
    """Minimal grayscale PNG writer (zlib): 8 or 16 bit, filter 0."""
    import struct
    import zlib

    h, w = img.shape
    depth = 16 if img.dtype == np.uint16 else 8

    def chunk(tag, body):
        out = struct.pack(">I", len(body)) + tag + body
        return out + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    rows = img.astype(">u2") if depth == 16 else img.astype(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rows.view(np.uint8).reshape(h, -1)], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def export_dataset(seq: SyntheticSequence, root: str) -> None:
    """Write a sequence as an EuRoC-style folder: 8-bit PNGs named by
    nanosecond timestamps under cam0/data and cam1/data, and groundtruth.csv
    (ns, camera centre, R_wc quaternion w x y z). Device-rendered frames are
    quantised on their device and copied once per frame."""
    from zenslam_tpu_torch.geometry.lie import rotmat_to_quat

    os.makedirs(os.path.join(root, "cam0/data"), exist_ok=True)
    os.makedirs(os.path.join(root, "cam1/data"), exist_ok=True)
    t0_ns = 1_000_000_000

    def to_u8(img):
        if isinstance(img, torch.Tensor):
            return torch.clamp(img * 255.0, 0, 255).to(torch.uint8).cpu().numpy()
        return np.clip(img * 255.0, 0, 255).astype(np.uint8)

    gt_rows = []
    for i in range(seq.left.shape[0]):
        ns = int(seq.timestamps[i] * 1e9) + t0_ns
        write_png_gray(os.path.join(root, f"cam0/data/{ns}.png"), to_u8(seq.left[i]))
        write_png_gray(os.path.join(root, f"cam1/data/{ns}.png"), to_u8(seq.right[i]))
        R = seq.R_lw[i]
        c = -R.T @ seq.t_lw[i]
        q = rotmat_to_quat(torch.from_numpy(np.ascontiguousarray(R.T))).numpy()
        gt_rows.append([ns, c[0], c[1], c[2], q[0], q[1], q[2], q[3]])
    np.savetxt(os.path.join(root, "groundtruth.csv"), np.asarray(gt_rows), delimiter=",")


def distorted_camera_rays(cam: PinholeCamera, model: str = "radtan") -> np.ndarray:
    """Per-pixel camera-frame ray directions (H, W, 3) of a distorted
    camera: normalized-distorted -> normalized-undistorted -> [x, y, 1]
    (float32 on the CPU)."""
    from zenslam_tpu_torch.geometry.camera import undistort_points_radtan

    if model != "radtan":
        raise NotImplementedError(f"distorted rendering for model {model!r}")
    H, W = int(cam.height), int(cam.width)
    fx, fy, cx, cy = float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy)
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    xd = np.stack([(u - cx) / fx, (v - cy) / fy], axis=-1).reshape(-1, 2)
    xu = undistort_points_radtan(cam.dist.cpu(), torch.from_numpy(xd)).numpy()
    rays = np.concatenate([xu, np.ones((xu.shape[0], 1), np.float32)], axis=-1)
    return rays.reshape(H, W, 3)


def make_distorted_sequence(rng: np.random.Generator, rig_raw: StereoRig,
                            models=("radtan", "radtan"), n_frames: int = 12,
                            motion: str = "strafe", dt: float = 0.1, speed: float = 0.25,
                            pixel_noise: float = 0.0,
                            device_render: bool = False) -> SyntheticSequence:
    """A stereo sequence rendered through a real (distorted) camchain rig,
    e.g. ``options/euroc_camchain.yaml``: the images are in the distorted
    geometry, so an app run with ``folder.calibration_file`` set to the same
    camchain goes through rectification before tracking. motion: 'strafe'
    or a slow forward arc. Groundtruth poses are the left camera's. With
    ``device_render`` the frames are rendered on the rig's device and
    returned as (T, H, W) tensors there (noise drawn from ``rng`` in the same
    order as the host path)."""
    world = make_corridor_world(rng)
    H, W = int(rig_raw.left.height), int(rig_raw.left.width)
    rays_l = distorted_camera_rays(rig_raw.left, models[0])
    rays_r = distorted_camera_rays(rig_raw.right, models[1])
    R_rl = rig_raw.R_rl.double().cpu().numpy()
    t_rl = rig_raw.t_rl.double().cpu().numpy()
    dev = rig_raw.R_rl.device

    def render(cam, R, t, rays):
        if device_render:
            return render_view_device(world, cam, R, t, H, W, dev, rays_cam=rays)
        return render_view(world, cam, R, t, H, W, rays_cam=rays)

    def noisy(img):
        if pixel_noise <= 0:
            return img
        n = rng.normal(0, pixel_noise, tuple(img.shape))
        if device_render:
            return torch.clamp(img.double() + torch.from_numpy(n).to(dev), 0, 1)
        return np.clip(img + n, 0, 1)

    timestamps = np.arange(n_frames, dtype=np.float64) * dt
    lefts, rights, Rs, ts = [], [], [], []
    for i in range(n_frames):
        s = timestamps[i] * speed
        c_w = np.array([s, 0.0, 0.0]) if motion == "strafe" else np.array([0.6 * s, 0.0, 0.4 * s])
        R_cw = np.eye(3)
        t_cw = -R_cw @ c_w
        li = noisy(render(rig_raw.left, R_cw, t_cw, rays_l))
        ri = noisy(render(rig_raw.right, R_rl @ R_cw, R_rl @ t_cw + t_rl, rays_r))
        lefts.append(li.float() if device_render else li.astype(np.float32))
        rights.append(ri.float() if device_render else ri.astype(np.float32))
        Rs.append(R_cw.astype(np.float32))
        ts.append(t_cw.astype(np.float32))
    stack = torch.stack if device_render else np.stack
    return SyntheticSequence(left=stack(lefts), right=stack(rights), R_lw=np.stack(Rs),
                             t_lw=np.stack(ts), timestamps=timestamps, rig=rig_raw)
