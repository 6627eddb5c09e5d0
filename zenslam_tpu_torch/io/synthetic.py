"""Synthetic stereo sequences — the port's own copy of the parts of
``zenslam_tpu/io/synthetic.py`` the port needs: the textured corridor world,
the closed room of the loop workload, the host (numpy) renderer, a device
(torch) renderer, the default rig, ``make_sequence`` for the 'strafe',
'forward', 'arc' and 'orbit' motions with optional pixel noise and body-frame
IMU (``make_imu``), the corridor's stripes and the sensor's photometric
effects (vignette, exposure flicker, noise), and the dataset
writers: sequences rendered through a distorted camchain
(``make_distorted_sequence``, ``distort_sequence``), Kalibr YAML, PNG and
EuRoC-layout folders with ``imu0/data.csv`` (``export_dataset``);
``write_png`` also writes the RGB overlays of the app's ``--viz``.

The numpy parts are the reference's code as it stands, so the same
generator state renders the same images in both packages.
"""

from __future__ import annotations

import functools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from zenslam_tpu_torch.geometry.camera import PinholeCamera, StereoRig
from zenslam_tpu_torch.pipeline.state import resolve_device
from zenslam_tpu_torch.utils.device import upload
from zenslam_tpu_torch.utils.graphs import Program


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


def make_corridor_world(rng: np.random.Generator, tex_size: int = 1024,
                        with_lines: bool = False) -> PlaneWorld:
    """End wall (z=6), floor (y=+1.5) and ceiling (y=-1.2). with_lines:
    six 4-texel black or white stripes across each plane's texture (plank
    seams, wall edges), drawn from ``rng`` after the textures; they project
    as true 3D line segments (the keyline workload)."""
    textures = np.stack([smooth_texture(rng, tex_size, tex_size) for _ in range(3)])
    if with_lines:
        for tex in textures:
            for _ in range(6):
                pos = int(rng.uniform(40, tex_size - 40))
                val = 0.0 if rng.random() < 0.5 else 1.0
                if rng.random() < 0.5:
                    tex[pos:pos + 4, :] = val
                else:
                    tex[:, pos:pos + 4] = val
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
    ``rays_cam``: as for ``render_view``. The world's arrays, the pose and
    the rays go up through pinned memory without blocking, and the render
    itself is the captured program ``_render_view_device``."""
    f32 = np.float32
    arrays = tuple(upload(np.asarray(a, f32), device) for a in (
        world.normals, world.offsets, world.origins, world.u_axes, world.v_axes,
        world.textures))
    rays = None if rays_cam is None else upload(np.asarray(rays_cam, f32), device)
    return _render_view_device(
        (*arrays, float(world.tex_scale)), float(cam.fx), float(cam.fy), float(cam.cx),
        float(cam.cy), upload(np.asarray(R_cw, f32), device),
        upload(np.asarray(t_cw, f32), device), height, width, rays_cam=rays)


@functools.partial(Program, static_argnames=("height", "width"), copy_outputs=True)
def _render_view_device(world_arrays, fx, fy, cx, cy, R_cw, t_cw, height: int, width: int,
                        rays_cam=None):
    """``render_view_device``'s render on the device of its tensors:
    ``world_arrays`` (normals, offsets, origins, u_axes, v_axes, textures,
    tex_scale), the last a float; the intrinsics and ``tex_scale`` are keyed
    by value; ``rays_cam`` (H, W, 3) or None for the pinhole rays."""
    normals, offsets, origins, u_axes, v_axes, textures, tex_scale = world_arrays
    f32 = torch.float32
    device = R_cw.device
    R_wc = R_cw.T
    c = -R_wc @ t_cw
    if rays_cam is None:
        v, u = torch.meshgrid(torch.arange(height, dtype=f32, device=device),
                              torch.arange(width, dtype=f32, device=device), indexing="ij")
        rays_cam = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)
    rays_w = rays_cam @ R_wc.T
    img = torch.zeros((height, width), dtype=f32, device=device)
    depth = torch.full((height, width), float("inf"), dtype=f32, device=device)
    TH, TW = textures.shape[1], textures.shape[2]
    for p in range(normals.shape[0]):
        n = normals[p]
        denom = rays_w @ n
        denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
        tval = -(c @ n + offsets[p]) / denom
        X = c + tval[..., None] * rays_w
        rel = X - origins[p]
        tu = (rel @ u_axes[p]) * tex_scale
        tv = (rel @ v_axes[p]) * tex_scale
        tui = torch.remainder(tu, TW - 1)
        tvi = torch.remainder(tv, TH - 1)
        x0 = tui.to(torch.int64)
        y0 = tvi.to(torch.int64)
        fxw = tui - x0
        fyw = tvi - y0
        x1 = torch.clamp(x0 + 1, max=TW - 1)
        y1 = torch.clamp(y0 + 1, max=TH - 1)
        tex = textures[p]
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
    # IMU (make_sequence(with_imu=True); body frame = left camera)
    gyro: np.ndarray = None       # (T, S, 3) rad/s
    accel: np.ndarray = None      # (T, S, 3) m/s² specific force
    imu_dts: np.ndarray = None    # (T, S) seconds
    imu_mask: np.ndarray = None   # (T, S) bool (frame 0 all False)
    gravity_w: np.ndarray = None  # (3,) true gravity in the world frame


def _np_so3_log(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector (numpy, float64)."""
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(c)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = 2.0 * np.sin(theta)
    if theta < 1e-8:
        return 0.5 * w
    return (theta / s) * w


def make_imu(pose_fn, timestamps: np.ndarray, samples_per_frame: int = 10,
             gravity_w=(0.0, 9.81, 0.0), rng: np.random.Generator | None = None,
             gyro_noise: float = 0.0, accel_noise: float = 0.0):
    """Body-frame IMU of a continuous trajectory: pose_fn(t) -> (R_cw, t_cw)
    world->cam in float64, body = left camera. Gyro and accel are numerical
    derivatives at each sample's interval midpoint; the accelerometer
    measures the specific force f_b = R_bw (a_w - g_w). Returns (gyro
    (T,S,3), accel (T,S,3), dts (T,S), mask (T,S)), float32 but the bool
    mask; frame 0 has no samples."""
    g_w = np.asarray(gravity_w, np.float64)
    T, S = len(timestamps), samples_per_frame
    gyro = np.zeros((T, S, 3), np.float64)
    accel = np.zeros((T, S, 3), np.float64)
    dts = np.zeros((T, S), np.float64)
    mask = np.zeros((T, S), bool)
    eps = 1e-4

    def body_pose(t):
        R_cw, t_cw = pose_fn(t)
        return R_cw.T, -R_cw.T @ t_cw

    for k in range(1, T):
        t0, t1 = timestamps[k - 1], timestamps[k]
        h = (t1 - t0) / S
        for j in range(S):
            tm = t0 + (j + 0.5) * h
            R0, _ = body_pose(tm - eps / 2)
            R1, _ = body_pose(tm + eps / 2)
            w_b = _np_so3_log(R0.T @ R1) / eps
            _, pm = body_pose(tm)
            _, pa = body_pose(tm - eps)
            _, pb = body_pose(tm + eps)
            a_w = (pb - 2.0 * pm + pa) / (eps * eps)
            R_wb, _ = body_pose(tm)
            gyro[k, j] = w_b
            accel[k, j] = R_wb.T @ (a_w - g_w)
            dts[k, j] = h
            mask[k, j] = True
    if rng is not None and (gyro_noise > 0 or accel_noise > 0):
        gyro += rng.normal(0, gyro_noise, gyro.shape)
        accel += rng.normal(0, accel_noise, accel.shape)
    return (gyro.astype(np.float32), accel.astype(np.float32), dts.astype(np.float32), mask)


def make_sequence(rng: np.random.Generator, n_frames: int = 20, width: int = 512,
                  height: int = 384, motion: str = "strafe", dt: float = 0.05,
                  speed: float = 0.4, with_lines: bool = False, with_imu: bool = False,
                  imu_samples_per_frame: int = 10, gravity_w=(0.0, 9.81, 0.0),
                  device_render: bool = False, pixel_noise: float = 0.0,
                  orbit_radius: float = 1.5, orbit_revolutions: float = 1.0,
                  exposure_jitter: float = 0.0, vignette: float = 0.0,
                  device=None) -> SyntheticSequence:
    """Render a stereo sequence with groundtruth. motion: 'strafe' (x
    translation), 'forward' (z), 'arc' (translation + yaw) or 'orbit'
    (``orbit_revolutions`` turns of radius ``orbit_radius`` inside the closed
    room, looking outward: it revisits its starting view, the loop-closure
    workload). with_lines: stripes on the corridor's planes
    (``make_corridor_world``; the orbit's room has none). The sensor's
    photometric effects, each off at 0 (the full-dress run's ``--hard`` set):
    vignette, a radial falloff ``1 - vignette * r²`` (r² 1 at the image's
    corners); exposure_jitter, σ of a per-frame, per-camera log-gain;
    pixel_noise, additive Gaussian image noise σ. Per frame, ``rng`` draws
    (after the world) the left gain, the right gain, the left noise, the
    right noise; with any effect on, the frames are clipped to [0, 1]. With
    device_render the frames are rendered on ``device`` and returned as (T,
    H, W) tensors there, the effects applied there in the dtypes numpy gives
    the host render; the host renderer returns numpy arrays, its views
    rendered by torch's intra-op thread count of threads at once (the same
    frames: the render draws nothing from ``rng``). The rig lives on
    ``device``."""
    if motion not in ("strafe", "forward", "arc", "orbit"):
        raise NotImplementedError(f"motion {motion!r} is not ported (strafe, forward, arc, orbit)")
    world = (make_room_world(rng) if motion == "orbit"
             else make_corridor_world(rng, with_lines=with_lines))
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

    photometric = vignette > 0 or exposure_jitter > 0 or pixel_noise > 0
    vig = None
    if vignette > 0:
        yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
        r2 = (((xx - width / 2) / (width / 2)) ** 2
              + ((yy - height / 2) / (height / 2)) ** 2) / 2.0
        vig = (1.0 - vignette * r2).astype(np.float32)
        if device_render:
            vig = torch.from_numpy(vig).to(dev)

    def wide(img):
        """``img`` ready for a float64 operand: numpy promotes by itself, a
        tensor (float32 from the device render) is widened."""
        return img.double() if isinstance(img, torch.Tensor) else img

    def sensor(li, ri):
        """The pair through the vignette, the exposure gains and the noise,
        in the reference's draw order; float32, clipped when any is on."""
        if vig is not None:
            li, ri = li * vig, ri * vig
        if exposure_jitter > 0:
            gl = np.exp(rng.normal(0, exposure_jitter))
            gr = np.exp(rng.normal(0, exposure_jitter))
            li, ri = wide(li) * gl, wide(ri) * gr
        if pixel_noise > 0:
            nl = rng.normal(0, pixel_noise, tuple(li.shape))
            nr = rng.normal(0, pixel_noise, tuple(ri.shape))
            if isinstance(li, torch.Tensor):
                nl, nr = torch.from_numpy(nl).to(dev), torch.from_numpy(nr).to(dev)
            li, ri = wide(li) + nl, wide(ri) + nr
        if isinstance(li, torch.Tensor):
            return ((torch.clamp(li, 0, 1).float(), torch.clamp(ri, 0, 1).float())
                    if photometric else (li, ri))
        if photometric:
            li, ri = np.clip(li, 0, 1), np.clip(ri, 0, 1)
        return li.astype(np.float32), ri.astype(np.float32)

    timestamps = np.arange(n_frames, dtype=np.float64) * dt
    poses = [pose_fn(timestamps[i]) for i in range(n_frames)]

    def views(i):
        R_cw, t_cw = poses[i]
        R_rcw = R_rl @ R_cw
        t_rcw = R_rl @ t_cw + t_rl
        if device_render:
            return (render_view_device(world, rig.left, R_cw, t_cw, height, width, dev),
                    render_view_device(world, rig.right, R_rcw, t_rcw, height, width, dev))
        # the host render is float64
        return (render_view(world, rig.left, R_cw, t_cw, height, width),
                render_view(world, rig.right, R_rcw, t_rcw, height, width))

    if device_render or torch.get_num_threads() <= 1:
        rendered = map(views, range(n_frames))
    else:
        with ThreadPoolExecutor(torch.get_num_threads()) as pool:
            rendered = list(pool.map(views, range(n_frames)))
    lefts, rights, Rs, ts = [], [], [], []
    for (R_cw, t_cw), (li, ri) in zip(poses, rendered):
        li, ri = sensor(li, ri)
        lefts.append(li)
        rights.append(ri)
        Rs.append(R_cw.astype(np.float32))
        ts.append(t_cw.astype(np.float32))
    imu = {}
    if with_imu:
        gyro, accel, imu_dts, imu_mask = make_imu(pose_fn, timestamps, imu_samples_per_frame,
                                                  gravity_w)
        imu = dict(gyro=gyro, accel=accel, imu_dts=imu_dts, imu_mask=imu_mask,
                   gravity_w=np.asarray(gravity_w, np.float32))
    stack = torch.stack if device_render else np.stack
    return SyntheticSequence(left=stack(lefts), right=stack(rights), R_lw=np.stack(Rs),
                             t_lw=np.stack(ts), timestamps=timestamps, rig=rig, **imu)


def distort_sequence(seq: SyntheticSequence, dist, model: str = "radtan") -> SyntheticSequence:
    """The raw (lens-distorted) version of a pinhole-rendered sequence:
    RAW(p_d) = Ideal(K·undistort(K⁻¹·p_d)), with the map computed on the
    CPU in float32 and applied where the frames live (numpy frames on the
    host, device-rendered tensors on their device). Feeding it through the
    rectification path must give back the ideal geometry."""
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
        if isinstance(frames, torch.Tensor):  # device-rendered: remap on its device
            mxd, myd = mx.to(frames.device), my.to(frames.device)
            return torch.stack([remap(f, mxd, myd) for f in frames])
        return np.stack([remap(torch.as_tensor(np.asarray(f)), mx, my).numpy()
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


def write_png(path: str, img: np.ndarray) -> None:
    """Minimal PNG writer (zlib, filter 0): (H, W) grayscale at 8 or 16 bit,
    or (H, W, 3) 8-bit RGB."""
    import struct
    import zlib

    h, w = img.shape[:2]
    rgb = img.ndim == 3
    depth = 16 if img.dtype == np.uint16 and not rgb else 8

    def chunk(tag, body):
        out = struct.pack(">I", len(body)) + tag + body
        return out + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    rows = img.astype(">u2") if depth == 16 else img.astype(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rows.view(np.uint8).reshape(h, -1)], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, depth, 2 if rgb else 0, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def write_png_gray(path: str, img: np.ndarray) -> None:
    """Grayscale PNG, 8 or 16 bit (the reference's name for ``write_png`` on
    an (H, W) image)."""
    if img.ndim != 2:
        raise ValueError(f"write_png_gray takes an (H, W) image, got shape {img.shape}")
    write_png(path, img)


def export_dataset(seq: SyntheticSequence, root: str) -> None:
    """Write a sequence as an EuRoC-style folder: 8-bit PNGs named by
    nanosecond timestamps under cam0/data and cam1/data, groundtruth.csv
    (ns, camera centre, R_wc quaternion w x y z) and, when the sequence
    carries IMU, imu0/data.csv (ns, wx, wy, wz, ax, ay, az; sample k of
    frame interval i stamped at the end of its dt). Device-rendered frames
    are quantised on their device and copied once per frame."""
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
        write_png(os.path.join(root, f"cam0/data/{ns}.png"), to_u8(seq.left[i]))
        write_png(os.path.join(root, f"cam1/data/{ns}.png"), to_u8(seq.right[i]))
        R = seq.R_lw[i]
        c = -R.T @ seq.t_lw[i]
        q = rotmat_to_quat(torch.from_numpy(np.ascontiguousarray(R.T))).numpy()
        gt_rows.append([ns, c[0], c[1], c[2], q[0], q[1], q[2], q[3]])
    np.savetxt(os.path.join(root, "groundtruth.csv"), np.asarray(gt_rows), delimiter=",")
    if seq.gyro is not None:
        os.makedirs(os.path.join(root, "imu0"), exist_ok=True)
        rows = []
        for i in range(seq.left.shape[0]):
            acc = seq.timestamps[i - 1] if i else seq.timestamps[0]
            for k in range(seq.gyro.shape[1]):
                if not seq.imu_mask[i, k]:
                    continue
                acc += float(seq.imu_dts[i, k])
                rows.append([int(acc * 1e9) + t0_ns, *seq.gyro[i, k], *seq.accel[i, k]])
        np.savetxt(os.path.join(root, "imu0/data.csv"), np.asarray(rows), delimiter=",",
                   fmt=["%d"] + ["%.9f"] * 6)


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
                            pixel_noise: float = 0.0, device_render: bool = False,
                            with_imu: bool = False,
                            with_lines: bool = False) -> SyntheticSequence:
    """A stereo sequence rendered through a real (distorted) camchain rig,
    e.g. ``options/euroc_camchain.yaml``: the images are in the distorted
    geometry, so an app run with ``folder.calibration_file`` set to the same
    camchain goes through rectification before tracking. motion: 'strafe'
    or a slow forward arc. Groundtruth poses are the left camera's. With
    ``device_render`` the frames are rendered on the rig's device and
    returned as (T, H, W) tensors there (noise drawn from ``rng`` in the same
    order as the host path). ``with_imu``: IMU as ``make_sequence`` (10
    samples a frame), in the rig's IMU frame (body = the IMU that
    ``T_cam_imu``, i.e. ``rig_raw.R_ci``/``t_ci``, places against the left
    camera, so the lever arm is in the accelerometer's reading), drawing
    nothing from ``rng``. ``with_lines``: the corridor's stripes
    (``make_corridor_world``), the keyline workload."""
    world = make_corridor_world(rng, with_lines=with_lines)
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

    def pose_fn(t: float):
        s = t * speed
        c_w = np.array([s, 0.0, 0.0]) if motion == "strafe" else np.array([0.6 * s, 0.0, 0.4 * s])
        return np.eye(3), -c_w

    timestamps = np.arange(n_frames, dtype=np.float64) * dt
    lefts, rights, Rs, ts = [], [], [], []
    for i in range(n_frames):
        R_cw, t_cw = pose_fn(timestamps[i])
        li = noisy(render(rig_raw.left, R_cw, t_cw, rays_l))
        ri = noisy(render(rig_raw.right, R_rl @ R_cw, R_rl @ t_cw + t_rl, rays_r))
        lefts.append(li.float() if device_render else li.astype(np.float32))
        rights.append(ri.float() if device_render else ri.astype(np.float32))
        Rs.append(R_cw.astype(np.float32))
        ts.append(t_cw.astype(np.float32))
    imu = {}
    if with_imu:
        R_ci = rig_raw.R_ci.double().cpu().numpy()
        t_ci = rig_raw.t_ci.double().cpu().numpy()

        def imu_pose(t: float):   # world -> IMU: T_ci^-1 ∘ T_cw
            R_cw, t_cw = pose_fn(t)
            return R_ci.T @ R_cw, R_ci.T @ (t_cw - t_ci)

        gyro, accel, imu_dts, imu_mask = make_imu(imu_pose, timestamps)
        imu = dict(gyro=gyro, accel=accel, imu_dts=imu_dts, imu_mask=imu_mask,
                   gravity_w=np.float32([0.0, 9.81, 0.0]))
    stack = torch.stack if device_render else np.stack
    return SyntheticSequence(left=stack(lefts), right=stack(rights), R_lw=np.stack(Rs),
                             t_lw=np.stack(ts), timestamps=timestamps, rig=rig_raw, **imu)
