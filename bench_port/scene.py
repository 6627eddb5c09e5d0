"""The traffic's scenes, trajectories, renderer and IMU: a frozen copy of the
parts of ``zenslam_tpu_torch/io/synthetic.py`` that the benchmark needs
(``make_corridor_world``, ``make_room_world``, ``_render_view_device``,
``make_sequence``'s 'arc' and 'orbit' poses, ``make_imu``), in plain
PyTorch and NumPy, so that a change to the program cannot change the inputs
it is measured on.

Departures from the original, each for set-up time or for a window of any
length:

- the textures are drawn on the device from a ``torch.Generator`` seeded by
  the run's seed, in one call per plane, and not by numpy on the host;
- the render is plain eager PyTorch (no captured program);
- the IMU is computed for all samples at once, by the same central
  differences, from a pose function that takes arrays of times;
- a pool of frames is played in a schedule (``schedule``): forward and
  back ('pingpong') or lap after lap ('wrap'), so that the window never
  runs out of frames; the orbit's IMU interval of pool frame 0 is the one
  that ends at the lap's seam, so the stream continues across the wrap.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

GRAVITY_W = (0.0, 9.81, 0.0)


class PlaneWorld(NamedTuple):
    """Textured planes n·X + d = 0 with in-plane texture axes (device tensors
    but ``tex_scale``)."""

    normals: torch.Tensor    # (P, 3)
    offsets: torch.Tensor    # (P,)
    origins: torch.Tensor    # (P, 3)
    u_axes: torch.Tensor     # (P, 3)
    v_axes: torch.Tensor     # (P, 3)
    textures: torch.Tensor   # (P, TH, TW)
    tex_scale: float         # texture pixels per metre


def smooth_textures(gen: torch.Generator, n: int, size: int, device,
                    octaves: int = 7, roughness: float = 0.65) -> torch.Tensor:
    """``n`` multi-octave random textures in [0, 1], float32 (n, size, size):
    ``synthetic.smooth_texture``'s sum of bilinearly upsampled normal
    octaves, all planes in one draw per octave."""
    tex = torch.zeros((n, size, size), dtype=torch.float32, device=device)
    for o in range(octaves):
        shift = max(octaves - 1 - o, 0)
        cs = max(2, size >> shift)
        coarse = torch.randn((n, cs, cs), generator=gen, device=device)
        idx = torch.linspace(0, cs - 1, size, dtype=torch.float32, device=device)
        i0 = idx.long().clamp(0, cs - 2)
        f = idx - i0
        fy, fx = f[:, None], f[None, :]
        c00 = coarse[:, i0][:, :, i0]
        c01 = coarse[:, i0][:, :, i0 + 1]
        c10 = coarse[:, i0 + 1][:, :, i0]
        c11 = coarse[:, i0 + 1][:, :, i0 + 1]
        up = (c00 * (1 - fy) * (1 - fx) + c01 * (1 - fy) * fx
              + c10 * fy * (1 - fx) + c11 * fy * fx)
        tex += up * (roughness ** (octaves - 1 - o))
    lo = tex.amin(dim=(1, 2), keepdim=True)
    tex -= lo
    hi = tex.amax(dim=(1, 2), keepdim=True).clamp(min=1e-6)
    return tex / hi


def _world(gen, device, normals, points, u_axes, v_axes, tex_size: int) -> PlaneWorld:
    f32 = torch.float32
    n = torch.tensor(normals, dtype=f32, device=device)
    p = torch.tensor(points, dtype=f32, device=device)
    return PlaneWorld(n, -(n * p).sum(-1), p, torch.tensor(u_axes, dtype=f32, device=device),
                      torch.tensor(v_axes, dtype=f32, device=device),
                      smooth_textures(gen, len(normals), tex_size, device), 96.0)


def corridor_world(gen, device, tex_size: int = 1024) -> PlaneWorld:
    """End wall (z = 6), floor (y = +1.5) and ceiling (y = -1.2)."""
    return _world(gen, device, [[0, 0, 1.0], [0, 1.0, 0], [0, 1.0, 0]],
                  [[0, 0, 6.0], [0, 1.5, 0], [0, -1.2, 0]],
                  [[1, 0, 0], [1, 0, 0], [1, 0, 0]], [[0, 1, 0], [0, 0, 1], [0, 0, 1]],
                  tex_size)


def room_world(gen, device, tex_size: int = 1024, half: float = 3.0) -> PlaneWorld:
    """A closed room: walls x = ±half and z = ±half, floor y = +1.5, ceiling
    y = -1.2."""
    return _world(gen, device,
                  [[1.0, 0, 0], [1.0, 0, 0], [0, 0, 1.0], [0, 0, 1.0], [0, 1.0, 0],
                   [0, 1.0, 0]],
                  [[half, 0, 0], [-half, 0, 0], [0, 0, half], [0, 0, -half], [0, 1.5, 0],
                   [0, -1.2, 0]],
                  [[0, 0, 1], [0, 0, 1], [1, 0, 0], [1, 0, 0], [1, 0, 0], [1, 0, 0]],
                  [[0, 1, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1]],
                  tex_size)


WORLDS = {"corridor": corridor_world, "room": room_world}


def render_view(world: PlaneWorld, intr, R_cw: torch.Tensor, t_cw: torch.Tensor,
                height: int, width: int) -> torch.Tensor:
    """Ray-plane render of one pinhole view with bilinear texture lookup,
    float32 (H, W) in [0, 1]; ``intr`` = (fx, fy, cx, cy)."""
    fx, fy, cx, cy = intr
    dev = R_cw.device
    f32 = torch.float32
    R_wc = R_cw.T
    c = -R_wc @ t_cw
    v, u = torch.meshgrid(torch.arange(height, dtype=f32, device=dev),
                          torch.arange(width, dtype=f32, device=dev), indexing="ij")
    rays_w = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1) @ R_wc.T
    img = torch.zeros((height, width), dtype=f32, device=dev)
    depth = torch.full((height, width), float("inf"), dtype=f32, device=dev)
    TH, TW = world.textures.shape[1:]
    for p in range(world.normals.shape[0]):
        n = world.normals[p]
        denom = rays_w @ n
        denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
        tval = -(c @ n + world.offsets[p]) / denom
        rel = c + tval[..., None] * rays_w - world.origins[p]
        tui = torch.remainder((rel @ world.u_axes[p]) * world.tex_scale, TW - 1)
        tvi = torch.remainder((rel @ world.v_axes[p]) * world.tex_scale, TH - 1)
        x0, y0 = tui.long(), tvi.long()
        fxw, fyw = tui - x0, tvi - y0
        x1, y1 = (x0 + 1).clamp(max=TW - 1), (y0 + 1).clamp(max=TH - 1)
        tex = world.textures[p]
        val = (tex[y0, x0] * (1 - fxw) * (1 - fyw) + tex[y0, x1] * fxw * (1 - fyw)
               + tex[y1, x0] * (1 - fxw) * fyw + tex[y1, x1] * fxw * fyw)
        closer = (tval > 0.1) & (tval < depth)
        img = torch.where(closer, val, img)
        depth = torch.where(closer, tval, depth)
    return img


def so3_exp(w: np.ndarray) -> np.ndarray:
    """Axis-angle vectors (..., 3) -> rotation matrices (..., 3, 3), float64."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    k = w / np.maximum(th[..., 0], 1e-300)
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
    return np.where(th < 1e-12, np.eye(3), R)


def so3_log(R: np.ndarray) -> np.ndarray:
    """Rotation matrices (..., 3, 3) -> axis-angle vectors (..., 3), float64."""
    c = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(c)
    w = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], -1)
    s = 2.0 * np.sin(th)
    scale = np.where(th < 1e-8, 0.5, th / np.where(th < 1e-8, 1.0, s))
    return scale[..., None] * w


def pose_fn(traffic: dict):
    """The traffic's trajectory: times (T,) in seconds -> (R_cw (T, 3, 3),
    t_cw (T, 3)), world -> left camera, float64. 'arc': yaw 0.2 rad/s,
    centre (s, 0.02 sin(0.5 t/dt), 0.3 s) with s = speed t; 'orbit': one
    turn of ``orbit_radius`` per pool (``pool_frames``), looking out."""
    dt = traffic["dt"]
    if traffic["motion"] == "arc":
        speed = traffic["speed"]

        def poses(t):
            t = np.asarray(t, np.float64)
            R_wc = so3_exp(np.stack([0 * t, 0.2 * t, 0 * t], -1))
            s = t * speed
            c_w = np.stack([s, 0.02 * np.sin(0.5 * (t / dt)), 0.3 * s], -1)
            R_cw = np.swapaxes(R_wc, -1, -2)
            return R_cw, -(R_cw @ c_w[..., None])[..., 0]
    elif traffic["motion"] == "orbit":
        radius, period = traffic["orbit_radius"], traffic["pool_frames"] * dt

        def poses(t):
            th = 2.0 * np.pi * np.asarray(t, np.float64) / period
            c_w = radius * np.stack([np.sin(th), 0 * th, np.cos(th)], -1)
            R_cw = np.swapaxes(so3_exp(np.stack([0 * th, th, 0 * th], -1)), -1, -2)
            return R_cw, -(R_cw @ c_w[..., None])[..., 0]
    else:
        raise ValueError(f"unknown motion {traffic['motion']!r} (arc, orbit)")
    return poses


def imu_samples(poses, t_end: np.ndarray, dt: float, samples: int, gravity_w=GRAVITY_W):
    """Body-frame IMU (body = left camera) of the interval (t - dt, t] ending
    at each time of ``t_end`` (T,): ``synthetic.make_imu``'s midpoint
    central differences. Returns gyro (T, S, 3), accel (T, S, 3) specific
    force, dts (T, S), all float32."""
    eps = 1e-4
    h = dt / samples
    tm = (t_end[:, None] - dt) + (np.arange(samples) + 0.5) * h          # (T, S)

    def body(t):
        R_cw, t_cw = poses(t)
        R_wb = np.swapaxes(R_cw, -1, -2)
        return R_wb, -(R_wb @ t_cw[..., None])[..., 0]

    R0, _ = body(tm - eps / 2)
    R1, _ = body(tm + eps / 2)
    gyro = so3_log(np.swapaxes(R0, -1, -2) @ R1) / eps
    R_wb, pm = body(tm)
    _, pa = body(tm - eps)
    _, pb = body(tm + eps)
    a_w = (pb - 2.0 * pm + pa) / (eps * eps)
    accel = (np.swapaxes(R_wb, -1, -2) @ (a_w - np.asarray(gravity_w))[..., None])[..., 0]
    dts = np.full(tm.shape, h)
    return gyro.astype(np.float32), accel.astype(np.float32), dts.astype(np.float32)


def schedule(kind: str, pool: int, frames):
    """Pool indices of a run's frames (an int or an array of them): 'wrap'
    plays the pool lap after lap (its last frame continues into its first),
    'pingpong' plays it forward, then backward, then forward again, without
    repeating an end frame."""
    i = np.asarray(frames)
    if kind == "wrap":
        return i % pool
    if kind == "pingpong":
        k = i % (2 * (pool - 1))
        return np.where(k < pool, k, 2 * (pool - 1) - k)
    raise ValueError(f"unknown schedule {kind!r} (wrap, pingpong)")


def bake_noise(gen: torch.Generator, frames: torch.Tensor, sigma: float) -> torch.Tensor:
    """Additive Gaussian pixel noise σ, clipped to [0, 1], in place."""
    if sigma > 0:
        for f in frames:
            f.add_(torch.randn(f.shape, generator=gen, device=f.device), alpha=sigma)
            f.clamp_(0.0, 1.0)
    return frames
