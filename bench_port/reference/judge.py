"""The plain reference and the comparison that decides ``correct``.

Everything here is float64 NumPy; torch only rounds to bfloat16 for the
control. Nothing here imports the program: it reads the program's outputs,
handed over as arrays (``run.py:outputs``), only to judge them. The
reference's answers are of two kinds:

- the scene's truth, from the traffic's own generator: the pose each frame
  was rendered from (``scene.pose_fn``) and the surface point each pixel
  shows (``ray_points``, the renderer's ray-plane hit), so where a keypoint
  of one image lies in the other image of the pair and in the next frame;
- the program's arithmetic done again in float64, from the program's own
  state where nothing else can give the input (the map a frame's pose is
  solved against, the keyframes a BA starts from): the landmarks a frame
  creates (the stereo DLT, carried to the world by the frame's pose), the
  frame's pose (the PnP polish run to convergence), and the windowed BA
  (``pipeline/system.py:_windowed_ba_body`` with ``backend/ba.py``'s
  LM-Schur loop, the same iterations, from the same input).

The numbers compared:

- ``stereo_px``: each stereo match against the truth's right-image point
  (median over a sampled frame's matches, then over the sampled frames);
- ``track_px``: each keypoint tracked from frame f-1 against where the
  truth puts its surface point in frame f (medians likewise);
- ``tri_rel``: each landmark the step created at a sampled frame against
  the DLT of its match and the frame's pose, relative to its depth
  (medians likewise);
- ``pose_q1_px``: the frame's pose (its telemetry) against the pose the
  step's PnP polish converges to in float64 (Huber 2 px, the frame's
  correspondences with older landmarks, over all of them as from the
  motion prior or over those within 3 px as from the RANSAC winner: the
  nearer), as the RMS image displacement of those landmarks between the
  two poses; the lower quartile over the sampled frames whose pose came
  from left-camera PnP. Not the median: the winner's inliers are decided
  at its random 6-point pose, and where many correspondences lie near the
  3 px threshold the mask within 3 px of the final pose is not the
  winner's, so the gap reads 0.1-1 px on a sound frame (``PERF.md``);
- ``ba_px``: each judged windowed BA's output (the window's keyframe poses
  and the landmarks it refined) against the reference BA from the same
  input, as the RMS image displacement of the window's observations
  between the two; the median over the judged BA calls;
- ``kf_pose``: the largest difference, over the judged BA calls, between
  the newest keyframe's pose as inserted and its frame's telemetry pose
  (the keyframe insert stores the step's pose: an exact comparison).

A cell's limits file names the numbers it compares (``PERF.md`` gives the
readings each limit was set from). The control (``control_outputs``) puts
the reference's own answers, held in bfloat16, in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

NUMBERS = ("stereo_px", "track_px", "tri_rel", "pose_q1_px", "ba_px", "kf_pose")


def bf16(x):
    """``x`` held in bfloat16 (round to nearest), back as float64."""
    return torch.as_tensor(np.asarray(x, np.float64)).to(torch.bfloat16).double().numpy()


def ray_points(xy, R_cw, t_cw, intr, normals, offsets):
    """World points that pixels ``xy`` (N, 2) show from pose (R_cw, t_cw):
    the nearest plane n·X + d = 0 hit beyond 0.1 along each ray."""
    fx, fy, cx, cy = intr
    rays_c = np.stack([(xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy, np.ones(len(xy))], -1)
    R_wc = R_cw.T
    c = -R_wc @ t_cw
    rays = rays_c @ R_wc.T
    denom = rays @ normals.T
    denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
    tval = -(c @ normals.T + offsets) / denom
    tval = np.where(tval > 0.1, tval, np.inf).min(-1)
    return c + tval[:, None] * rays


def project(X, R_cw, t_cw, intr, shift=0.0):
    """Pixels of world points ``X`` (N, 3) in the camera (R_cw, t_cw), moved
    ``shift`` m along its x axis first (the right camera: -baseline)."""
    fx, fy, cx, cy = intr
    Xc = X @ R_cw.T + t_cw
    Xc[:, 0] += shift
    z = np.where(np.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
    return np.stack([fx * Xc[:, 0] / z + cx, fy * Xc[:, 1] / z + cy], -1)


def dlt(xy, uv_r, intr, baseline):
    """Two-view DLT in the left camera's frame (rows normalised, the smallest
    right singular vector), as the step triangulates its stereo matches."""
    fx, fy, cx, cy = intr
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    P0 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P1 = K @ np.hstack([np.eye(3), np.array([[-baseline], [0.0], [0.0]])])
    A = np.stack([xy[:, :1] * P0[2] - P0[0], xy[:, 1:2] * P0[2] - P0[1],
                  uv_r[:, :1] * P1[2] - P1[0], uv_r[:, 1:2] * P1[2] - P1[1]], 1)
    A = A / (np.linalg.norm(A, axis=-1, keepdims=True) + 1e-12)
    X = np.linalg.svd(A)[2][:, -1]
    return X[:, :3] / X[:, 3:]


def so3_hat(v):
    z = np.zeros(len(v))
    return np.stack([np.stack([z, -v[:, 2], v[:, 1]], -1), np.stack([v[:, 2], z, -v[:, 0]], -1),
                     np.stack([-v[:, 1], v[:, 0], z], -1)], 1)


def so3_exp(w):
    """Rotation matrices of rotation vectors ``w`` (..., 3) (Rodrigues)."""
    w = np.asarray(w, np.float64)
    flat = w.reshape(-1, 3)
    th = np.linalg.norm(flat, axis=1)[:, None, None]
    K = so3_hat(flat)
    small = th < 1e-8
    a = np.where(small, 1.0 - th ** 2 / 6.0, np.sin(th) / np.where(small, 1.0, th))
    b = np.where(small, 0.5 - th ** 2 / 24.0, (1.0 - np.cos(th)) / np.where(small, 1.0, th ** 2))
    R = np.eye(3) + a * K + b * (K @ K)
    return R.reshape(w.shape[:-1] + (3, 3))


def _proj_jac(Xc, fx, fy):
    """Pixels of camera-frame points (n, 3) and their (n, 2, 3) Jacobians."""
    z = np.where(np.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
    uv = np.stack([fx * Xc[:, 0] / z, fy * Xc[:, 1] / z], -1)
    J = np.zeros((len(Xc), 2, 3))
    J[:, 0, 0] = fx / z
    J[:, 0, 2] = -fx * Xc[:, 0] / z ** 2
    J[:, 1, 1] = fy / z
    J[:, 1, 2] = -fy * Xc[:, 1] / z ** 2
    return uv, J


def huber_w(rn, delta):
    return np.where(rn <= delta, 1.0, delta / np.maximum(rn, 1e-12))


def pnp_converged(X, uv, R, t, intr, mask, delta: float = 2.0, damping: float = 1e-4,
                  iters: int = 100, tol: float = 1e-13):
    """The PnP polish of ``estimation/pnp.py:refine_pnp_gn`` (damped
    Gauss-Newton on a left se(3) increment, Huber ``delta``, over the
    points of ``mask``) run from (R, t) until its step vanishes."""
    fx, fy, cx, cy = intr
    for _ in range(iters):
        xc = X @ R.T + t
        uvp, Jp = _proj_jac(xc, fx, fy)
        r = uvp + np.array([cx, cy]) - uv
        w = mask * huber_w(np.linalg.norm(r, axis=1), delta)
        J = Jp @ np.concatenate([np.broadcast_to(np.eye(3), (len(xc), 3, 3)), -so3_hat(xc)], 2)
        H = np.einsum("nij,nik,n->jk", J, J, w) + damping * np.eye(6)
        dx = np.linalg.solve(H, -np.einsum("nij,ni,n->j", J, r, w))
        E = so3_exp(dx[3:])
        R, t = E @ R, E @ t + dx[:3]
        if np.linalg.norm(dx) < tol:
            break
    return R, t


def displacement_px(X, R1, t1, R2, t2, intr):
    """RMS distance between the pixels of points ``X`` in two poses (points
    in front of both)."""
    a, b = X @ R1.T + t1, X @ R2.T + t2
    ok = (a[:, 2] > 1e-3) & (b[:, 2] > 1e-3)
    if not ok.any():
        return None
    d = project(X[ok], R1, t1, intr) - project(X[ok], R2, t2, intr)
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def _med(values) -> float:
    values = [v for v in values if v is not None]
    return float(np.median(values)) if values else float("inf")


def _q1(values) -> float:
    values = [v for v in values if v is not None]
    return float(np.percentile(values, 25)) if values else float("inf")


def _pairs(out: dict) -> list:
    snaps = out["snaps"]
    return [(f - 1, f) for f in sorted(snaps) if f - 1 in snaps]


def _stereo(s, truth, f):
    """(left pixels, matches) of the frame's valid stereo matches and the
    truth's right-image points of the left pixels."""
    m = s["valid"] & s["stereo_ok"]
    xy = s["xy"][m].astype(np.float64)
    R, t = truth["world_pose"](f)
    X = truth["surface_w"](xy, R, t)
    return (xy, s.get("uv_r_judged", s["uv_r"])[m].astype(np.float64),
            project(X, R, t, truth["intr"], -truth["baseline"]))


def _tracks(a, b, truth, fa, fb):
    """(pixels in frame fb, the truth's pixels) of the keypoints tracked
    from frame fa (same track id, valid in both)."""
    ida = {int(k): i for i, k in enumerate(a["track_id"]) if a["valid"][i]}
    rows = [(ida[int(k)], j) for j, k in enumerate(b["track_id"])
            if b["valid"][j] and int(k) in ida]
    if not rows:
        return np.zeros((0, 2)), np.zeros((0, 2))
    ia, jb = map(np.array, zip(*rows))
    Ra, ta = truth["world_pose"](fa)
    Rb, tb = truth["world_pose"](fb)
    X = truth["surface_w"](a["xy"][ia].astype(np.float64), Ra, ta)
    return (b.get("xy_judged", b["xy"])[jb].astype(np.float64),
            project(X, Rb, tb, truth["intr"]))


def _created(a, b):
    """Rows of frame b's keypoints whose landmark the step created at b (a
    slot that was free, or of another generation, at frame a)."""
    lm = b["lm_idx"].astype(np.int64)
    ok = b["valid"] & (lm >= 0)
    s = np.clip(lm, 0, None)
    fresh = (~a["lm_valid"][s]) | (a["lm_gen"][s] != b["lm_gen"][s])
    return np.flatnonzero(ok & fresh & b["lm_valid"][s])


def _pnp_rows(a, b):
    """Rows of frame b's keypoints that its PnP used: tracked (age > 0) and
    attached to a landmark that was in the map before the step (valid at
    frame a, same generation)."""
    lm = b["lm_idx"].astype(np.int64)
    s = np.clip(lm, 0, None)
    ok = (b["valid"] & (lm >= 0) & (b["age"] > 0) & a["lm_valid"][s]
          & (a["lm_gen"][s] == b["lm_gen"][s]))
    return np.flatnonzero(ok)


def frame_pose(out: dict, f: int):
    """(R, t) of frame f as the step produced it (its telemetry), or None."""
    tel = out["tels"].get(f)
    return None if tel is None else (tel["R"].astype(np.float64), tel["t"].astype(np.float64))


def pnp_reference(out: dict, fa: int, fb: int, intr, pose=None):
    """The frame-fb PnP problem (the map before its step, its tracked
    correspondences) and the converged poses from ``pose`` (default: the
    program's) under the two masks; None where it is not a left-camera
    PnP pose or has fewer than 6 points."""
    tel = out["tels"].get(fb)
    if tel is None or int(tel["method"]) != 0 or not tel["ok"]:
        return None
    sa, sb = out["snaps"][fa], out["snaps"][fb]
    rows = _pnp_rows(sa, sb)
    if len(rows) < 6:
        return None
    X = sa["lm_xyz"][sb["lm_idx"][rows].astype(np.int64)].astype(np.float64)
    uv = sb["xy"][rows].astype(np.float64)
    R, t = frame_pose(out, fb) if pose is None else pose
    err = np.linalg.norm(project(X, R, t, intr) - uv, axis=1)
    # a mask of fewer than 6 points holds any pose still: no candidate
    masks = [m for m in (np.ones(len(X)), (err < 3.0).astype(np.float64)) if m.sum() >= 6]
    return X, R, t, [pnp_converged(X, uv, R, t, intr, m) for m in masks]


def ba_reference(rec: dict, intr, baseline: float, huber: float = 1.0,
                 init_lambda: float = 1e-3) -> dict:
    """The windowed BA of ``pipeline/system.py:_windowed_ba_body`` in
    float64 from one call's input ``rec["in"]``: the ``W`` newest keyframes
    (the oldest of them fixed), their left observations and the right ones
    of their stereo matches of live landmarks of the same generation, the
    referenced landmarks (at most 4N, in slot order), then ``iterations``
    steps of ``backend/ba.py:lm_schur`` (Huber 1 px, damping from 1e-3,
    halved on a step that lowers the cost and quadrupled on one that does
    not, dense Schur on the reduced camera system). Returns the slots, the
    landmark rows, the observations (keyframe, landmark, pixel, right
    camera) and the output poses and landmarks."""
    if rec["solver"] != "dense":
        raise ValueError(f"the reference BA is the dense solver's, not {rec['solver']!r}")
    d = rec["in"]
    W, iters = int(rec["W"]), int(rec["iterations"])
    fi = d["frame_idx"].astype(np.int64)
    slots = np.argsort(-fi, kind="stable")[:W]
    kf_valid = d["valid"][slots]
    K = len(slots)
    N = d["kp_lm"].shape[1]
    lm_all = d["kp_lm"][slots].astype(np.int64)
    M = d["lm_xyz"].shape[0]
    has = d["kp_valid"][slots] & (lm_all >= 0) & kf_valid[:, None]
    has &= d["lm_gen"][np.clip(lm_all, 0, None)] == d["kp_lm_gen"][slots]
    observed = np.zeros(M, bool)
    observed[lm_all[has]] = True
    ref = observed & d["lm_valid"]
    sel = np.concatenate([np.flatnonzero(ref), np.flatnonzero(~ref)])[:min(M, 4 * N)]
    inv = np.full(M, -1, np.int64)
    inv[sel] = np.arange(len(sel))
    k_l, n_l = np.nonzero(has)
    right = d["kp_stereo"][slots][k_l, n_l]
    ok_kf = np.concatenate([k_l, k_l[right]])
    ok_n = np.concatenate([n_l, n_l[right]])
    cam = np.concatenate([np.zeros(len(k_l), bool), np.ones(int(right.sum()), bool)])
    lm_c = inv[lm_all[ok_kf, ok_n]]
    keep = lm_c >= 0
    ok_kf, ok_n, cam, lm_c = ok_kf[keep], ok_n[keep], cam[keep], lm_c[keep]
    uv = np.where(cam[:, None], d["kp_uvr"][slots][ok_kf, ok_n],
                  d["kp_xy"][slots][ok_kf, ok_n]).astype(np.float64)
    lm_active = ref[sel]
    oldest = np.argmin(np.where(kf_valid, fi[slots], 2 ** 30)) if kf_valid.any() else -1
    free = kf_valid & (np.arange(K) != oldest)
    R = d["R"][slots].astype(np.float64)
    t = d["t"][slots].astype(np.float64)
    xyz = d["lm_xyz"][sel].astype(np.float64)
    fx, fy, cx, cy = intr
    shift = np.where(cam, -baseline, 0.0)
    Mb = len(sel)

    def residuals(R, t, xyz):
        xc0 = np.einsum("oij,oj->oi", R[ok_kf], xyz[lm_c]) + t[ok_kf]
        xc = xc0 + np.stack([shift, np.zeros_like(shift), np.zeros_like(shift)], -1)
        z = xc[:, 2]
        good = z > 1e-3
        zs = np.where(np.abs(z) < 1e-3, 1e-3, z)
        r = np.stack([fx * xc[:, 0] / zs + cx - uv[:, 0], fy * xc[:, 1] / zs + cy - uv[:, 1]],
                     -1)
        return r, good, xc0, xc, zs

    def cost(R, t, xyz):
        r, good, *_ = residuals(R, t, xyz)
        r2 = np.sum(r * r, 1)
        rn = np.sqrt(np.maximum(r2, 1e-18))
        rho = np.where(rn <= huber, 0.5 * r2, huber * (rn - 0.5 * huber))
        return float(np.sum(np.where(good, rho, 0.0)))

    c = cost(R, t, xyz)
    lam = init_lambda
    eye3 = np.eye(3)
    for _ in range(iters):
        r, good, xc0, xc, zs = residuals(R, t, xyz)
        w = np.where(good, huber_w(np.linalg.norm(r, axis=1), huber), 0.0)
        Jproj = np.zeros((len(r), 2, 3))
        Jproj[:, 0, 0] = fx / zs
        Jproj[:, 0, 2] = -fx * xc[:, 0] / zs ** 2
        Jproj[:, 1, 1] = fy / zs
        Jproj[:, 1, 2] = -fy * xc[:, 1] / zs ** 2
        Jp = Jproj @ np.concatenate([np.broadcast_to(eye3, (len(r), 3, 3)), -so3_hat(xc0)], 2)
        Jl = Jproj @ R[ok_kf]
        U = np.zeros((K, 6, 6))
        g_p = np.zeros((K, 6))
        V = np.zeros((Mb, 3, 3))
        g_l = np.zeros((Mb, 3))
        A = np.zeros((Mb, K, 6, 3))
        np.add.at(U, ok_kf, np.einsum("oai,oaj,o->oij", Jp, Jp, w))
        np.add.at(g_p, ok_kf, -np.einsum("oai,oa,o->oi", Jp, r, w))
        np.add.at(V, lm_c, np.einsum("oai,oaj,o->oij", Jl, Jl, w))
        np.add.at(g_l, lm_c, -np.einsum("oai,oa,o->oi", Jl, r, w))
        np.add.at(A, (lm_c, ok_kf), np.einsum("oai,oaj,o->oij", Jp, Jl, w))
        Vinv = np.linalg.inv(np.where(lm_active[:, None, None], V + lam * eye3, eye3))
        Ar = A.reshape(Mb, 6 * K, 3)
        B = Ar @ Vinv                                   # (M, 6K, 3)
        S = np.zeros((K, 6, K, 6))
        S[np.arange(K), :, np.arange(K), :] = U + lam * np.eye(6)
        S = S.reshape(6 * K, 6 * K) - np.tensordot(B, Ar, axes=([0, 2], [0, 2]))
        rhs = g_p.reshape(6 * K) - np.einsum("mac,mc->a", B, g_l)
        m6 = np.repeat(free, 6).astype(np.float64)
        S = S * m6[:, None] * m6[None, :] + np.diag(1.0 - m6)
        S = 0.5 * (S + S.T) + 1e-8 * np.eye(6 * K)
        try:
            dp = np.linalg.solve(S, rhs * m6).reshape(K, 6) * free[:, None]
        except np.linalg.LinAlgError:
            dp = np.zeros((K, 6))
        dl = np.einsum("mbc,mc->mb", Vinv, g_l - np.einsum("mab,a->mb", Ar, dp.reshape(-1)))
        dl *= lm_active[:, None]
        dR = so3_exp(dp[:, 3:])
        R1, t1, x1 = dR @ R, np.einsum("kij,kj->ki", dR, t) + dp[:, :3], xyz + dl
        c1 = cost(R1, t1, x1)
        if c1 < c:
            R, t, xyz, c, lam = R1, t1, x1, c1, max(lam * 0.5, 1e-9)
        else:
            lam = min(lam * 4.0, 1e3)
    return {"slots": slots, "sel": sel, "lm_active": lm_active, "obs_kf": ok_kf,
            "obs_lm": lm_c, "obs_right": cam, "R": R, "t": t, "xyz": xyz}


def ba_gap_px(rec: dict, ref: dict, intr, baseline: float, out=None):
    """RMS image displacement, over the window's observations in front of
    both, between the BA output ``out`` (default: the program's,
    ``rec["out"]``) and the reference's."""
    o = rec["out"] if out is None else out
    Rp, tp = o["R"][ref["slots"]].astype(np.float64), o["t"][ref["slots"]].astype(np.float64)
    xp = np.where(ref["lm_active"][:, None], o["lm_xyz"][ref["sel"]].astype(np.float64),
                  ref["xyz"])
    k, m = ref["obs_kf"], ref["obs_lm"]
    if not len(k):
        return None
    shift = np.where(ref["obs_right"], -baseline, 0.0)[:, None] * np.array([1.0, 0.0, 0.0])
    a = np.einsum("oij,oj->oi", Rp[k], xp[m]) + tp[k] + shift
    b = np.einsum("oij,oj->oi", ref["R"][k], ref["xyz"][m]) + ref["t"][k] + shift
    ok = (a[:, 2] > 1e-3) & (b[:, 2] > 1e-3)
    if not ok.any():
        return None
    fx, fy = intr[0], intr[1]
    da = np.stack([fx * (a[ok, 0] / a[ok, 2] - b[ok, 0] / b[ok, 2]),
                   fy * (a[ok, 1] / a[ok, 2] - b[ok, 1] / b[ok, 2])], -1)
    return float(np.sqrt(np.mean(np.sum(da * da, axis=1))))


def _newest_kf(rec: dict):
    """(slot, frame) of the newest keyframe in a BA call's input."""
    d = rec["in"]
    fi = np.where(d["valid"], d["frame_idx"].astype(np.int64), -1)
    s = int(np.argmax(fi))
    return s, int(fi[s])


def kf_pose_gap(out: dict, rec: dict, pose=None):
    """Largest |difference| between the newest keyframe's inserted pose and
    its frame's telemetry pose; None without that telemetry."""
    s, f = _newest_kf(rec)
    tel = frame_pose(out, f)
    if tel is None:
        return None
    R, t = (rec["in"]["R"][s], rec["in"]["t"][s]) if pose is None else pose
    return float(max(np.abs(np.asarray(R, np.float64) - tel[0]).max(),
                     np.abs(np.asarray(t, np.float64) - tel[1]).max()))


def readings(out: dict, truth: dict) -> dict:
    """The numbers compared, from a run's outputs ``out`` (``run.outputs``)
    against the reference (``make_truth``)."""
    intr, b = truth["intr"], truth["baseline"]
    stereo, track, tri, pose = [], [], [], []
    for fa, fb in _pairs(out):
        sa, sb = out["snaps"][fa], out["snaps"][fb]
        xy, uv, uv_true = _stereo(sb, truth, fb)
        stereo.append(np.median(np.linalg.norm(uv - uv_true, axis=1)) if len(xy) else None)
        got, want = _tracks(sa, sb, truth, fa, fb)
        track.append(np.median(np.linalg.norm(got - want, axis=1)) if len(got) else None)
        R, t = frame_pose(out, fb) or (sb["R"].astype(np.float64), sb["t"].astype(np.float64))
        new = _created(sa, sb)
        if len(new):
            Xc = dlt(sb["xy"][new].astype(np.float64), sb["uv_r"][new].astype(np.float64),
                     intr, b)
            ref = (Xc - t) @ R
            prog = sb["lm_xyz"][sb["lm_idx"][new].astype(np.int64)].astype(np.float64)
            good = np.isfinite(ref).all(1) & (Xc[:, 2] > 0)
            if good.any():
                tri.append(np.median(np.linalg.norm(prog - ref, axis=1)[good] / Xc[good, 2]))
        pnp = pnp_reference(out, fa, fb, intr, out.get("pose_judged", {}).get(fb))
        if pnp is not None:
            X, Rp, tp, conv = pnp
            gaps = [displacement_px(X, Rp, tp, Rc, tc, intr) for Rc, tc in conv]
            gaps = [g for g in gaps if g is not None]
            pose.append(min(gaps) if gaps else None)
    ba, kf = [], []
    for i, rec in enumerate(out["ba"]):
        ref = ba_reference(rec, intr, b)
        ba.append(ba_gap_px(rec, ref, intr, b, out.get("ba_judged", {}).get(i)))
        kf.append(kf_pose_gap(out, rec, out.get("kf_judged", {}).get(i)))
    kf = [v for v in kf if v is not None]
    return {"stereo_px": _med(stereo), "track_px": _med(track), "tri_rel": _med(tri),
            "pose_q1_px": _q1(pose), "ba_px": _med(ba),
            "kf_pose": max(kf) if kf else float("inf")}


def control_outputs(out: dict, truth: dict) -> dict:
    """The control: ``out`` with every answer that is judged replaced by the
    reference's own, held in bfloat16: the truth's stereo matches and
    tracked positions, the DLT of the created landmarks, the converged PnP
    pose, the reference BA's output, and the inserted keyframe's pose."""
    ctl = dict(out)
    ctl["snaps"] = {f: dict(s) for f, s in out["snaps"].items()}
    ctl["pose_judged"] = {}
    intr, b = truth["intr"], truth["baseline"]
    for fa, fb in _pairs(out):
        sa, sb = out["snaps"][fa], ctl["snaps"][fb]
        m = sb["valid"] & sb["stereo_ok"]
        uv_r = sb["uv_r"].astype(np.float64).copy()
        uv_r[m] = bf16(_stereo(sb, truth, fb)[2])
        xy = sb["xy"].astype(np.float64).copy()
        _, want = _tracks(sa, sb, truth, fa, fb)
        ida = {int(k) for i, k in enumerate(sa["track_id"]) if sa["valid"][i]}
        rows = [j for j, k in enumerate(sb["track_id"]) if sb["valid"][j] and int(k) in ida]
        xy[rows] = bf16(want)
        R, t = frame_pose(out, fb) or (sb["R"].astype(np.float64), sb["t"].astype(np.float64))
        lm_xyz = sb["lm_xyz"].astype(np.float64).copy()
        new = _created(sa, sb)
        if len(new):
            Xc = dlt(sb["xy"][new].astype(np.float64), sb["uv_r"][new].astype(np.float64),
                     intr, b)
            lm_xyz[sb["lm_idx"][new].astype(np.int64)] = bf16((Xc - t) @ R)
        pnp = pnp_reference(out, fa, fb, intr)
        if pnp is not None:
            Rc, tc = pnp[3][-1]
            ctl["pose_judged"][fb] = (bf16(Rc), bf16(tc))
        # the matches judged are the truth's, held; the landmarks and the pose
        # are judged on the program's matches, as the program's are
        ctl["snaps"][fb] = dict(sb, uv_r_judged=uv_r, xy_judged=xy, lm_xyz=lm_xyz)
    ctl["ba_judged"], ctl["kf_judged"] = {}, {}
    for i, rec in enumerate(out["ba"]):
        ref = ba_reference(rec, intr, b)
        R = rec["out"]["R"].astype(np.float64).copy()
        t = rec["out"]["t"].astype(np.float64).copy()
        x = rec["out"]["lm_xyz"].astype(np.float64).copy()
        R[ref["slots"]], t[ref["slots"]] = bf16(ref["R"]), bf16(ref["t"])
        x[ref["sel"]] = bf16(ref["xyz"])
        ctl["ba_judged"][i] = {"R": R, "t": t, "lm_xyz": x}
        s, f = _newest_kf(rec)
        tel = frame_pose(out, f)
        if tel is not None:
            ctl["kf_judged"][i] = (bf16(tel[0]), bf16(tel[1]))
    return ctl


def make_truth(pool_R, pool_t, index, intr, baseline: float, normals, offsets) -> dict:
    """The reference's answers for a run, in the scene's world.
    ``index(frames)`` maps run frames to pool rows; ``world_pose(f)`` is
    the pose frame f was rendered from, ``surface_w(xy, R, t)`` the surface
    points pixels show from a pose."""
    pool_R, pool_t = np.asarray(pool_R, np.float64), np.asarray(pool_t, np.float64)

    def world_pose(f):
        i = int(index(np.asarray([f]))[0])
        return pool_R[i], pool_t[i]

    def surface_w(xy, R, t):
        return ray_points(xy, R, t, intr, normals, offsets)

    return {"world_pose": world_pose, "surface_w": surface_w,
            "intr": tuple(float(v) for v in intr), "baseline": float(baseline)}


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number that ``limits``
    names finite and at or under its limit."""
    unknown = set(limits) - set(NUMBERS)
    if unknown:
        raise ValueError(f"limits for numbers the reference does not read: {sorted(unknown)}")
    checks = {k: {"value": float(values[k]), "limit": float(limits[k])}
              for k in NUMBERS if k in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
