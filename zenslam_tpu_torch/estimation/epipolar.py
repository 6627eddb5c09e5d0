"""The 8-point algorithm, fundamental and essential RANSAC, pose recovery
and metric scale from prior landmarks — counterpart of
``zenslam_tpu/estimation/epipolar.py``. RANSAC draws are an input (``noise``,
Gumbel), as in ``estimation/ransac.py``."""

from __future__ import annotations

import functools
import math

import torch

from zenslam_tpu_torch.estimation.pnp import normalize_pixels
from zenslam_tpu_torch.estimation.ransac import (
    best_hypothesis, gather_rows, gumbel, ransac_sample_indices, take)
from zenslam_tpu_torch.geometry.polar import inv_spd, project_rank2, smallest_eigvec_3
from zenslam_tpu_torch.geometry.triangulate import triangulate_dlt
from zenslam_tpu_torch.utils.device import upload_constant
from zenslam_tpu_torch.utils.graphs import Program


def _hartley_normalize(pts, w):
    """Similarity T (..., 3, 3) giving zero mean and sqrt(2) mean radius."""
    wsum = torch.clamp(w.sum(-1), min=1e-12)
    mu = (pts * w[..., None]).sum(-2) / wsum[..., None]
    d = torch.sqrt(((pts - mu[..., None, :]) ** 2).sum(-1))
    mean_d = (d * w).sum(-1) / wsum
    s = math.sqrt(2.0) / torch.clamp(mean_d, min=1e-12)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    return torch.stack([
        torch.stack([s, zero, -s * mu[..., 0]], -1),
        torch.stack([zero, s, -s * mu[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], dim=-2)


def _smallest_eigvec_9(ATA, iters: int = 6):
    tr = torch.diagonal(ATA, dim1=-2, dim2=-1).sum(-1)
    scale = torch.clamp(tr / 9.0, min=1e-20)[..., None, None]
    A = ATA / scale + 1e-5 * torch.eye(9, dtype=ATA.dtype, device=ATA.device)
    Ainv = inv_spd(A)
    v = torch.full(ATA.shape[:-1], 1.0 / 3.0, dtype=ATA.dtype, device=ATA.device)
    for _ in range(iters):
        z = (Ainv @ v[..., None])[..., 0]
        v = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True), min=1e-30)
    return v


def _eight_point(pa, pb, w=None):
    """8-point algorithm, batched: (..., n, 2) pairs -> rank-2 F, unit norm."""
    if w is None:
        w = torch.ones(pa.shape[:-1], dtype=pa.dtype, device=pa.device)
    Ta = _hartley_normalize(pa, w)
    Tb = _hartley_normalize(pb, w)
    ones = torch.ones_like(pa[..., :1])
    qa = torch.cat([pa, ones], -1) @ Ta.transpose(-1, -2)
    qb = torch.cat([pb, ones], -1) @ Tb.transpose(-1, -2)
    A = torch.stack([
        qb[..., 0] * qa[..., 0], qb[..., 0] * qa[..., 1], qb[..., 0],
        qb[..., 1] * qa[..., 0], qb[..., 1] * qa[..., 1], qb[..., 1],
        qa[..., 0], qa[..., 1], torch.ones_like(qa[..., 0]),
    ], dim=-1) * w[..., None]
    ATA = A.transpose(-1, -2) @ A
    F = _smallest_eigvec_9(ATA)
    F = project_rank2(F.reshape(F.shape[:-1] + (3, 3)))
    F = Tb.transpose(-1, -2) @ F @ Ta
    norm = torch.sqrt((F * F).sum(dim=(-2, -1), keepdim=True))
    return F / torch.clamp(norm, min=1e-12)


def fundamental_8pt(pa, pb, w=None):
    """Fundamental matrix from pixel pairs (..., n, 2) by the normalised
    8-point algorithm: rank 2, unit Frobenius norm; ``w`` (..., n) weights."""
    return _eight_point(pa, pb, w)


def essential_8pt(na, nb, w=None):
    """8-point on NORMALISED image coordinates -> essential matrix (rank 2;
    ``recover_pose_from_essential``'s decomposition enforces the (1, 1, 0)
    spectrum)."""
    return _eight_point(na, nb, w)


def _sampson_distance(F, pa, pb):
    """First-order geometric (Sampson) distance; F (..., 3, 3) -> (..., n)."""
    ones = torch.ones_like(pa[..., :1])
    qa = torch.cat([pa, ones], -1)
    qb = torch.cat([pb, ones], -1)
    Fqa = qa @ F.transpose(-1, -2)
    Ftqb = qb @ F
    num = (qb * Fqa).sum(-1) ** 2
    den = Fqa[..., 0] ** 2 + Fqa[..., 1] ** 2 + Ftqb[..., 0] ** 2 + Ftqb[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


class _FreshDraw:
    """The generator of a call given neither noise nor a generator: torch's
    default seed on a device, seeded afresh before every run of the
    captured program (``seeded_generators``), so every call draws what a
    new ``torch.Generator`` draws."""

    def __init__(self, device):
        self.generator = torch.Generator(device=device)
        self.seed = self.generator.initial_seed()

    def seeded_generators(self) -> list:
        return [(self.generator, self.seed)]


_FRESH: dict = {}


def _fresh_draw(device) -> _FreshDraw:
    """One ``_FreshDraw`` per device (a static argument: one key)."""
    if device not in _FRESH:
        _FRESH[device] = _FreshDraw(device)
    return _FRESH[device]


@functools.partial(Program, static_argnames=("iters", "generator"),
                   static_defaults={"generator": _fresh_draw}, copy_outputs=True)
def solve_fundamental_ransac(noise, pa, pb, valid, threshold: float = 2.0, iters: int = 256,
                             generator: torch.Generator | None = None):
    """RANSAC fundamental matrix with Sampson scoring, threshold in pixels,
    refit on the inliers. ``noise`` (iters, n) Gumbel draws; when None they
    are drawn from ``generator`` (a new one, at torch's default seed, when
    that is None too).
    Returns dict(F, inliers, n_inliers, ok).
    A captured program: ``threshold`` is keyed by value."""
    if noise is None:
        if generator is None:
            generator = torch.Generator(device=pa.device)
        noise = gumbel(getattr(generator, "generator", generator), (iters, pa.shape[0]),
                       pa.device)
    thr2 = threshold * threshold
    idx = ransac_sample_indices(noise, valid, 8)
    Fs = fundamental_8pt(gather_rows(pa, idx), gather_rows(pb, idx))
    scores = ((_sampson_distance(Fs, pa, pb) < thr2) & valid).sum(-1)
    F0 = take(Fs, best_hypothesis(scores))
    inl0 = (_sampson_distance(F0, pa, pb) < thr2) & valid
    F = fundamental_8pt(pa, pb, w=inl0.to(pa.dtype))
    inl = (_sampson_distance(F, pa, pb) < thr2) & valid
    better = inl.sum() >= inl0.sum()
    F = torch.where(better, F, F0)
    inliers = torch.where(better, inl, inl0)
    n = inliers.sum()
    return {"F": F, "inliers": inliers, "n_inliers": n, "ok": n >= 8}


@functools.partial(Program, copy_outputs=True)
def solve_essential_ransac(noise, K, pa, pb, valid, threshold: float = 1.0):
    """RANSAC essential matrix on pixel inputs; noise (iters, n) Gumbel draws.
    Threshold in pixels via Sampson distance on normalised coordinates.
    A captured program: ``threshold`` is keyed by value."""
    na = normalize_pixels(K, pa)
    nb = normalize_pixels(K, pb)
    thr_n = threshold / ((K[0, 0] + K[1, 1]) * 0.5)
    thr2 = thr_n * thr_n
    idx = ransac_sample_indices(noise, valid, 8)
    Es = _eight_point(gather_rows(na, idx), gather_rows(nb, idx))
    d = _sampson_distance(Es, na, nb)
    scores = ((d < thr2) & valid).sum(-1)
    best = torch.argmax(scores)
    E0 = take(Es, best)
    inl0 = (_sampson_distance(E0, na, nb) < thr2) & valid
    E = _eight_point(na, nb, w=inl0.to(pa.dtype))
    inl = (_sampson_distance(E, na, nb) < thr2) & valid
    better = inl.sum() >= inl0.sum()
    E = torch.where(better, E, E0)
    inliers = torch.where(better, inl, inl0)
    n = inliers.sum()
    return {"E": E, "inliers": inliers, "n_inliers": n, "ok": n >= 8}


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)


def _least_aligned_axis(v):
    """The coordinate axis least aligned with ``v``: crossed with ``v``, it
    gives a vector orthogonal to ``v`` that is never near zero."""
    return torch.nn.functional.one_hot(torch.argmin(v.abs(), dim=-1), 3).to(v.dtype)


def _rank2_svd(A):
    """(U, Vᵀ) of the SVD A = U diag(s) Vᵀ of a rank-2 3x3 ``A`` (an
    8-point essential matrix, rank 2 by ``project_rank2``), both rotations,
    without LAPACK, so without the host read ``torch.linalg.svd`` makes on
    CUDA: v3 the null vector of AᵀA (``smallest_eigvec_3``; its zero
    eigenvalue is far from the others), v1 and v2 the 2x2 eigenproblem on
    its complement in closed form (one Jacobi rotation), u1, u2 = A v1,
    A v2 made orthonormal, u3 = u1 × u2, v3 = v1 × v2. Not a general SVD:
    where A's two smallest singular values are close, v3 converges
    slowly."""
    AtA = A.transpose(-1, -2) @ A
    n = smallest_eigvec_3(AtA)
    b1 = _unit(_cross(n, _least_aligned_axis(n)))
    b2 = _cross(n, b1)
    m00 = (b1 * (AtA @ b1[..., None])[..., 0]).sum(-1)
    m01 = (b1 * (AtA @ b2[..., None])[..., 0]).sum(-1)
    m11 = (b2 * (AtA @ b2[..., None])[..., 0]).sum(-1)
    theta = 0.5 * torch.atan2(2.0 * m01, m00 - m11)     # the larger eigenvalue's vector
    c, s = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    v1 = c * b1 + s * b2
    v2 = c * b2 - s * b1
    Av1 = (A @ v1[..., None])[..., 0]
    Av2 = (A @ v2[..., None])[..., 0]
    s1 = torch.linalg.vector_norm(Av1, dim=-1)
    u1 = _unit(torch.where(s1[..., None] > 1e-30, Av1, b1))
    w2 = Av2 - (u1 * Av2).sum(-1, keepdim=True) * u1
    s2 = torch.linalg.vector_norm(w2, dim=-1)
    # a rank-1 A leaves u2 free: any unit vector orthogonal to u1
    u2 = _unit(torch.where(s2[..., None] > 1e-30, w2, _cross(u1, _least_aligned_axis(u1))))
    U = torch.stack([u1, u2, _cross(u1, u2)], dim=-1)
    Vt = torch.stack([v1, v2, _cross(v1, v2)], dim=-2)
    return U, Vt


def _masked_median(x, mask):
    n_valid = mask.sum()
    srt, _ = torch.sort(torch.where(mask, x, float("inf")))
    mid = torch.clamp((n_valid - 1) // 2, 0, x.shape[0] - 1)
    mid2 = torch.clamp(n_valid // 2, 0, x.shape[0] - 1)
    return 0.5 * (take(srt, mid) + take(srt, mid2))


@functools.partial(Program, copy_outputs=True)
def recover_pose_from_essential(E, K, pa, pb, valid):
    """Pick the (R, t) of the four decompositions of E with the most masked
    points in front of both cameras. Returns (R, t, n_good), |t| = 1."""
    U, Vt = _rank2_svd(E)
    W = upload_constant(torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                                     dtype=E.dtype), E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    tu = U[:, 2]
    eye3 = torch.eye(3, dtype=E.dtype, device=E.device)
    zero3 = torch.zeros(3, dtype=E.dtype, device=E.device)
    cands = [(R1, tu), (R1, -tu), (R2, tu), (R2, -tu)]
    counts = []
    for R, t in cands:
        X = triangulate_dlt(K, eye3, zero3, K, R, t, pa, pb)
        z_a = X[:, 2]
        z_b = (X @ R.T + t)[:, 2]
        counts.append(((z_a > 0) & (z_b > 0) & (z_a.abs() < 100.0) & valid).sum())
    counts = torch.stack(counts)
    best = torch.argmax(counts)
    Rs = torch.stack([c[0] for c in cands])
    ts = torch.stack([c[1] for c in cands])
    return take(Rs, best), take(ts, best), take(counts, best)


@functools.partial(Program, copy_outputs=True)
def estimate_2d2d_scaled(noise, K, pa, pb, valid, X_prev_cam, has3d, R_prev, t_prev,
                         threshold: float = 1.5, min_inliers: int = 12,
                         min_scale_samples: int = 5):
    """2D-2D pose with metric scale from prior landmarks: essential RANSAC →
    recoverPose (unit t) → unit-scale triangulation → scale = median of
    |X_prior| / |X_unit| → T_cur_w = (R, s·t) ∘ T_prev_w.
    Returns dict(R, t, ok, n_inliers, scale, mean_err, inliers).
    A captured program: ``threshold`` and the two counts are keyed by value."""
    res = solve_essential_ransac(noise, K, pa, pb, valid, threshold=threshold)
    R_cp, t_unit, n_good = recover_pose_from_essential(res["E"], K, pa, pb, res["inliers"])
    eye3 = torch.eye(3, dtype=pa.dtype, device=pa.device)
    zero3 = torch.zeros(3, dtype=pa.dtype, device=pa.device)
    X_unit = triangulate_dlt(K, eye3, zero3, K, R_cp, t_unit, pa, pb)
    z_a = X_unit[:, 2]
    z_b = (X_unit @ R_cp.T + t_unit)[:, 2]
    cheir = (z_a > 1e-3) & (z_b > 1e-3) & (z_a.abs() < 100.0)
    scale_ok = res["inliers"] & cheir & has3d
    nu = torch.linalg.vector_norm(X_unit, dim=-1)
    np_ = torch.linalg.vector_norm(X_prev_cam, dim=-1)
    scale = _masked_median(np_ / torch.clamp(nu, min=1e-9), scale_ok)
    n_scale = scale_ok.sum()
    R_cw = R_cp @ R_prev
    t_cw = R_cp @ t_prev + scale * t_unit
    ok = (res["ok"] & (res["n_inliers"] >= min_inliers) & (n_good >= min_inliers)
          & (n_scale >= min_scale_samples) & torch.isfinite(scale)
          & (scale > 1e-3) & (scale < 1e3))
    na = normalize_pixels(K, pa)
    nb = normalize_pixels(K, pb)
    d = torch.sqrt(_sampson_distance(res["E"], na, nb)) * (K[0, 0] + K[1, 1]) * 0.5
    mean_err = (torch.where(res["inliers"], d, 0.0).sum()
                / torch.clamp(res["n_inliers"], min=1))
    return {"R": R_cw, "t": t_cw, "ok": ok, "n_inliers": res["n_inliers"],
            "scale": scale, "mean_err": mean_err, "inliers": res["inliers"]}
