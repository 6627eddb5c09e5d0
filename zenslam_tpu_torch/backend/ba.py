"""Bundle adjustment: Levenberg-Marquardt Gauss-Newton with Schur-complement
reduction — counterpart of ``zenslam_tpu/backend/ba.py``.

Fixed-capacity masked problems (invalid keyframes, landmarks and
observations contribute zero), analytic Jacobians, Huber loss, gauge by
``kf_fixed``, motion-only mode, and two reduced-camera-system solvers: dense
Cholesky (``bundle_adjust``) and matrix-free preconditioned CG
(``bundle_adjust_cg``). The LM loop is unrolled in Python over a static
iteration count; accept/reject is a ``torch.where``, so no iteration reads
the device.

A failed Cholesky gives a zero pose step, as the reference's NaN factor
does (``cholesky_ex`` reports the failure on the device instead of raising).

Both solvers are captured programs (``utils/graphs.py``), as the reference
jits them: on CUDA a direct call captures once per static arguments and
shapes and replays, and returns results the caller owns. ``huber_delta``
and ``init_lambda`` are keyed by value (the reference traces them): every
caller passes 1.0 and 1e-3, so no second capture comes of it in practice.
Called inside another program (the system's windowed BA, the trim's two
halves) a solver runs inline.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from zenslam_tpu_torch.geometry.lie import so3_exp, so3_hat
from zenslam_tpu_torch.geometry.polar import inv_spd
from zenslam_tpu_torch.utils.device import resolve_device
from zenslam_tpu_torch.utils.graphs import Program


class BAProblem(NamedTuple):
    """Masked BA problem. K keyframes, M landmarks, O observations."""

    R: torch.Tensor          # (K, 3, 3) world->cam
    t: torch.Tensor          # (K, 3)
    kf_valid: torch.Tensor   # (K,) bool
    kf_fixed: torch.Tensor   # (K,) bool — gauge
    xyz: torch.Tensor        # (M, 3)
    lm_valid: torch.Tensor   # (M,) bool
    obs_kf: torch.Tensor     # (O,) int32
    obs_lm: torch.Tensor     # (O,) int32
    obs_uv: torch.Tensor     # (O, 2)
    obs_cam: torch.Tensor    # (O,) int32: 0 = left, 1 = right (through R_rl, t_rl)
    obs_valid: torch.Tensor  # (O,) bool
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    fx_r: torch.Tensor
    fy_r: torch.Tensor
    cx_r: torch.Tensor
    cy_r: torch.Tensor
    R_rl: torch.Tensor       # (3, 3)
    t_rl: torch.Tensor       # (3,)


def make_ba_problem(K, M, O, fx, fy, cx, cy, fx_r=None, fy_r=None, cx_r=None,
                    cy_r=None, R_rl=None, t_rl=None, device=None):
    """Empty fixed-capacity problem on ``device`` (default CUDA, raising when
    absent). Defaults: right camera = left camera, identity extrinsics
    (obs_cam == 0 everywhere is monocular BA)."""
    device = resolve_device(device)
    f32 = torch.float32

    def s(v, default):
        return torch.tensor(float(default if v is None else v), dtype=f32, device=device)

    return BAProblem(
        R=torch.eye(3, dtype=f32, device=device).repeat(K, 1, 1),
        t=torch.zeros((K, 3), dtype=f32, device=device),
        kf_valid=torch.zeros(K, dtype=torch.bool, device=device),
        kf_fixed=torch.zeros(K, dtype=torch.bool, device=device),
        xyz=torch.zeros((M, 3), dtype=f32, device=device),
        lm_valid=torch.zeros(M, dtype=torch.bool, device=device),
        obs_kf=torch.zeros(O, dtype=torch.int32, device=device),
        obs_lm=torch.zeros(O, dtype=torch.int32, device=device),
        obs_uv=torch.zeros((O, 2), dtype=f32, device=device),
        obs_cam=torch.zeros(O, dtype=torch.int32, device=device),
        obs_valid=torch.zeros(O, dtype=torch.bool, device=device),
        fx=s(fx, 0), fy=s(fy, 0), cx=s(cx, 0), cy=s(cy, 0),
        fx_r=s(fx_r, fx), fy_r=s(fy_r, fy), cx_r=s(cx_r, cx), cy_r=s(cy_r, cy),
        R_rl=(torch.eye(3, dtype=f32, device=device) if R_rl is None
              else torch.as_tensor(R_rl, dtype=f32, device=device)),
        t_rl=(torch.zeros(3, dtype=f32, device=device) if t_rl is None
              else torch.as_tensor(t_rl, dtype=f32, device=device)),
    )


def seg_add_(out, idx, vals):
    """``out[idx[k]] += vals[k]`` for every row k, in place, with the same
    result on every run: on CUDA ``index_put_`` with ``accumulate`` sorts the
    indices and sums each group in turn, where ``index_add_`` races float
    atomics whose order changes the last bits of each sum from run to run
    (and, through BA's write-back, later keyframe decisions). On the CPU
    ``index_add_`` already adds in row order. For the few, short groups of
    the pose graph; BA's sums go through ``SegPlan``."""
    if out.device.type == "cuda":
        return out.index_put_((idx.long(),), vals, accumulate=True)
    return out.index_add_(0, idx, vals)


class SegPlan(NamedTuple):
    """How to sum rows grouped by an index that holds for a whole BA window
    (the observations' keyframe or landmark), in an order fixed by the plan
    and not by the run: the kept rows sorted stably by group, each group
    summed in row order by ``torch.segment_reduce``, as ``index_add_`` adds
    on the CPU, bit for bit on either device. The deterministic
    ``index_put_(accumulate=True)`` gives the same sums on CUDA, but sorts
    the indices on every call and adds a group's rows through global
    memory one after another; a plan sorts once per window. Rows dropped
    by ``keep`` (the sharded router's padding) sort last and are read by no
    group, so they change no bit and lengthen no group."""

    order: torch.Tensor      # (O,) rows sorted by group, dropped rows last
    offsets: torch.Tensor    # (n + 1,) first sorted row of each group


def seg_plan(n: int, idx, keep=None) -> SegPlan:
    """The plan for (n, ...) sums of rows grouped by ``idx`` (O,) in [0, n);
    rows where ``keep`` is False add nothing. One stable sort, no host
    read."""
    key = idx.long()
    if keep is not None:
        key = torch.where(keep, key, n)
    key_sorted, order = torch.sort(key, stable=True)
    groups = torch.arange(n + 1, dtype=key.dtype, device=key.device)
    return SegPlan(order=order, offsets=torch.searchsorted(key_sorted, groups))


def seg_sum(plan: SegPlan, vals, live=None):
    """(n, ...) sums of ``vals`` (O, ...) rows by ``plan`` (the reference's
    ``zeros.at[idx].add``); rows where ``live`` is False add zero."""
    if live is not None:
        vals = torch.where(live.reshape(live.shape + (1,) * (vals.dim() - 1)), vals, 0.0)
    return torch.segment_reduce(vals.index_select(0, plan.order), "sum", offsets=plan.offsets,
                                unsafe=True)


class BAPlans(NamedTuple):
    """A window's sum plans: by keyframe, by landmark and, for the dense
    solver's (M, K) blocks, by (landmark, keyframe)."""

    kf: SegPlan
    lm: SegPlan
    lm_kf: SegPlan | None


def ba_plans(p: BAProblem, pairs: bool = True) -> BAPlans:
    """The sum plans of ``p``'s observations, built once per window: the
    observation rows' keyframe and landmark stay fixed over its LM steps
    and CG iterations. Invalid observations add nothing."""
    K, M = p.R.shape[0], p.xyz.shape[0]
    kf = p.obs_kf.clamp(0, K - 1).long()
    lm = p.obs_lm.clamp(0, M - 1).long()
    return BAPlans(kf=seg_plan(K, kf, p.obs_valid), lm=seg_plan(M, lm, p.obs_valid),
                   lm_kf=seg_plan(M * K, lm * K + kf, p.obs_valid) if pairs else None)


def _residuals_and_weights(p: BAProblem, R, t, xyz, huber_delta: float):
    """Per-observation residual (O, 2), robust weight (O,), validity (O,),
    the camera-frame point, the keyframe rotation, the left-camera point,
    the right-camera flag and the per-observation (fx, fy)."""
    kf = p.obs_kf.clamp(0, R.shape[0] - 1).long()
    lm = p.obs_lm.clamp(0, xyz.shape[0] - 1).long()
    Rk = R[kf]
    X = xyz[lm]
    xc0 = torch.einsum("oij,oj->oi", Rk, X) + t[kf]
    is_r = p.obs_cam == 1
    xc = torch.where(is_r[:, None], xc0 @ p.R_rl.T + p.t_rl, xc0)
    fx = torch.where(is_r, p.fx_r, p.fx)
    fy = torch.where(is_r, p.fy_r, p.fy)
    cx = torch.where(is_r, p.cx_r, p.cx)
    cy = torch.where(is_r, p.cy_r, p.cy)
    z = xc[:, 2]
    good = p.obs_valid & (z > 1e-3)
    z_safe = torch.where(z.abs() < 1e-3, torch.full_like(z, 1e-3), z)
    u = fx * xc[:, 0] / z_safe + cx
    v = fy * xc[:, 1] / z_safe + cy
    r = torch.stack([u - p.obs_uv[:, 0], v - p.obs_uv[:, 1]], dim=-1)
    rn = torch.linalg.vector_norm(r, dim=-1)
    w_huber = torch.where(rn <= huber_delta, 1.0, huber_delta / torch.clamp(rn, min=1e-12))
    w = torch.where(good, w_huber, 0.0)
    return r, w, good, xc, Rk, xc0, is_r, (fx, fy)


def ba_cost(p: BAProblem, R=None, t=None, xyz=None, huber_delta: float = 1.0):
    """Total robust cost and RMSE over valid observations."""
    R = p.R if R is None else R
    t = p.t if t is None else t
    xyz = p.xyz if xyz is None else xyz
    r, _, good, *_ = _residuals_and_weights(p, R, t, xyz, huber_delta)
    r2 = (r * r).sum(-1)
    rn = torch.sqrt(torch.clamp(r2, min=1e-18))
    rho = torch.where(rn <= huber_delta, 0.5 * r2, huber_delta * (rn - 0.5 * huber_delta))
    cost = torch.where(good, rho, 0.0).sum()
    n = torch.clamp(good.sum(), min=1)
    rmse = torch.sqrt(torch.where(good, r2, 0.0).sum() / n)
    return cost, rmse


def _obs_jacobians(p: BAProblem, R, t, xyz, huber_delta: float):
    """Per-observation residuals and analytic Jacobians: (r (O,2), w (O,),
    kf (O,), lm (O,), Jp (O,2,6), Jl (O,2,3)). Pose increments are
    left-multiplicative on the left-camera pose."""
    K, M = R.shape[0], xyz.shape[0]
    r, w, _, xc, Rk, xc0, is_r, (fx, fy) = _residuals_and_weights(p, R, t, xyz, huber_delta)
    kf = p.obs_kf.clamp(0, K - 1).long()
    lm = p.obs_lm.clamp(0, M - 1).long()
    z = torch.where(xc[:, 2].abs() < 1e-3, torch.full_like(xc[:, 2], 1e-3), xc[:, 2])
    inv_z = 1.0 / z
    x_, y_ = xc[:, 0], xc[:, 1]
    zeros = torch.zeros_like(z)
    J_proj = torch.stack([
        torch.stack([fx * inv_z, zeros, -fx * x_ * inv_z * inv_z], -1),
        torch.stack([zeros, fy * inv_z, -fy * y_ * inv_z * inv_z], -1),
    ], dim=-2)
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(xc.shape[:1] + (3, 3))
    C_chain = torch.where(is_r[:, None, None], p.R_rl.expand(eye.shape), eye)
    J_pose = C_chain @ torch.cat([eye, -so3_hat(xc0)], dim=-1)    # (O, 3, 6)
    Jp = J_proj @ J_pose
    Jl = J_proj @ (C_chain @ Rk)
    return r, w, kf, lm, Jp, Jl


def _build_blocks(p: BAProblem, R, t, xyz, huber_delta: float, plans: BAPlans | None = None):
    """Normal-equation blocks: U (K,6,6), g_p (K,6), V (M,3,3), g_l (M,3),
    A (M,K,6,3) with A[m,k] the sum of J_pᵀ W J_l over observations (k, m).
    ``plans``: ``ba_plans(p)``, built here when not given."""
    K, M = R.shape[0], xyz.shape[0]
    plans = ba_plans(p) if plans is None else plans
    r, w, kf, lm, Jp, Jl = _obs_jacobians(p, R, t, xyz, huber_delta)
    Jp_w = Jp * w[:, None, None]
    Jl_w = Jl * w[:, None, None]
    live = w != 0       # zero-weight rows (invalid, padding, behind the camera) add 0
    U = seg_sum(plans.kf, torch.einsum("oai,oaj->oij", Jp_w, Jp), live)
    g_p = seg_sum(plans.kf, -torch.einsum("oai,oa->oi", Jp_w, r), live)
    V = seg_sum(plans.lm, torch.einsum("oai,oaj->oij", Jl_w, Jl), live)
    g_l = seg_sum(plans.lm, -torch.einsum("oai,oa->oi", Jl_w, r), live)
    Wb = torch.einsum("oai,oaj->oij", Jp_w, Jl)
    A = seg_sum(plans.lm_kf, Wb, live).reshape(M, K, 6, 3)
    return U, g_p, V, g_l, A


def _inv3x3(V):
    """Batched closed-form 3x3 inverse via the adjugate (M, 3, 3)."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 0], V[..., 1, 1], V[..., 1, 2]
    g, h, i = V[..., 2, 0], V[..., 2, 1], V[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), (b * f - c * e)], -1),
        torch.stack([B, (a * i - c * g), -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), (a * e - b * d)], -1),
    ], dim=-2)
    return adj / det[..., None, None]


def _block_diag(D):
    """(K, n, n) blocks -> (K, n, K, n) block-diagonal tensor."""
    K = D.shape[0]
    return torch.einsum("kab,kl->kalb", D, torch.eye(K, dtype=D.dtype, device=D.device))


def _eliminate_landmarks(V, g_l, A, lm_active, lam):
    """Landmark elimination: V⁻¹ of the damped V (identity where a landmark
    is inactive), and the reduced camera system's off-diagonal part S_off
    (K, 6, K, 6) and rhs part g_off (K, 6), before assembly (the sharded
    solver sums them over the shards first)."""
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    Vinv = _inv3x3(torch.where(lm_active[:, None, None], V + lam * eye3, eye3))
    B = torch.einsum("mkab,mbc->mkac", A, Vinv)
    return Vinv, torch.einsum("mkac,mldc->kald", B, A), torch.einsum("mkac,mc->ka", B, g_l)


def _reduced_system(U, g_p, S_off, g_off, lam):
    """The dense reduced camera system (6K, 6K) and its rhs (6K,)."""
    K = U.shape[0]
    Ud = U + lam * torch.eye(6, dtype=U.dtype, device=U.device)
    S = _block_diag(Ud) - S_off
    return S.reshape(K * 6, K * 6), (g_p - g_off).reshape(K * 6)


def _apply_gauge(S, rhs, free_mask6):
    """Zero rows/cols of fixed/invalid pose parameters, unit diagonal."""
    m = free_mask6.to(S.dtype)
    S = S * m[:, None] * m[None, :] + torch.diag(1.0 - m)
    return S, rhs * m


def cholesky_solve_or_zero(S, rhs):
    """x = S⁻¹ rhs through the Cholesky factor of the symmetrised S + 1e-8 I;
    zero where the factorisation fails or the result is not finite (the
    reference's NaN factor, zeroed)."""
    n = S.shape[-1]
    Ss = 0.5 * (S + S.transpose(-1, -2)) + 1e-8 * torch.eye(n, dtype=S.dtype, device=S.device)
    L, info = torch.linalg.cholesky_ex(Ss)
    x = torch.cholesky_solve(rhs[..., None], L)[..., 0]
    x = torch.where((info == 0)[..., None], x, 0.0)
    return torch.where(torch.isfinite(x), x, 0.0)


def _inv6x6_chol(U):
    """Batched (K,6,6) SPD inverse (the Jacobi preconditioner)."""
    return inv_spd(U + 1e-8 * torch.eye(6, dtype=U.dtype, device=U.device))


def _lm_update(R, t, xyz, d_pose, d_lm, lam, cost, cost_fn):
    """Apply a left-multiplicative pose step and a landmark step; keep them
    where the robust cost ``cost_fn(R, t, xyz)`` falls, and adapt the
    damping."""
    dR = so3_exp(d_pose[:, 3:])
    R_new = dR @ R
    t_new = torch.einsum("kij,kj->ki", dR, t) + d_pose[:, :3]
    xyz_new = xyz + d_lm
    new_cost = cost_fn(R_new, t_new, xyz_new)
    accept = new_cost < cost
    return (torch.where(accept, R_new, R), torch.where(accept, t_new, t),
            torch.where(accept, xyz_new, xyz), torch.where(accept, new_cost, cost),
            torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                        torch.clamp(lam * 4.0, max=1e3)),
            accept)


def lm_schur(p: BAProblem, cost0, cost_fn, iterations: int, huber_delta: float,
             refine_landmarks: bool, init_lambda: float, all_sum=None):
    """The LM-damped Schur loop of ``bundle_adjust``, shared with the sharded
    solver (``parallel/dist_ba.py``). ``p`` is the whole problem, or one
    rank's block of landmarks and their observations; then ``all_sum(U,
    g_p, S_off, g_off)`` sums the reduced camera system's parts over the
    ranks and ``cost_fn(R, t, xyz)`` returns the summed cost (``cost0``
    the initial one). Every rank then solves the same system. Returns (R,
    t, xyz, cost, n_accepted) with device-resident values: no host read."""
    K = p.R.shape[0]
    free_kf = p.kf_valid & ~p.kf_fixed
    free_mask6 = free_kf.repeat_interleave(6)
    R, t, xyz, cost = p.R, p.t, p.xyz, cost0
    lam = torch.full((), init_lambda, dtype=torch.float32, device=p.R.device)
    accepts = []
    plans = ba_plans(p)
    for _ in range(iterations):
        U, g_p, V, g_l, A = _build_blocks(p, R, t, xyz, huber_delta, plans)
        if refine_landmarks:
            Vinv, S_off, g_off = _eliminate_landmarks(V, g_l, A, p.lm_valid, lam)
        else:
            S_off = torch.zeros((K, 6, K, 6), dtype=U.dtype, device=U.device)
            g_off = torch.zeros((K, 6), dtype=U.dtype, device=U.device)
        if all_sum is not None:
            U, g_p, S_off, g_off = all_sum(U, g_p, S_off, g_off)
        S, rhs = _apply_gauge(*_reduced_system(U, g_p, S_off, g_off, lam), free_mask6)
        d_pose = cholesky_solve_or_zero(S, rhs).reshape(K, 6) * free_kf[:, None]
        if refine_landmarks:    # back-substitution, local to the landmarks' block
            At_dp = torch.einsum("mkab,ka->mb", A, d_pose)
            d_lm = torch.einsum("mbc,mc->mb", Vinv, g_l - At_dp) * p.lm_valid[:, None]
        else:
            d_lm = torch.zeros_like(xyz)
        R, t, xyz, cost, lam, acc = _lm_update(R, t, xyz, d_pose, d_lm, lam, cost, cost_fn)
        accepts.append(acc)
    return R, t, xyz, cost, _count(accepts, p.R.device)


@functools.partial(Program, static_argnames=("iterations", "cg_iters", "refine_landmarks"),
                   copy_outputs=True)
def bundle_adjust_cg(p: BAProblem, iterations: int = 10, cg_iters: int = 40,
                     huber_delta: float = 1.0, refine_landmarks: bool = True,
                     init_lambda: float = 1e-3):
    """Matrix-free LM-Schur BA for large windows: S = U+λ − Wᵀ(V+λ)⁻¹W is
    applied as an operator (two observation passes per product) and solved
    by block-Jacobi-preconditioned CG; no (M, K, 6, 3) storage. Same
    contract as ``bundle_adjust``."""
    K, M = p.R.shape[0], p.xyz.shape[0]
    cost0, rmse0 = ba_cost(p, huber_delta=huber_delta)

    def cost_fn(R, t, xyz):
        return ba_cost(p, R, t, xyz, huber_delta)[0]

    free_kf = p.kf_valid & (~p.kf_fixed)
    fmask = free_kf[:, None].to(p.R.dtype)
    eye3 = torch.eye(3, dtype=p.R.dtype, device=p.R.device)
    lm_active = p.lm_valid if refine_landmarks else torch.zeros_like(p.lm_valid)
    R, t, xyz = p.R, p.t, p.xyz
    lam = torch.full((), init_lambda, dtype=torch.float32, device=p.R.device)
    cost = cost0
    accepts = []
    plans = ba_plans(p, pairs=False)
    for _ in range(iterations):
        r, w, kf, lm, Jp, Jl = _obs_jacobians(p, R, t, xyz, huber_delta)
        Jp_w = Jp * w[:, None, None]
        Jl_w = Jl * w[:, None, None]
        U = seg_sum(plans.kf, torch.einsum("oai,oaj->oij", Jp_w, Jp))
        g_p = seg_sum(plans.kf, -torch.einsum("oai,oa->oi", Jp_w, r))
        V = seg_sum(plans.lm, torch.einsum("oai,oaj->oij", Jl_w, Jl))
        g_l = seg_sum(plans.lm, -torch.einsum("oai,oa->oi", Jl_w, r))
        Vinv = _inv3x3(torch.where(lm_active[:, None, None], V + lam * eye3, eye3))
        Ud = U + lam * torch.eye(6, dtype=U.dtype, device=U.device)

        def lm_pass(v_pose, Jp=Jp, Jl_w=Jl_w, Vinv=Vinv, kf=kf, lm=lm):
            Jpv = torch.einsum("oab,ob->oa", Jp, v_pose[kf])
            s = seg_sum(plans.lm, torch.einsum("oab,oa->ob", Jl_w, Jpv))
            return torch.einsum("mbc,mc->mb", Vinv, s) * lm_active[:, None]

        def off_to_pose(u_lm, Jl=Jl, Jp_w=Jp_w, kf=kf, lm=lm):
            Jlu = torch.einsum("oab,ob->oa", Jl, u_lm[lm])
            return seg_sum(plans.kf, torch.einsum("oab,oa->ob", Jp_w, Jlu))

        def S_matvec(v, Ud=Ud):
            v = v * fmask
            y = torch.einsum("kab,kb->ka", Ud, v) - off_to_pose(lm_pass(v))
            return torch.where(fmask > 0, y, v)

        b_lm = torch.einsum("mbc,mc->mb", Vinv, g_l) * lm_active[:, None]
        rhs = (g_p - off_to_pose(b_lm)) * fmask
        Minv = _inv6x6_chol(Ud)

        def precon(x, Minv=Minv):
            return torch.einsum("kab,kb->ka", Minv, x) * fmask

        x = torch.zeros((K, 6), dtype=R.dtype, device=R.device)
        rr = rhs
        z = precon(rhs)
        pdir = z
        rz = (rhs * z).sum()
        for _ in range(cg_iters):
            Ap = S_matvec(pdir)
            denom = (pdir * Ap).sum()
            alpha = rz / torch.where(denom.abs() < 1e-20, 1e-20, denom)
            x = x + alpha * pdir
            rr = rr - alpha * Ap
            z = precon(rr)
            rz_new = (rr * z).sum()
            beta = rz_new / torch.where(rz.abs() < 1e-20, 1e-20, rz)
            pdir = z + beta * pdir
            rz = rz_new
        d_pose = torch.where(torch.isfinite(x), x, 0.0) * fmask
        if refine_landmarks:
            Jpd = torch.einsum("oab,ob->oa", Jp, d_pose[kf])
            s = seg_sum(plans.lm, torch.einsum("oab,oa->ob", Jl_w, Jpd))
            d_lm = torch.einsum("mbc,mc->mb", Vinv, g_l - s) * lm_active[:, None]
        else:
            d_lm = torch.zeros_like(xyz)
        R, t, xyz, cost, lam, acc = _lm_update(R, t, xyz, d_pose, d_lm, lam, cost,
                                               cost_fn)
        accepts.append(acc)
    _, rmse1 = ba_cost(p, R, t, xyz, huber_delta=huber_delta)
    return {"R": R, "t": t, "xyz": xyz, "rmse_before": rmse0, "rmse_after": rmse1,
            "cost_before": cost0, "cost_after": cost,
            "n_accepted": _count(accepts, p.R.device)}


def _count(flags, device):
    if not flags:
        return torch.zeros((), dtype=torch.int32, device=device)
    return torch.stack(flags).to(torch.int32).sum()


@functools.partial(Program, static_argnames=("iterations", "refine_landmarks", "trim_threshold"),
                   copy_outputs=True)
def bundle_adjust(p: BAProblem, iterations: int = 15, huber_delta: float = 1.0,
                  refine_landmarks: bool = True, init_lambda: float = 1e-3,
                  trim_threshold: float | None = None):
    """LM-damped Gauss-Newton with Schur elimination and a dense Cholesky
    solve of the reduced camera system.

    Returns a dict with optimised R, t, xyz, rmse_before/after,
    cost_before/after and n_accepted. ``refine_landmarks=False`` is
    motion-only BA. ``trim_threshold``: after the first half of the
    iterations, observations with a residual above it (px) are dropped and
    the second half re-converges on the rest (adds ``n_trimmed``)."""
    if trim_threshold is not None:
        first = bundle_adjust(p, iterations=iterations // 2, huber_delta=huber_delta,
                              refine_landmarks=refine_landmarks, init_lambda=init_lambda)
        r, _, good, *_ = _residuals_and_weights(p, first["R"], first["t"], first["xyz"],
                                                huber_delta)
        keep = good & (torch.linalg.vector_norm(r, dim=-1) < trim_threshold)
        p = p._replace(obs_valid=keep, R=first["R"], t=first["t"], xyz=first["xyz"])
        second = bundle_adjust(p, iterations=iterations - iterations // 2,
                               huber_delta=huber_delta, refine_landmarks=refine_landmarks,
                               init_lambda=init_lambda)
        return dict(second, rmse_before=first["rmse_before"],
                    n_trimmed=good.sum() - keep.sum())

    cost0, rmse0 = ba_cost(p, huber_delta=huber_delta)
    R, t, xyz, cost, n_acc = lm_schur(
        p, cost0, lambda R, t, xyz: ba_cost(p, R, t, xyz, huber_delta)[0], iterations,
        huber_delta, refine_landmarks, init_lambda)
    _, rmse1 = ba_cost(p, R, t, xyz, huber_delta=huber_delta)
    return {"R": R, "t": t, "xyz": xyz, "rmse_before": rmse0, "rmse_after": rmse1,
            "cost_before": cost0, "cost_after": cost, "n_accepted": n_acc}
