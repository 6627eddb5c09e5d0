"""SE(3) pose-graph optimisation — counterpart of
``zenslam_tpu/backend/pose_graph.py``.

Edge (i, j) carries a measured T_ij = T_i ∘ T_j⁻¹ (world->cam poses); its
residual is the smooth log of T_ij_meas⁻¹ ∘ T_i ∘ T_j⁻¹. Levenberg-Marquardt
over left-multiplicative node increments. The reference takes the 6x6 edge
Jacobians from ``jax.jacfwd`` under ``vmap``; here they are the same
derivatives written out (``edge_jacobians``), batched over edges.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from zenslam_tpu_torch.backend.ba import cholesky_solve_or_zero, seg_add_
from zenslam_tpu_torch.geometry.lie import se3_compose, se3_exp, se3_inverse, so3_hat, so3_vee


def _se3_log_smooth(R, t):
    """First-order smooth log residual [t, vee(R - Rᵀ)/2]: zero iff (R, t) is
    the identity, differentiable there (the exact log is not)."""
    return torch.cat([t, so3_vee(R - R.transpose(-1, -2)) * 0.5], dim=-1)


class PoseGraph(NamedTuple):
    """K nodes (world->cam poses), E edges, fixed-capacity and masked."""

    R: torch.Tensor            # (K, 3, 3)
    t: torch.Tensor            # (K, 3)
    node_valid: torch.Tensor   # (K,)
    node_fixed: torch.Tensor   # (K,) gauge
    edge_i: torch.Tensor       # (E,) int32
    edge_j: torch.Tensor       # (E,) int32
    edge_R: torch.Tensor       # (E, 3, 3) measured T_ij
    edge_t: torch.Tensor       # (E, 3)
    edge_valid: torch.Tensor   # (E,)
    edge_weight: torch.Tensor  # (E,) information scale


def _edge_residuals(g: PoseGraph, R, t):
    """(E, 6) residuals."""
    K = R.shape[0]
    i = g.edge_i.clamp(0, K - 1).long()
    j = g.edge_j.clamp(0, K - 1).long()
    Rj_inv, tj_inv = se3_inverse(R[j], t[j])
    R_ij, t_ij = se3_compose(R[i], t[i], Rj_inv, tj_inv)
    Rm_inv, tm_inv = se3_inverse(g.edge_R, g.edge_t)
    return _se3_log_smooth(*se3_compose(Rm_inv, tm_inv, R_ij, t_ij))


def pose_graph_cost(g: PoseGraph, R=None, t=None):
    R = g.R if R is None else R
    t = g.t if t is None else t
    r = _edge_residuals(g, R, t)
    w = torch.where(g.edge_valid, g.edge_weight, 0.0)
    return (w * (r * r).sum(-1)).sum()


def edge_jacobians(Ri, ti, Rj, tj, Rm, tm):
    """(E, 6, 6) Jacobians of each edge residual w.r.t. the increments
    ξ = [ρ, φ] of its i and j nodes, at zero increment.

    With A = T_meas⁻¹ and T_ij = T_i T_j⁻¹ the error is
    E = A exp(ξ_i) T_ij exp(−ξ_j); to first order exp(ξ) = I + ξ^, so
    dE = A ξ_i^ T_ij − (A T_ij) ξ_j^. The translation rows read dt_E, the
    rotation rows vee(dR_E − dR_Eᵀ)/2 (the smooth log's derivative)."""
    Rj_inv, tj_inv = se3_inverse(Rj, tj)
    Rb, tb = se3_compose(Ri, ti, Rj_inv, tj_inv)
    Ra, _ = se3_inverse(Rm, tm)
    R0 = Ra @ Rb
    basis = so3_hat(torch.eye(3, dtype=Ri.dtype, device=Ri.device))     # (3, 3, 3)

    def rot_rows(dR):                      # (E, k, 3, 3) -> (E, 3, k)
        return (so3_vee(dR - dR.transpose(-1, -2)) * 0.5).transpose(-1, -2)

    zero = torch.zeros_like(Ra)
    Ji = torch.cat([torch.cat([Ra, -Ra @ so3_hat(tb)], -1),
                    torch.cat([zero, rot_rows(torch.einsum("eab,kbc,ecd->ekad", Ra, basis, Rb))],
                              -1)], -2)
    Jj = torch.cat([torch.cat([-R0, zero], -1),
                    torch.cat([zero, rot_rows(-torch.einsum("eab,kbc->ekac", R0, basis))], -1)],
                   -2)
    return Ji, Jj


def optimize_pose_graph(g: PoseGraph, iterations: int = 20, init_lambda: float = 1e-4):
    """LM Gauss-Newton over all node poses; returns R, t, cost_before,
    cost_after and n_accepted."""
    K = g.R.shape[0]
    dev = g.R.device
    free = g.node_valid & (~g.node_fixed)
    m = free.repeat_interleave(6).to(torch.float32)
    i = g.edge_i.clamp(0, K - 1).long()
    j = g.edge_j.clamp(0, K - 1).long()
    w = torch.where(g.edge_valid, g.edge_weight, 0.0)
    eye = torch.eye(K * 6, dtype=torch.float32, device=dev)
    cost0 = pose_graph_cost(g)
    R, t, cost = g.R, g.t, cost0
    lam = torch.full((), init_lambda, dtype=torch.float32, device=dev)
    accepts = []
    for _ in range(iterations):
        r = _edge_residuals(g, R, t)
        Ji, Jj = edge_jacobians(R[i], t[i], R[j], t[j], g.edge_R, g.edge_t)
        JiW = Ji * w[:, None, None]
        JjW = Jj * w[:, None, None]
        # dense H (K, 6, K, 6): four block scatters per edge
        H = torch.zeros((K * K, 6, 6), dtype=torch.float32, device=dev)
        seg_add_(H, i * K + i, torch.einsum("eai,eaj->eij", JiW, Ji))
        seg_add_(H, j * K + j, torch.einsum("eai,eaj->eij", JjW, Jj))
        seg_add_(H, i * K + j, torch.einsum("eai,eaj->eij", JiW, Jj))
        seg_add_(H, j * K + i, torch.einsum("eai,eaj->eij", JjW, Ji))
        H = H.reshape(K, K, 6, 6).permute(0, 2, 1, 3).reshape(K * 6, K * 6)
        b = torch.zeros((K, 6), dtype=torch.float32, device=dev)
        seg_add_(b, i, -torch.einsum("eai,ea->ei", JiW, r))
        seg_add_(b, j, -torch.einsum("eai,ea->ei", JjW, r))
        Hf = H + lam * eye
        Hf = Hf * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        dx = cholesky_solve_or_zero(Hf, b.reshape(K * 6) * m)
        dR, dt = se3_exp(dx.reshape(K, 6) * free[:, None])
        R_new, t_new = se3_compose(dR, dt, R, t)
        new_cost = pose_graph_cost(g, R_new, t_new)
        accept = new_cost < cost
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e3))
        accepts.append(accept)
    n_acc = (torch.stack(accepts).to(torch.int32).sum() if accepts
             else torch.zeros((), dtype=torch.int32, device=dev))
    return {"R": R, "t": t, "cost_before": cost0, "cost_after": cost, "n_accepted": n_acc}
