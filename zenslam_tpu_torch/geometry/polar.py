"""Small-matrix rotation extraction and SPD solves without SVD or LAPACK —
counterpart of ``zenslam_tpu/geometry/polar.py``.

The math is ported as it stands (Newton–Schulz polar, Horn quaternion by
repeated squaring, unrolled Cholesky, shifted inverse iteration), not swapped
for ``torch.linalg`` calls, so ill-conditioned inputs behave as in the
reference. Every function is batched over leading dims.
"""

from __future__ import annotations

import torch

from zenslam_tpu_torch.utils.device import upload_constant


def polar_so3(M, iters: int = 22):
    """Orthogonal polar factor of (…,3,3) M by Newton–Schulz; returns (Q, s)
    with s = tr(QᵀM)/3 the mean singular value."""
    nrm = torch.sqrt((M * M).sum(dim=(-2, -1), keepdim=True))
    X = M / torch.clamp(nrm, min=1e-20)
    for _ in range(iters):
        X = 1.5 * X - 0.5 * X @ (X.transpose(-1, -2) @ X)
    s = (X * M).sum(dim=(-2, -1)) / 3.0
    return X, s


def quat_to_rotation(q):
    """(…,4) unit quaternion [w, x, y, z] -> (…,3,3) rotation."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    r1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    r2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([r0, r1, r2], dim=-2)


def rotation_from_cov(cov, squarings: int = 10):
    """Rotation R maximising tr(Rᵀ·cov) for cov = Σ dᵢ sᵢᵀ (Horn's method:
    dominant eigenvector of N(cov) by repeated squaring). Always proper."""
    def a(i, j):
        return cov[..., i, j]

    trA = a(0, 0) + a(1, 1) + a(2, 2)
    N = torch.stack([
        torch.stack([trA, a(1, 2) - a(2, 1), a(2, 0) - a(0, 2), a(0, 1) - a(1, 0)], -1),
        torch.stack([a(1, 2) - a(2, 1), a(0, 0) - a(1, 1) - a(2, 2),
                     a(0, 1) + a(1, 0), a(0, 2) + a(2, 0)], -1),
        torch.stack([a(2, 0) - a(0, 2), a(0, 1) + a(1, 0),
                     a(1, 1) - a(0, 0) - a(2, 2), a(1, 2) + a(2, 1)], -1),
        torch.stack([a(0, 1) - a(1, 0), a(0, 2) + a(2, 0),
                     a(1, 2) + a(2, 1), a(2, 2) - a(0, 0) - a(1, 1)], -1),
    ], dim=-2)
    c = torch.sqrt((N * N).sum(dim=(-2, -1), keepdim=True))
    eye4 = torch.eye(4, dtype=cov.dtype, device=cov.device)
    B = (N + c * eye4) / torch.clamp(c, min=1e-30)
    for _ in range(squarings):
        B = B @ B
        B = B / torch.clamp(torch.sqrt((B * B).sum(dim=(-2, -1), keepdim=True)), min=1e-30)
    col_n = (B * B).sum(dim=-2)
    pick = torch.argmax(col_n, dim=-1)
    q = torch.gather(B, -1, pick[..., None, None].expand(pick.shape + (4, 1)))[..., 0]
    q = q / torch.clamp(torch.sqrt((q * q).sum(-1, keepdim=True)), min=1e-30)
    return quat_to_rotation(q).transpose(-1, -2)


def _inv3(A):
    """Analytic (…,3,3) inverse via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)
    adj = torch.stack([
        torch.stack([A11, A12, A13], -1),
        torch.stack([A21, A22, A23], -1),
        torch.stack([A31, A32, A33], -1),
    ], dim=-2)
    return adj / det[..., None, None]


def _chol_unrolled(A):
    """Lower Cholesky of a small SPD (…,n,n) matrix, column-unrolled; the sqrt
    argument is clamped so a semidefinite input gives a finite factor."""
    n = A.shape[-1]
    cols = []
    for j in range(n):
        if j:
            Lprev = torch.stack(cols, dim=-1)          # (…, n, j)
            c = A[..., j:, j] - torch.einsum(
                "...ik,...k->...i", Lprev[..., j:, :], Lprev[..., j, :])
        else:
            c = A[..., :, 0]
        d = torch.sqrt(torch.clamp(c[..., 0], min=1e-30))
        col = torch.cat([d[..., None], c[..., 1:] / d[..., None]], dim=-1)
        if j:
            col = torch.cat([torch.zeros_like(A[..., :j, j]), col], dim=-1)
        cols.append(col)
    return torch.stack(cols, dim=-1)


def _tri_solve_unrolled(L, B, lower: bool):
    """Solve L X = B (or Lᵀ X = B with lower=False) by unrolled substitution."""
    n = L.shape[-1]
    order = range(n) if lower else range(n - 1, -1, -1)
    xs = {}
    for i in order:
        acc = B[..., i, :]
        ks = range(i) if lower else range(i + 1, n)
        for k in ks:
            lik = L[..., i, k] if lower else L[..., k, i]
            acc = acc - lik[..., None] * xs[k]
        xs[i] = acc / L[..., i, i, None]
    return torch.stack([xs[i] for i in range(n)], dim=-2)


def inv_spd(A):
    """Inverse of a small SPD (…,n,n) matrix via the unrolled Cholesky;
    n=3 uses the analytic adjugate."""
    n = A.shape[-1]
    if n == 3:
        return _inv3(A)
    L = _chol_unrolled(A)
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    Y = _tri_solve_unrolled(L, eye, lower=True)
    return _tri_solve_unrolled(L, Y, lower=False)


def solve_spd(A, b):
    """Solve A x = b for small SPD A (…,n,n), b (…,n) or (…,n,m)."""
    n = A.shape[-1]
    squeeze = b.dim() == A.dim() - 1
    if squeeze:
        b = b[..., None]
    if n == 3:
        x = _inv3(A) @ b
    else:
        L = _chol_unrolled(A)
        x = _tri_solve_unrolled(L, _tri_solve_unrolled(L, b, lower=True), lower=False)
    return x[..., 0] if squeeze else x


def smallest_eigvec_3(A, iters: int = 6, shift: float = 1e-4):
    """Smallest eigenvector of symmetric PSD (…,3,3) A by shifted inverse
    iteration from two orthogonal seeds, Rayleigh-quotient vote."""
    tr = A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]
    scale = torch.clamp(tr / 3.0, min=1e-20)[..., None, None]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    An = A / scale
    Ainv = _inv3(An + shift * eye)
    V = upload_constant(torch.tensor([[0.36, 0.48], [0.48, 0.64], [0.80, -0.60]],
                                     dtype=A.dtype), A.device).expand(A.shape[:-2] + (3, 2))
    for _ in range(iters):
        V = Ainv @ V
        V = V / torch.clamp(torch.sqrt((V * V).sum(-2, keepdim=True)), min=1e-30)
    r = torch.einsum("...ik,...ij,...jk->...k", V, An, V)
    pick = torch.argmin(r, dim=-1)
    return torch.gather(V, -1, pick[..., None, None].expand(pick.shape + (3, 1)))[..., 0]


def project_rank2(F):
    """F' = F(I − v₃v₃ᵀ) with v₃ the smallest right-singular vector."""
    FtF = F.transpose(-1, -2) @ F
    v3 = smallest_eigvec_3(FtF)
    return F - (F @ v3[..., None]) @ v3[..., None, :]
