"""Line-segment detection and line descriptors — counterpart of
``zenslam_tpu/ops/lines.py``.

The image is cut into cells; each cell's edge-gated gradient structure
tensor says whether one dominant edge orientation lives there (coherence)
and gives a support segment (weighted centroid, principal direction, masked
extent). Collinear neighbouring cells are merged by a run-length segmented
reduction along grid rows (near-horizontal lines) and grid columns
(near-vertical lines). Output is a fixed-capacity endpoint table with a
validity mask.

The descriptor is a line-aligned binary patch: 16x16 intensities sampled in
the (direction, normal) frame of the segment, each compared with the patch
mean, packed to (L, 8) int32 words with ORB's bit layout (``ops/orb.py:
pack_bits``), so the Hamming matcher of ``ops/match.py`` is reused.

Plain tensor code with static shapes: no data-dependent sizes, no host
reads. The reference's ``segment_min`` is a ``scatter_reduce("amin")`` and
its ``top_k`` a stable descending sort (ties to the lower index).
"""

from __future__ import annotations

import functools
import math

import torch

from zenslam_tpu_torch.ops.image import bilinear_sample, scharr_gradients
from zenslam_tpu_torch.ops.orb import pack_bits
from zenslam_tpu_torch.utils.graphs import Program

_I32_MAX = 2 ** 31 - 1


def canonicalize_endpoints(ep):
    """Order endpoints so the segment direction has angle in [-90°, 90°):
    dx > 0, ties broken by dy >= 0. ep: (..., 2, 2) [point, xy]."""
    d = ep[..., 1, :] - ep[..., 0, :]
    flip = (d[..., 0] < 0) | ((d[..., 0] == 0) & (d[..., 1] < 0))
    return torch.where(flip[..., None, None], ep.flip(-2), ep)


def _cell_support(img, cell_size: int, mag_threshold: float):
    """Per-cell line-support statistics: a dict of (gh, gw) tensors
    (centroid and dir (..., 2), ep (..., 2, 2) cell-local segment endpoints,
    coherence, n_edge, perp_rms, strength, extent, finite)."""
    H, W = img.shape
    cs = cell_size
    gh, gw = H // cs, W // cs
    gx, gy = scharr_gradients(img)
    mag2 = gx * gx + gy * gy
    yy = torch.arange(H, dtype=torch.float32, device=img.device)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=img.device)[None, :].expand(H, W)

    def cells(a):
        return a.reshape(gh, cs, gw, cs).permute(0, 2, 1, 3).reshape(gh, gw, cs * cs)

    m2c = cells(mag2)
    # adaptive edge gate: above the absolute floor and within a fraction of
    # the cell's strongest gradient
    cell_max = m2c.amax(-1, keepdim=True)
    gate = torch.clamp(0.25 * cell_max, min=mag_threshold * mag_threshold)
    wc = torch.where(m2c > gate, m2c, 0.0)
    xc, yc, gxc, gyc = cells(xx), cells(yy), cells(gx), cells(gy)

    wsum = wc.sum(-1)
    wsafe = torch.clamp(wsum, min=1e-12)
    cx = (wc * xc).sum(-1) / wsafe
    cy = (wc * yc).sum(-1) / wsafe

    # gradient structure tensor (weighted by magnitude², edge-gated)
    m2s = torch.clamp(m2c, min=1e-12)
    jxx = (wc * gxc * gxc / m2s).sum(-1)
    jxy = (wc * gxc * gyc / m2s).sum(-1)
    jyy = (wc * gyc * gyc / m2s).sum(-1)
    tr = jxx + jyy
    dd = jxx - jyy
    disc = torch.sqrt(dd * dd / 4.0 + jxy * jxy)
    lam1 = tr / 2.0 + disc
    lam2 = tr / 2.0 - disc
    coherence = (lam1 - lam2) / torch.clamp(lam1 + lam2, min=1e-12)
    # dominant gradient orientation (mod π); the line direction is its normal
    theta_g = 0.5 * torch.atan2(2.0 * jxy, dd)
    dirx = -torch.sin(theta_g)
    diry = torch.cos(theta_g)
    flip = dirx < 0   # canonical: dx >= 0
    dirx = torch.where(flip, -dirx, dirx)
    diry = torch.where(flip, -diry, diry)

    # masked extent along the line direction + RMS perpendicular spread
    px = xc - cx[..., None]
    py = yc - cy[..., None]
    s = px * dirx[..., None] + py * diry[..., None]
    p = -px * diry[..., None] + py * dirx[..., None]
    mask = wc > 0
    s_min = torch.where(mask, s, math.inf).amin(-1)
    s_max = torch.where(mask, s, -math.inf).amax(-1)
    perp_rms = torch.sqrt((wc * p * p).sum(-1) / wsafe)
    n_edge = mask.sum(-1)

    d = torch.stack([dirx, diry], -1)
    c = torch.stack([cx, cy], -1)
    finite = torch.isfinite(s_min) & torch.isfinite(s_max)
    s_min = torch.where(finite, s_min, 0.0)
    s_max = torch.where(finite, s_max, 0.0)
    ep = torch.stack([c + s_min[..., None] * d, c + s_max[..., None] * d], -2)
    return {"centroid": c, "dir": d, "ep": ep, "coherence": coherence, "n_edge": n_edge,
            "perp_rms": perp_rms, "strength": lam1, "extent": s_max - s_min,
            "finite": finite}


def _merge_runs(ok, d, ep, along_rows: bool, angle_cos_tol: float, gap_tol: float,
                perp_tol: float):
    """Merge collinear consecutive cells along grid rows (or columns).
    Returns (emit (gh, gw) bool, ep_merged (gh, gw, 2, 2)): a merged segment
    is emitted at the first cell of its run."""
    if not along_rows:
        emit, mep = _merge_runs(ok.T, d.transpose(0, 1), ep.transpose(0, 1), True,
                                angle_cos_tol, gap_tol, perp_tol)
        return emit.T, mep.transpose(0, 1)
    gh, gw = ok.shape
    dev = ok.device

    def prev(a):   # predecessor in the same row (col - 1), zeros at col 0
        return torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], 1)

    d_prev, ep_prev, ok_prev = prev(d), prev(ep), prev(ok)
    cos_sim = (d * d_prev).sum(-1).abs()
    # endpoint continuity: the smallest of the four endpoint gaps
    gaps = torch.linalg.vector_norm(ep[:, :, :, None, :] - ep_prev[:, :, None, :, :], dim=-1)
    gap = gaps.reshape(gh, gw, 4).amin(-1)
    # perpendicular offset of the predecessor's centre from our line
    n = torch.stack([-d[..., 1], d[..., 0]], -1)
    c_prev = 0.5 * (ep_prev[..., 0, :] + ep_prev[..., 1, :])
    c_cur = 0.5 * (ep[..., 0, :] + ep[..., 1, :])
    perp = ((c_prev - c_cur) * n).sum(-1).abs()

    link = ok & ok_prev & (cos_sim >= angle_cos_tol) & (gap <= gap_tol) & (perp <= perp_tol)
    start = ok & ~link
    rid = torch.cumsum(start.to(torch.int64), 1) - 1   # run index within the row
    row = torch.arange(gh, device=dev)[:, None]
    seg = torch.where(ok, row * gw + rid, gh * gw).reshape(-1)
    nseg = gh * gw + 1

    # first / last cell of each run by column index
    col = torch.arange(gw, device=dev).repeat(gh)
    flat = torch.arange(gh * gw, device=dev)
    init = torch.full((nseg,), _I32_MAX, dtype=torch.int64, device=dev)
    first = init.scatter_reduce(0, seg, col * (gh * gw) + flat, "amin", include_self=False)
    last = init.scatter_reduce(0, seg, (gw - 1 - col) * (gh * gw) + flat, "amin",
                               include_self=False)
    first_idx = first % (gh * gw)
    last_idx = last % (gh * gw)

    # the merged segment: the extreme endpoints of the first and last cell
    # projected on the first cell's direction
    ep_flat = ep.reshape(-1, 2, 2)
    d_first = d.reshape(-1, 2)[first_idx]
    cand = torch.cat([ep_flat[first_idx], ep_flat[last_idx]], -2)   # (nseg, 4, 2)
    sproj = (cand * d_first[:, None, :]).sum(-1)
    lo = sproj.argmin(-1)
    hi = sproj.argmax(-1)
    r = torch.arange(nseg, device=dev)
    mep = torch.stack([cand[r, lo], cand[r, hi]], -2)
    return start, mep[seg].reshape(gh, gw, 2, 2)


def point_segment_distance(p, ep):
    """Distance from points p (N, 2) to segments ep (M, 2, 2) -> (N, M)."""
    a = ep[:, 0, :]
    b = ep[:, 1, :]
    ab = b - a
    denom = torch.clamp((ab * ab).sum(-1), min=1e-12)
    ap = p[:, None, :] - a[None, :, :]
    t = torch.clamp((ap * ab[None]).sum(-1) / denom[None], 0.0, 1.0)
    proj = a[None] + t[..., None] * ab[None]
    return torch.linalg.vector_norm(p[:, None, :] - proj, dim=-1)


@functools.partial(Program, static_argnames=("cell_size", "max_keylines", "border"),
                   copy_outputs=True)
def detect_keylines(img, existing_ep, existing_valid, mag_threshold: float = 0.06,
                    coherence_threshold: float = 0.6, cell_size: int = 16,
                    max_keylines: int = 64, min_length: float = 12.0,
                    max_length: float = 200.0, perp_tol: float = 1.6,
                    suppress_radius: float = 8.0, border: int = 8):
    """Detect line segments into a fixed-capacity endpoint table, with
    thick-line masking over ``existing`` keylines and a max-length filter;
    the top ``max_keylines`` by length × edge strength.

    img: (H, W) float32 in [0, 1], H and W divisible by cell_size.
    existing_ep: (M, 2, 2) float32; existing_valid: (M,) bool.
    Returns ep (max_keylines, 2, 2) canonical endpoints, score
    (max_keylines,) float32, valid (max_keylines,) bool.
    A captured program: the float thresholds and lengths are keyed by value."""
    H, W = img.shape
    dev = img.device
    cs = cell_size
    sup = _cell_support(img, cs, mag_threshold)
    cell_ok = (sup["finite"] & (sup["n_edge"] >= cs)
               & (sup["coherence"] >= coherence_threshold)
               & (sup["perp_rms"] <= perp_tol) & (sup["extent"] >= 0.5 * cs))
    d = sup["dir"]
    horizontal = d[..., 0].abs() >= d[..., 1].abs()
    cos_tol = float(math.cos(math.radians(12.0)))
    emit_h, ep_h = _merge_runs(cell_ok & horizontal, d, sup["ep"], True, cos_tol,
                               0.75 * cs, 2.0)
    emit_v, ep_v = _merge_runs(cell_ok & ~horizontal, d, sup["ep"], False, cos_tol,
                               0.75 * cs, 2.0)
    emit = torch.cat([emit_h.reshape(-1), emit_v.reshape(-1)])
    eps = canonicalize_endpoints(torch.cat([ep_h.reshape(-1, 2, 2), ep_v.reshape(-1, 2, 2)]))
    strength = sup["strength"].reshape(-1).repeat(2)

    # clip segments to the border box (Liang-Barsky) instead of rejecting
    # lines that touch the image edge
    a, b = eps[:, 0], eps[:, 1]
    seg_d = b - a
    # (built from fills: a list copied to the card synchronises)
    lo_box = torch.full((2,), float(border), device=dev)
    hi_box = torch.cat([torch.full((1,), float(W - 1 - border), device=dev),
                        torch.full((1,), float(H - 1 - border), device=dev)])
    flat_axis = seg_d.abs() < 1e-9
    safe_d = torch.where(flat_axis, 1e-9, seg_d)
    t0 = (lo_box[None] - a) / safe_d
    t1 = (hi_box[None] - a) / safe_d
    t_enter = torch.where(flat_axis, 0.0, torch.minimum(t0, t1)).amax(-1)
    t_exit = torch.where(flat_axis, 1.0, torch.maximum(t0, t1)).amin(-1)
    t_lo = torch.clamp(t_enter, 0.0, 1.0)
    t_hi = torch.clamp(t_exit, 0.0, 1.0)
    # a segment flat on an axis must still start inside the box on that axis
    inside_static = torch.where(flat_axis, (a >= lo_box[None]) & (a <= hi_box[None]),
                                True).all(-1)
    clip_ok = (t_hi > t_lo) & inside_static
    eps = torch.stack([a + t_lo[:, None] * seg_d, a + t_hi[:, None] * seg_d], -2)
    length = torch.linalg.vector_norm(eps[:, 1] - eps[:, 0], dim=-1)
    ok = emit & clip_ok & (length >= min_length) & (length <= max_length)

    # thick-line masking: a candidate whose midpoint lies near an existing
    # segment is suppressed
    mid = 0.5 * (eps[:, 0] + eps[:, 1])
    ex_ep = torch.where(existing_valid[:, None, None], existing_ep, -1e6)
    dist = point_segment_distance(mid, ex_ep)
    near = (dist <= suppress_radius).any(-1) & existing_valid.any()
    ok = ok & ~near

    score = torch.where(ok, length * torch.sqrt(torch.clamp(strength, min=0.0)), 0.0)
    k = min(max_keylines, score.shape[0])
    top_score, top_i = torch.sort(score, descending=True, stable=True)
    top_score, top_i = top_score[:k], top_i[:k]
    top_ep = eps[top_i]
    valid = top_score > 0.0
    if k < max_keylines:
        pad = max_keylines - k
        top_score = torch.cat([top_score, top_score.new_zeros(pad)])
        top_ep = torch.cat([top_ep, top_ep.new_zeros((pad, 2, 2))])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return top_ep, top_score, valid


@functools.partial(Program, static_argnames=("n_along", "n_perp"), copy_outputs=True)
def keyline_descriptors(img, ep, valid, n_along: int = 16, n_perp: int = 16,
                        perp_step: float = 1.0):
    """Line-aligned binary descriptor, (L, 8) int32 words (uint32 bit
    patterns): an n_along × n_perp intensity patch sampled in the (direction,
    normal) frame of the canonical segment, each sample compared with the
    patch mean; invalid rows are zero.
    A captured program: ``perp_step`` is keyed by value."""
    ep = canonicalize_endpoints(ep)
    a, b = ep[:, 0], ep[:, 1]
    d = b - a
    length = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    d = d / torch.clamp(length, min=1e-6)
    n = torch.stack([-d[:, 1], d[:, 0]], -1)
    ts = torch.linspace(0.08, 0.92, n_along, dtype=torch.float32, device=img.device)
    os_ = (torch.arange(n_perp, dtype=torch.float32, device=img.device)
           - (n_perp - 1) / 2.0) * perp_step
    centers = a[:, None, :] + ts[None, :, None] * length[:, None, :] * d[:, None, :]
    pts = centers[:, :, None, :] + os_[None, None, :, None] * n[:, None, None, :]
    samp = bilinear_sample(img, pts.reshape(-1, 2)).reshape(ep.shape[0], n_along * n_perp)
    bits = (samp > samp.mean(-1, keepdim=True)) & valid[:, None]
    return pack_bits(bits)
