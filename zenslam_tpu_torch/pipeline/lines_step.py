"""Per-frame keyline stages, the line analogue of the keypoint path —
counterpart of ``zenslam_tpu/pipeline/lines_step.py``.

- ``line_temporal_track``: endpoint KLT prev -> cur with projected-landmark
  initial flow and the forward-backward check; both endpoints must survive;
- ``line_detect_topup``: detection into free slots, masked by live keylines;
- ``line_associate``: landmark-less keylines to 3D lines by descriptor
  within a projected-midpoint radius;
- ``line_stereo_triangulate``: L -> R endpoint transfer, epipolar gate,
  endpoint DLT with depth and reprojection gates, and the 45°-135°
  line-vs-epipolar direction gate;
- ``line_map_update``: fresh 3D lines into the map (LRU eviction) and the
  observation counters;
- ``line_pose_correspondences``: endpoint 3D-2D pairs for the pose cascade.

Endpoints go through LK as a flat (2L, 2) point batch (the caller's
``lk_fb``: the hand kernel on the kernel path). Every table is fixed
capacity and masked; the reference's drop-mode scatters go through
``frontend/tables.scatter_drop``. No stage reads the device back.
"""

from __future__ import annotations

import torch

from zenslam_tpu_torch.frontend.tables import (
    allocate_landmark_slots, insert_into_free_slots, scatter_drop)
from zenslam_tpu_torch.geometry.camera import StereoRig, project
from zenslam_tpu_torch.geometry.lie import se3_apply, se3_inverse
from zenslam_tpu_torch.geometry.triangulate import epipolar_residual, triangulate_dlt
from zenslam_tpu_torch.ops.lines import canonicalize_endpoints, detect_keylines
from zenslam_tpu_torch.ops.match import match_descriptors, radius_gate
from zenslam_tpu_torch.pipeline.state import Line3dMap, LineTable, SlamConfig

_I32 = torch.int32


def _flat(ep):
    """(L, 2, 2) endpoint table -> (2L, 2) point batch."""
    return ep.reshape(-1, 2)


def _pair(mask):
    """(L,) -> (2L,): each keyline's flag for both of its endpoints."""
    return mask[:, None].expand(-1, 2).reshape(-1)


def _attached(M: int, lines: LineTable):
    """(M,) bool: map slots referenced by a live keyline."""
    idx = torch.where(lines.valid & (lines.lm_idx >= 0), lines.lm_idx, M)
    return scatter_drop(torch.zeros(M, dtype=torch.bool, device=idx.device), idx, True)


def line_temporal_track(cfg: SlamConfig, rig: StereoRig, lines: LineTable,
                        line_map: Line3dMap, lk_fb, R_pred, t_pred, img_shape):
    """Endpoint KLT prev -> cur; a keyline survives when both endpoints
    track and its new length passes the gate. ``lk_fb(pts, valid,
    init_pts=)`` returns (tracked, ok, err). Returns (lines, n_tracked)."""
    L = lines.ep.shape[0]
    H, W = img_shape
    has_lm = (lines.lm_idx >= 0) & lines.valid
    lm_ep = line_map.xyz[lines.lm_idx.clamp(min=0).long()]   # (L, 2, 3)
    xc = se3_apply(R_pred, t_pred, lm_ep.reshape(-1, 3))
    proj = project(rig.left, xc)
    in_view = ((xc[:, 2] > 0.1) & (proj[:, 0] >= 0) & (proj[:, 0] < W)
               & (proj[:, 1] >= 0) & (proj[:, 1] < H)).reshape(L, 2)
    proj_ok = has_lm & in_view[:, 0] & in_view[:, 1]
    init = torch.where(proj_ok[:, None, None], proj.reshape(L, 2, 2), lines.ep)

    ep_valid = _pair(lines.valid)
    tracked, ok, _ = lk_fb(_flat(lines.ep), ep_valid, init_pts=_flat(init))
    ok2 = ok.reshape(L, 2)
    new_ep = tracked.reshape(L, 2, 2)
    both = ok2[:, 0] & ok2[:, 1] & lines.valid
    # length / degenerate gate after tracking
    length = torch.linalg.vector_norm(new_ep[:, 1] - new_ep[:, 0], dim=-1)
    both = both & (length >= 0.5 * cfg.line_min_length) & (length <= 1.5 * cfg.line_max_length)
    lines = lines._replace(
        ep=torch.where(both[:, None, None], canonicalize_endpoints(new_ep), lines.ep),
        valid=both,
        age=torch.where(both, lines.age + 1, 0).to(_I32))
    return lines, both.sum()


def line_detect_topup(cfg: SlamConfig, img_l, lines: LineTable, next_line_id):
    """Detect into free slots with masking over live keylines. Returns
    (lines, n_placed, next_line_id)."""
    det_ep, det_score, det_valid = detect_keylines(
        img_l, lines.ep, lines.valid, mag_threshold=cfg.line_mag_threshold,
        max_keylines=cfg.max_keylines, min_length=cfg.line_min_length,
        max_length=cfg.line_max_length)
    slot, placed = insert_into_free_slots(~lines.valid, det_score, det_valid)
    sl = torch.where(placed, slot, cfg.max_keylines)
    rank = torch.cumsum(placed.to(torch.int64), 0) - 1
    new_ids = (next_line_id + rank).to(_I32)
    n_placed = placed.sum()
    lines = lines._replace(
        ep=scatter_drop(lines.ep, sl, det_ep),
        valid=scatter_drop(lines.valid, sl, placed),
        lm_idx=scatter_drop(lines.lm_idx, sl, -1),
        track_id=scatter_drop(lines.track_id, sl, new_ids),
        age=scatter_drop(lines.age, sl, 0),
        stereo_ok=scatter_drop(lines.stereo_ok, sl, False))
    return lines, n_placed, (next_line_id + n_placed).to(_I32)


def line_associate(cfg: SlamConfig, rig: StereoRig, lines: LineTable, line_map: Line3dMap,
                   R_pred, t_pred):
    """Landmark-less keylines to unattached, in-front 3D lines by
    descriptor within 30 px of the projected midpoint. Returns (lines,
    n_associated)."""
    M = line_map.valid.shape[0]
    mid3d = 0.5 * (line_map.xyz[:, 0] + line_map.xyz[:, 1])
    xc = se3_apply(R_pred, t_pred, mid3d)
    proj = project(rig.left, xc)
    assignable = line_map.valid & (xc[:, 2] > 0.1) & (~_attached(M, lines))
    free = lines.valid & (lines.lm_idx < 0)
    mid2d = 0.5 * (lines.ep[:, 0] + lines.ep[:, 1])
    idx, _, ok = match_descriptors(
        lines.desc, line_map.desc, free, assignable, max_distance=cfg.line_match_distance,
        cross_check=True, gate_mask=radius_gate(mid2d, proj, 30.0))
    new_lm = torch.where(ok & free, idx, lines.lm_idx).to(_I32)
    return lines._replace(lm_idx=new_lm), (ok & free).sum()


def _epipolar_cos_limit(min_deg: float) -> float:
    """cos of the gate angle, rounded as float32 arithmetic gives it."""
    return float(torch.cos(torch.deg2rad(torch.tensor(min_deg, dtype=torch.float32))))


def line_stereo_triangulate(cfg: SlamConfig, rig: StereoRig, lines: LineTable,
                            lk_fb_stereo, F_rig):
    """L -> R endpoint transfer, epipolar gate, endpoint DLT with depth and
    reprojection gates, and the direction gate at the midpoint (a line
    parallel to the epipolar direction triangulates degenerately). Returns
    (lines with ep_r and stereo_ok, X_cam (L, 2, 3), tri_ok (L,))."""
    L = lines.ep.shape[0]
    ep_valid = _pair(lines.valid)
    flat = _flat(lines.ep)
    uv_r, ok, _ = lk_fb_stereo(flat, ep_valid)
    ok = ok & (epipolar_residual(F_rig, flat, uv_r) < cfg.epipolar_threshold)

    eye = torch.eye(3, dtype=torch.float32, device=flat.device)
    zero = torch.zeros(3, dtype=torch.float32, device=flat.device)
    X_cam = triangulate_dlt(rig.left.K, eye, zero, rig.right.K, rig.R_rl, rig.t_rl,
                            flat, uv_r)
    z = X_cam[:, 2]
    x_r = se3_apply(rig.R_rl, rig.t_rl, X_cam)
    err_l = torch.linalg.vector_norm(project(rig.left, X_cam) - flat, dim=-1)
    err_r = torch.linalg.vector_norm(project(rig.right, x_r) - uv_r, dim=-1)
    pt_ok = (ok & (z > cfg.min_depth) & (z < cfg.max_depth) & (x_r[:, 2] > 0)
             & (err_l < cfg.reprojection_threshold) & (err_r < cfg.reprojection_threshold))
    ok2 = pt_ok.reshape(L, 2)
    st_ok = ok2[:, 0] & ok2[:, 1] & lines.valid

    # direction vs epipolar direction at the midpoint
    d = lines.ep[:, 1] - lines.ep[:, 0]
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-6)
    mid = 0.5 * (lines.ep[:, 0] + lines.ep[:, 1])
    mid_h = torch.cat([mid, torch.ones_like(mid[:, :1])], -1)
    l_ep = mid_h @ F_rig.T
    e_dir = torch.stack([-l_ep[:, 1], l_ep[:, 0]], -1)
    e_dir = e_dir / torch.clamp(torch.linalg.vector_norm(e_dir, dim=-1, keepdim=True),
                                min=1e-9)
    cos_a = (d * e_dir).sum(-1).abs()
    tri_ok = st_ok & (cos_a <= _epipolar_cos_limit(cfg.line_epipolar_min_deg))

    lines = lines._replace(ep_r=uv_r.reshape(L, 2, 2), stereo_ok=st_ok)
    return lines, X_cam.reshape(L, 2, 3), tri_ok


def line_map_update(cfg: SlamConfig, lines: LineTable, line_map: Line3dMap, X_cam_ep,
                    tri_ok, R_cw, t_cw, frame_idx):
    """Insert fresh 3D lines (free slots first, then the stalest
    unprotected) and bump last_seen / n_obs of the observed ones. Returns
    (lines, line_map, n_placed)."""
    M = line_map.valid.shape[0]
    Rwc, twc = se3_inverse(R_cw, t_cw)
    X_w = se3_apply(Rwc, twc, X_cam_ep.reshape(-1, 3)).reshape(-1, 2, 3)
    new_cand = lines.valid & (lines.lm_idx < 0) & tri_ok
    depth = 0.5 * (X_cam_ep[:, 0, 2] + X_cam_ep[:, 1, 2])
    score = torch.where(new_cand, 1.0 / torch.clamp(depth, min=0.1), float("-inf"))
    slot, placed = allocate_landmark_slots(line_map.valid, line_map.last_seen,
                                           _attached(M, lines), score, new_cand)
    sl = torch.where(placed, slot, M)
    line_map = line_map._replace(
        xyz=scatter_drop(line_map.xyz, sl, X_w),
        desc=scatter_drop(line_map.desc, sl, lines.desc),
        valid=scatter_drop(line_map.valid, sl, placed),
        last_seen=scatter_drop(line_map.last_seen, sl, frame_idx),
        n_obs=scatter_drop(line_map.n_obs, sl, 1))
    lines = lines._replace(lm_idx=torch.where(placed, slot, lines.lm_idx).to(_I32))
    obs = torch.where(lines.valid & (lines.lm_idx >= 0), lines.lm_idx, M)
    line_map = line_map._replace(
        last_seen=scatter_drop(line_map.last_seen, obs, frame_idx),
        n_obs=scatter_drop(line_map.n_obs, obs, 1, accumulate=True))
    return lines, line_map, placed.sum()


def line_pose_correspondences(lines: LineTable, line_map: Line3dMap):
    """Endpoint 3D-2D pairs of tracked, mapped keylines for the cam0 PnP:
    X (2L, 3), uv (2L, 2), valid (2L,)."""
    has_lm = lines.valid & (lines.lm_idx >= 0) & (lines.age > 0)
    X = line_map.xyz[lines.lm_idx.clamp(min=0).long()].reshape(-1, 3)
    return X, _flat(lines.ep), _pair(has_lm)
