"""The per-frame SLAM step — counterpart of ``zenslam_tpu/pipeline/step.py:
slam_step`` under the configurations ``check_supported`` accepts.

Stages, in the reference's order: pyramid pair → predict → temporal KLT →
FAST top-up → ORB describe → associate → temporal rematch → stereo KLT and
triangulation → pose cascade → map update → keyframe decision → motion
update → telemetry.

On the kernel path (``resolve_use_kernels``) the two KLT stages run
``ops/lk_cuda.lk_ragged`` and the describe stage ``ops/orb_cuda``; otherwise
the f32 gather fallbacks the reference runs off-TPU. The reference's
``.at[].set(mode="drop")`` scatters become explicit masks: dropped rows go to
a spare row past the end of the table (``frontend/tables.scatter_drop``).
"""

from __future__ import annotations

import torch

from zenslam_tpu_torch.estimation.cascade import (
    CascadeNoise, draw_cascade_noise, estimate_pose_cascade)
from zenslam_tpu_torch.frontend.tables import (
    allocate_landmark_slots, insert_into_free_slots, scatter_drop as _scatter)
from zenslam_tpu_torch.geometry.camera import (
    StereoRig, essential_from_pose, fundamental_from_rig, project)
from zenslam_tpu_torch.geometry.lie import (
    rotation_angle, se3_apply, se3_compose, se3_inverse, so3_exp, so3_log)
from zenslam_tpu_torch.geometry.triangulate import epipolar_residual, triangulate_dlt
from zenslam_tpu_torch.ops.fast import detect_grid_keypoints
from zenslam_tpu_torch.ops.image import clahe
from zenslam_tpu_torch.ops.lk import (
    build_ragged_pyramid_pair, lk_forward_backward, ragged_to_stacked)
from zenslam_tpu_torch.ops.lk_cuda import lk_ragged
from zenslam_tpu_torch.ops.match import epipolar_gate, match_descriptors, radius_gate
from zenslam_tpu_torch.ops.orb import orb_descriptors
from zenslam_tpu_torch.ops.orb_cuda import orb_descriptors_kernel
from zenslam_tpu_torch.pipeline.state import (
    FeatureTable, FrameTelemetry, MotionModel, SlamConfig, SlamState,
    check_supported, frame_generator, pyramid_dtype, resolve_use_kernels)

_I32 = torch.int32


def _mark(n: int, idx, device):
    """(n,) bool with True at ``idx`` (indices equal to n dropped)."""
    return _scatter(torch.zeros(n, dtype=torch.bool, device=device), idx, True)


def _predict_pose(state: SlamState):
    """Constant-acceleration prediction: Δt = vel + ½·acc, ΔR = exp(...)."""
    mm = state.motion
    use_acc = (mm.n_updates >= 2).to(torch.float32)
    t_rel = mm.vel + 0.5 * use_acc * mm.acc
    R_rel = so3_exp(mm.vel_ang + 0.5 * use_acc * mm.acc_ang)
    R_pred, t_pred = se3_compose(R_rel, t_rel, state.R_cw, state.t_cw)
    ok = mm.n_updates >= 1
    return torch.where(ok, R_pred, state.R_cw), torch.where(ok, t_pred, state.t_cw)


def _lk_fb(cfg: SlamConfig, use_kernels: bool, prev_pyr, next_pyr, pts, valid,
           init_pts=None):
    """fwd-bwd KLT: the hand kernel (per-level schedule, shallow backward
    pass, no residual) or the f32 gather fallback."""
    if use_kernels:
        iters = (cfg.klt_iters,) + (cfg.klt_coarse_iters,) * (len(prev_pyr) - 1)
        return lk_ragged(prev_pyr, next_pyr, pts, valid, init_pts=init_pts,
                         radius=cfg.klt_radius, iters=iters,
                         bwd_levels=cfg.klt_bwd_levels, compute_err=False,
                         fb_threshold=cfg.fb_threshold)
    return lk_forward_backward(ragged_to_stacked(prev_pyr), ragged_to_stacked(next_pyr),
                               pts, valid, init_pts=init_pts, radius=cfg.klt_radius,
                               iters=cfg.klt_iters, fb_threshold=cfg.fb_threshold)


def _temporal_track(cfg, use_k, rig, state, pyr_l, R_pred, t_pred):
    """KLT prev-L → cur-L, initial flow from the projected landmark."""
    feats = state.features
    has_lm = (feats.lm_idx >= 0) & feats.valid
    lm_xyz = state.lmap.xyz[feats.lm_idx.clamp(min=0).long()]
    xc = se3_apply(R_pred, t_pred, lm_xyz)
    proj = project(rig.left, xc)
    H, W = pyr_l[0].shape
    proj_ok = (has_lm & (xc[:, 2] > 0.1) & (proj[:, 0] >= 0) & (proj[:, 0] < W)
               & (proj[:, 1] >= 0) & (proj[:, 1] < H))
    init_pts = torch.where(proj_ok[:, None], proj, feats.xy)
    tracked, ok, _ = _lk_fb(cfg, use_k, state.prev_pyr_l, pyr_l, feats.xy, feats.valid,
                            init_pts=init_pts)
    feats = feats._replace(
        xy=torch.where(ok[:, None], tracked, feats.xy),
        valid=ok,
        age=torch.where(ok, feats.age + 1, 0).to(_I32))
    return feats, ok.sum()


def _detect_topup(cfg, img_l, feats: FeatureTable, next_track_id):
    """FAST grid detection into free slots with fresh track ids."""
    det_xy, det_score, det_valid = detect_grid_keypoints(
        img_l, feats.xy, feats.valid, threshold=cfg.fast_threshold,
        cell_size=cfg.cell_size, max_keypoints=cfg.max_keypoints,
        border=cfg.detect_border, subpixel=cfg.subpixel_detect)
    slot, placed = insert_into_free_slots(~feats.valid, det_score, det_valid)
    n = feats.xy.shape[0]
    sl = torch.where(placed, slot, n)
    n_placed = placed.sum()
    rank = torch.cumsum(placed.to(torch.int64), 0) - 1
    new_ids = (next_track_id + rank).to(_I32)
    feats = feats._replace(
        xy=_scatter(feats.xy, sl, det_xy),
        valid=_scatter(feats.valid, sl, placed),
        lm_idx=_scatter(feats.lm_idx, sl, -1),
        track_id=_scatter(feats.track_id, sl, new_ids),
        age=_scatter(feats.age, sl, 0),
        stereo_ok=_scatter(feats.stereo_ok, sl, False))
    return feats, n_placed, (next_track_id + n_placed).to(_I32)


def _compute_descriptors(cfg, use_k, img_l, feats: FeatureTable):
    if use_k and cfg.orb_backend != "xla":
        desc, _ = orb_descriptors_kernel(img_l, feats.xy, feats.valid)
        return desc
    desc, _ = orb_descriptors(img_l, feats.xy, feats.valid)
    return desc


def _stereo_and_triangulate(cfg, use_k, rig: StereoRig, pyr_l, pyr_r,
                            feats: FeatureTable, F_rig):
    """L→R KLT + epipolar gate + DLT triangulation in the left camera frame."""
    uv_r, st_ok, _ = _lk_fb(cfg, use_k, pyr_l, pyr_r, feats.xy, feats.valid)
    st_ok = st_ok & (epipolar_residual(F_rig, feats.xy, uv_r) < cfg.epipolar_threshold)
    eye = torch.eye(3, dtype=torch.float32, device=uv_r.device)
    zero = torch.zeros(3, dtype=torch.float32, device=uv_r.device)
    X_cam = triangulate_dlt(rig.left.K, eye, zero, rig.right.K, rig.R_rl, rig.t_rl,
                            feats.xy, uv_r)
    z = X_cam[:, 2]
    x_r = se3_apply(rig.R_rl, rig.t_rl, X_cam)
    err_l = torch.linalg.vector_norm(project(rig.left, X_cam) - feats.xy, dim=-1)
    err_r = torch.linalg.vector_norm(project(rig.right, x_r) - uv_r, dim=-1)
    disparity = ((feats.xy[:, 0] - rig.left.cx) - (uv_r[:, 0] - rig.right.cx)).abs()
    tri_ok = (st_ok & (z > cfg.min_depth) & (z < cfg.max_depth) & (x_r[:, 2] > 0)
              & (err_l < cfg.reprojection_threshold)
              & (err_r < cfg.reprojection_threshold)
              & (disparity >= cfg.min_disparity))
    return feats._replace(uv_r=uv_r, stereo_ok=st_ok), X_cam, tri_ok


def _associate_landmarks(cfg, rig: StereoRig, feats: FeatureTable, lmap, R_pred, t_pred):
    """Landmark-less keypoints ↔ map landmarks by descriptor within a
    projected radius, over the frustum-culled, unattached landmarks."""
    M = lmap.valid.shape[0]
    xc = se3_apply(R_pred, t_pred, lmap.xyz)
    proj = project(rig.left, xc)
    in_frustum = (xc[:, 2] > 0.1) & (
        torch.linalg.vector_norm(xc, dim=-1) < cfg.landmark_search_radius)
    m = float(cfg.frustum_margin)
    w, h = float(rig.left.width), float(rig.left.height)
    if w > 0 and h > 0:
        in_frustum = in_frustum & ((proj[:, 0] >= -m) & (proj[:, 0] < w + m)
                                   & (proj[:, 1] >= -m) & (proj[:, 1] < h + m))
    live = feats.valid & (feats.lm_idx >= 0)
    attached = _mark(M, torch.where(live, feats.lm_idx, M), xc.device)
    assignable = lmap.valid & in_frustum & (~attached)
    free_kp = feats.valid & (feats.lm_idx < 0)
    gate = radius_gate(feats.xy, proj, 20.0)
    idx, _, ok = match_descriptors(feats.desc, lmap.desc, free_kp, assignable,
                                   max_distance=cfg.landmark_match_distance,
                                   cross_check=True, gate_mask=gate)
    new_lm_idx = torch.where(ok & free_kp, idx, feats.lm_idx).to(_I32)
    return feats._replace(lm_idx=new_lm_idx), (ok & free_kp).sum()


def _temporal_rematch(cfg, rig: StereoRig, feats: FeatureTable, prev_desc, prev_xy,
                      prev_lm_idx, prev_valid, track2d_ok, R_prev, t_prev,
                      R_pred, t_pred, lmap):
    """Previous-frame keypoints whose KLT track died but carried a landmark
    are matched by descriptor against the current landmark-less keypoints
    under the epipolar gate of the predicted relative motion."""
    N = feats.xy.shape[0]
    M = lmap.valid.shape[0]
    lost = prev_valid & (prev_lm_idx >= 0) & (~track2d_ok)
    live = feats.valid & (feats.lm_idx >= 0)
    attached = _mark(M, torch.where(live, feats.lm_idx, M), feats.xy.device)
    lost = lost & (~attached[prev_lm_idx.clamp(min=0).long()])
    free = feats.valid & (feats.lm_idx < 0)
    Rpi, tpi = se3_inverse(R_prev, t_prev)
    R_rel, t_rel = se3_compose(R_pred, t_pred, Rpi, tpi)
    E = essential_from_pose(R_rel, t_rel)
    Kinv = torch.linalg.inv(rig.left.K)
    F = Kinv.T @ E @ Kinv
    gate = epipolar_gate(F, prev_xy, feats.xy, cfg.temporal_match_epipolar)
    idx, _, ok = match_descriptors(prev_desc, feats.desc, lost, free,
                                   max_distance=cfg.landmark_match_distance,
                                   cross_check=True, gate_mask=gate)
    tgt = torch.where(ok, idx, N)
    new_lm = _scatter(feats.lm_idx, tgt, torch.where(ok, prev_lm_idx, -1))
    return feats._replace(lm_idx=new_lm), ok.sum()


def _keyframe_decision(cfg, state: SlamState, R_cw, t_cw, n_inliers, tracked_ratio):
    first = state.frame_idx == 0
    Ri, ti = se3_inverse(state.last_kf_R, state.last_kf_t)
    R_rel, t_rel = se3_compose(R_cw, t_cw, Ri, ti)
    trans = torch.linalg.vector_norm(t_rel)
    rot_deg = torch.rad2deg(rotation_angle(R_rel))
    n_since = state.frames_since_kf
    motion_trigger = (trans >= cfg.kf_min_translation) | (rot_deg >= cfg.kf_min_rotation_deg)
    quality_trigger = ((tracked_ratio <= cfg.kf_min_tracked_ratio)
                       | (n_inliers < cfg.kf_min_inliers))
    gap_ok = n_since >= cfg.kf_min_frames
    forced = n_since >= cfg.kf_max_frames
    return first | forced | (gap_ok & (motion_trigger | quality_trigger))


def slam_step(cfg: SlamConfig, rig: StereoRig, state: SlamState, img_l, img_r,
              noise: CascadeNoise | None = None, imu=None):
    """Process one stereo frame on the device its tensors live on. Returns
    (new_state, telemetry).

    img_l/img_r: (H, W) float32 in [0, 1]. noise: optional ``CascadeNoise``
    (Gumbel draws of the four RANSAC estimators); None draws them from the
    state's generator (seed, frame counter). imu: the reference's IMU batch;
    not ported yet, so anything but None raises NotImplementedError."""
    check_supported(cfg, imu)
    dev = img_l.device
    use_k = resolve_use_kernels(cfg, dev)
    N = cfg.max_keypoints
    if cfg.use_clahe:   # before the pyramid, detection and description
        img_l = clahe(img_l, clip_limit=cfg.clahe_clip)
        img_r = clahe(img_r, clip_limit=cfg.clahe_clip)
    pyr_l, pyr_r = build_ragged_pyramid_pair(img_l, img_r, cfg.pyramid_levels,
                                             dtype=pyramid_dtype(cfg, dev))
    F_rig = fundamental_from_rig(rig)

    # ---- PREDICT -----------------------------------------------------------
    R_pred, t_pred = _predict_pose(state)

    # ---- TRACK (temporal) --------------------------------------------------
    prev_xy = state.features.xy
    prev_lm_idx = state.features.lm_idx
    prev_desc = state.features.desc
    prev_feat_valid = state.features.valid
    feats, n_tracked = _temporal_track(cfg, use_k, rig, state, pyr_l, R_pred, t_pred)
    track2d_ok = feats.valid
    n_prev_valid = state.features.valid.sum()
    tracked_ratio = n_tracked / torch.clamp(n_prev_valid, min=1)

    # ---- DETECT top-up -----------------------------------------------------
    feats, n_detected, next_track_id = _detect_topup(cfg, img_l, feats, state.next_track_id)

    # ---- DESCRIBE ----------------------------------------------------------
    feats = feats._replace(desc=_compute_descriptors(cfg, use_k, img_l, feats))

    # ---- ASSOCIATE lost landmarks ------------------------------------------
    feats, _ = _associate_landmarks(cfg, rig, feats, state.lmap, R_pred, t_pred)

    # ---- TEMPORAL REMATCH --------------------------------------------------
    if cfg.use_temporal_rematch:
        feats, _ = _temporal_rematch(
            cfg, rig, feats, prev_desc, prev_xy, prev_lm_idx, prev_feat_valid,
            track2d_ok, state.R_cw, state.t_cw, R_pred, t_pred, state.lmap)

    # ---- STEREO + TRIANGULATE ----------------------------------------------
    feats, X_cam, tri_ok = _stereo_and_triangulate(cfg, use_k, rig, pyr_l, pyr_r,
                                                   feats, F_rig)

    # ---- ESTIMATE (cascade) ------------------------------------------------
    lmap = state.lmap
    M = lmap.valid.shape[0]
    has_lm = feats.valid & (feats.lm_idx >= 0)
    X_w_lm = lmap.xyz[feats.lm_idx.clamp(min=0).long()]
    corr0 = has_lm & (feats.age > 0)
    corr1 = corr0 & feats.stereo_ok
    Rwp, twp = se3_inverse(R_pred, t_pred)
    X_w_cur = se3_apply(Rwp, twp, X_cam)
    corr3d = has_lm & tri_ok
    ess_kwargs = {}
    if cfg.use_essential_fallback:
        prev_lm_xyz = lmap.xyz[prev_lm_idx.clamp(min=0).long()]
        ess_kwargs = dict(
            p2a=prev_xy, p2b=feats.xy, valid2=track2d_ok,
            X2_prev_cam=se3_apply(state.R_cw, state.t_cw, prev_lm_xyz),
            has3d2=track2d_ok & (prev_lm_idx >= 0),
            R_prev=state.R_cw, t_prev=state.t_cw,
            essential_threshold=cfg.essential_threshold)
    if noise is None:
        noise = draw_cascade_noise(frame_generator(state, dev), N, cfg.pnp_iters,
                                   cfg.rigid_iters, cfg.essential_iters, dev)
    expect = ((cfg.pnp_iters, N), (cfg.pnp_iters, N), (cfg.rigid_iters, N),
              (cfg.essential_iters, N))
    if tuple(tuple(x.shape) for x in noise) != expect:
        raise ValueError(f"noise shapes {[tuple(x.shape) for x in noise]} != {expect}")
    est = estimate_pose_cascade(
        noise, rig, X_w_lm, feats.xy, corr0, X_w_lm, feats.uv_r, corr1,
        X_w_cur, X_w_lm, corr3d, R_pred, t_pred,
        pnp_threshold=cfg.pnp_threshold, rigid_threshold=cfg.rigid_threshold,
        min_inliers=cfg.min_inliers, fuse=cfg.use_pose_fusion, **ess_kwargs)
    R_cw, t_cw = est.R, est.t

    # ---- MAP UPDATE --------------------------------------------------------
    Rwc, twc = se3_inverse(R_cw, t_cw)
    X_w_new = se3_apply(Rwc, twc, X_cam)
    new_lm_cand = feats.valid & (feats.lm_idx < 0) & tri_ok
    live = feats.valid & (feats.lm_idx >= 0)
    protect = _mark(M, torch.where(live, feats.lm_idx, M), dev)
    cand_score = torch.where(new_lm_cand, 1.0 / torch.clamp(X_cam[:, 2], min=0.1),
                             float("-inf"))
    slot, placed = allocate_landmark_slots(lmap.valid, lmap.last_seen, protect,
                                           cand_score, new_lm_cand)
    sl = torch.where(placed, slot, M)
    H, W = img_l.shape
    xi = torch.clamp(feats.xy[:, 0], 0.0, W - 1.001)
    yi = torch.clamp(feats.xy[:, 1], 0.0, H - 1.001)
    x0 = torch.floor(xi).long()
    y0 = torch.floor(yi).long()
    fxs, fys = xi - x0, yi - y0
    imf = img_l.float()
    inten = (imf[y0, x0] * (1 - fxs) * (1 - fys) + imf[y0, x0 + 1] * fxs * (1 - fys)
             + imf[y0 + 1, x0] * (1 - fxs) * fys + imf[y0 + 1, x0 + 1] * fxs * fys)
    lmap = lmap._replace(
        xyz=_scatter(lmap.xyz, sl, X_w_new),
        desc=_scatter(lmap.desc, sl, feats.desc),
        valid=_scatter(lmap.valid, sl, placed),
        last_seen=_scatter(lmap.last_seen, sl, state.frame_idx),
        n_obs=_scatter(lmap.n_obs, sl, 1),
        generation=_scatter(lmap.generation, sl, 1, accumulate=True),
        color=_scatter(lmap.color, sl, inten))
    feats = feats._replace(lm_idx=torch.where(placed, slot, feats.lm_idx).to(_I32))
    obs = torch.where(feats.valid & (feats.lm_idx >= 0), feats.lm_idx, M)
    lmap = lmap._replace(last_seen=_scatter(lmap.last_seen, obs, state.frame_idx),
                         n_obs=_scatter(lmap.n_obs, obs, 1, accumulate=True))
    if cfg.landmark_ema > 0.0:
        a = cfg.landmark_ema
        refine = feats.valid & (feats.lm_idx >= 0) & tri_ok & (~placed)
        old_xyz = lmap.xyz[feats.lm_idx.clamp(min=0).long()]
        lmap = lmap._replace(xyz=_scatter(lmap.xyz, torch.where(refine, feats.lm_idx, M),
                                          (1.0 - a) * old_xyz + a * X_w_new))

    # ---- KEYFRAME ----------------------------------------------------------
    is_kf = _keyframe_decision(cfg, state, R_cw, t_cw, est.n_inliers, tracked_ratio)
    last_kf_R = torch.where(is_kf, R_cw, state.last_kf_R)
    last_kf_t = torch.where(is_kf, t_cw, state.last_kf_t)
    frames_since_kf = torch.where(is_kf, 0, state.frames_since_kf + 1).to(_I32)

    # ---- MOTION UPDATE (EMA (new + old) / 2) -------------------------------
    Rpi, tpi = se3_inverse(state.R_cw, state.t_cw)
    R_rel, t_rel = se3_compose(R_cw, t_cw, Rpi, tpi)
    mm = state.motion
    vel_obs = t_rel
    ang_obs = so3_log(R_rel)
    first = mm.n_updates == 0
    motion = MotionModel(
        vel=torch.where(first, vel_obs, 0.5 * (vel_obs + mm.vel)),
        vel_ang=torch.where(first, ang_obs, 0.5 * (ang_obs + mm.vel_ang)),
        acc=torch.where(first, mm.acc, 0.5 * ((vel_obs - mm.vel) + mm.acc)),
        acc_ang=torch.where(first, mm.acc_ang, 0.5 * ((ang_obs - mm.vel_ang) + mm.acc_ang)),
        n_updates=(mm.n_updates + 1).to(_I32))

    new_state = SlamState(
        features=feats, lmap=lmap, R_cw=R_cw, t_cw=t_cw, motion=motion,
        last_kf_R=last_kf_R, last_kf_t=last_kf_t, frames_since_kf=frames_since_kf,
        frame_idx=(state.frame_idx + 1).to(_I32), next_track_id=next_track_id,
        prev_pyr_l=pyr_l, rng_seed=state.rng_seed, rng_step=state.rng_step + 1)
    zero = torch.zeros((), dtype=_I32, device=dev)
    telem = FrameTelemetry(
        n_tracked=n_tracked, n_detected=n_detected,
        n_stereo=(feats.stereo_ok & feats.valid).sum(), n_triangulated=tri_ok.sum(),
        n_pose_inliers=est.n_inliers, pose_method=est.method, pose_ok=est.ok,
        tracked_ratio=tracked_ratio, is_keyframe=is_kf, map_size=lmap.valid.sum(),
        n_lines=zero, n_line_triangulated=zero, line_map_size=zero,
        R_cw=R_cw, t_cw=t_cw)
    return new_state, telem
