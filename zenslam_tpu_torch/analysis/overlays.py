"""2D match / tracking overlay diagnostics — the port's own copy of
``zenslam_tpu/analysis/overlays.py``.

Per-keyframe overlay PNGs written by ``app --viz``: the stereo pair side by
side with its match lines (spatial) and the left image with the track
vectors since the previous keyframe (temporal), stitched with the timing
plots into one self-contained HTML report.

The rasterisation is the reference's numpy code as it stands, so the same
arrays draw the same pixels. The PNGs are 8-bit RGB written with the
standard library (``io.synthetic.write_png``), not matplotlib's RGBA, so
the overlays are written where matplotlib is absent; the decoded RGB
pixels are the reference's. ``save_keyframe_overlays`` reads a keyframe's
device tensors to the host in one packed copy.
"""

from __future__ import annotations

import html
import os

import numpy as np
import torch

from zenslam_tpu_torch.io.synthetic import write_png

# palette (RGB u8)
_GREEN = np.array([60, 205, 90], np.uint8)     # tracked / stereo-matched
_RED = np.array([230, 70, 60], np.uint8)       # lost / unmatched
_CYAN = np.array([80, 190, 230], np.uint8)     # stereo match lines
_YELLOW = np.array([235, 200, 70], np.uint8)   # new detections


def _to_rgb(img) -> np.ndarray:
    """Grayscale float [0,1] or u8 -> (H, W, 3) u8."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    return a.copy()


def _draw_segments(canvas: np.ndarray, p0: np.ndarray, p1: np.ndarray,
                   color: np.ndarray, alpha: float = 1.0) -> None:
    """Rasterize line segments (K,2)->(K,2) by dense sampling (vectorized)."""
    if len(p0) == 0:
        return
    H, W = canvas.shape[:2]
    d = p1 - p0
    n_steps = int(np.clip(np.max(np.abs(d)) if d.size else 1, 1, 4096))
    t = np.linspace(0.0, 1.0, n_steps + 1)[None, :, None]          # (1,S,1)
    pts = p0[:, None, :] + d[:, None, :] * t                       # (K,S,2)
    xs = np.clip(pts[..., 0].round().astype(int).ravel(), 0, W - 1)
    ys = np.clip(pts[..., 1].round().astype(int).ravel(), 0, H - 1)
    if alpha >= 1.0:
        canvas[ys, xs] = color
    else:
        canvas[ys, xs] = (canvas[ys, xs] * (1 - alpha)
                          + color * alpha).astype(np.uint8)


def _draw_points(canvas: np.ndarray, xy: np.ndarray, color: np.ndarray,
                 size: int = 1) -> None:
    if len(xy) == 0:
        return
    H, W = canvas.shape[:2]
    x = xy[:, 0].round().astype(int)
    y = xy[:, 1].round().astype(int)
    for dy in range(-size, size + 1):
        for dx in range(-size, size + 1):
            xs = np.clip(x + dx, 0, W - 1)
            ys = np.clip(y + dy, 0, H - 1)
            canvas[ys, xs] = color


def draw_spatial_overlay(left, right, xy, uv_r, stereo_ok, valid):
    """Side-by-side stereo pair with match lines.

    Green squares: left keypoints with a stereo match (line to the right
    view's position); red squares: left keypoints without one."""
    L, R = _to_rgb(left), _to_rgb(right)
    H, W = L.shape[:2]
    canvas = np.concatenate([L, R], axis=1)
    xy = np.asarray(xy)
    uv_r = np.asarray(uv_r)
    ok = np.asarray(stereo_ok) & np.asarray(valid)
    bad = (~np.asarray(stereo_ok)) & np.asarray(valid)
    p1 = uv_r[ok] + np.array([W, 0.0])
    _draw_segments(canvas, xy[ok], p1, _CYAN, alpha=0.55)
    _draw_points(canvas, xy[ok], _GREEN)
    _draw_points(canvas, p1, _GREEN)
    _draw_points(canvas, xy[bad], _RED)
    return canvas


def draw_temporal_overlay(img, prev_xy, cur_xy, prev_id, cur_id,
                          prev_valid, cur_valid):
    """Current left image with track motion vectors.

    Joins the previous and current keyframe feature tables on track_id:
    green vectors = features tracked across the gap, yellow = newly
    detected this keyframe, red = previous features that died."""
    canvas = _to_rgb(img)
    prev_xy = np.asarray(prev_xy)
    cur_xy = np.asarray(cur_xy)
    pid = np.asarray(prev_id)[np.asarray(prev_valid)]
    cid = np.asarray(cur_id)[np.asarray(cur_valid)]
    pxy = prev_xy[np.asarray(prev_valid)]
    cxy = cur_xy[np.asarray(cur_valid)]
    common, pi, ci = np.intersect1d(pid, cid, return_indices=True)
    _draw_segments(canvas, pxy[pi], cxy[ci], _GREEN, alpha=0.8)
    _draw_points(canvas, cxy[ci], _GREEN)
    new_mask = ~np.isin(cid, common)
    _draw_points(canvas, cxy[new_mask], _YELLOW)
    dead_mask = ~np.isin(pid, common)
    _draw_points(canvas, pxy[dead_mask], _RED)
    return canvas


def to_host(*xs) -> list:
    """numpy arrays of ``xs`` (tensors on one device, or arrays), the
    tensors in one copy: their bytes packed into one buffer where they lie,
    copied to the host, and split again there."""
    ts = [x.detach().contiguous().reshape(-1).view(torch.uint8)
          for x in xs if isinstance(x, torch.Tensor)]
    buf = torch.cat(ts).cpu().numpy() if ts else None
    out, off = [], 0
    for x in xs:
        if not isinstance(x, torch.Tensor):
            out.append(np.asarray(x))
            continue
        n = x.numel() * x.element_size()
        dtype = torch.empty(0, dtype=x.dtype).numpy().dtype
        out.append(buf[off:off + n].view(dtype).reshape(tuple(x.shape)))
        off += n
    return out


def save_keyframe_overlays(viz_dir: str, frame_idx: int, left, right,
                           snap, prev_snap=None) -> dict:
    """Write spatial_/temporal_ overlay PNGs for one keyframe from its
    ``KfSnap`` and its rectified images (tensors on any device, or arrays):
    what it draws reaches the host in one packed copy. Returns an entry
    dict for the HTML report."""
    os.makedirs(viz_dir, exist_ok=True)
    prev = () if prev_snap is None else (prev_snap.xy, prev_snap.track_id, prev_snap.valid)
    left, right, xy, uv_r, track_id, ok, valid, *prev = to_host(
        left, right, snap.xy, snap.uv_r, snap.track_id, snap.stereo_ok, snap.valid, *prev)
    sp = draw_spatial_overlay(left, right, xy, uv_r, ok, valid)
    sp_name = f"spatial_{frame_idx:05d}.png"
    write_png(os.path.join(viz_dir, sp_name), sp)
    entry = {"frame": frame_idx, "spatial": sp_name,
             "n_valid": int(valid.sum()), "n_stereo": int((ok & valid).sum())}
    if prev:
        prev_xy, prev_id, prev_valid = prev
        tp = draw_temporal_overlay(left, prev_xy, xy, prev_id, track_id, prev_valid, valid)
        tp_name = f"temporal_{frame_idx:05d}.png"
        write_png(os.path.join(viz_dir, tp_name), tp)
        entry["temporal"] = tp_name
        entry["n_tracked_across"] = int(len(np.intersect1d(prev_id[prev_valid],
                                                           track_id[valid])))
    return entry


def export_viz_report(output_dir: str, entries, timing_pngs=()) -> str:
    """One self-contained HTML report stitching the per-keyframe overlays
    with the timing/feature plots."""
    viz_rel = "viz"
    rows = []
    for e in entries:
        cells = [f"<h3>keyframe @ frame {e['frame']} — "
                 f"{e['n_valid']} features, {e['n_stereo']} stereo matches"
                 + (f", {e['n_tracked_across']} tracked across"
                    if "n_tracked_across" in e else "") + "</h3>"]
        cells.append(f'<img src="{viz_rel}/{html.escape(e["spatial"])}" '
                     f'alt="spatial"><div class="cap">stereo matches '
                     f'(green=matched, red=left-only, cyan=match line)</div>')
        if "temporal" in e:
            cells.append(f'<img src="{viz_rel}/{html.escape(e["temporal"])}" '
                         f'alt="temporal"><div class="cap">temporal tracks '
                         f'(green=tracked, yellow=new, red=lost)</div>')
        rows.append("<div class='kf'>" + "\n".join(cells) + "</div>")
    plots = "".join(f'<img src="{html.escape(p)}" class="plot">'
                    for p in timing_pngs)
    doc = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>zenslam_tpu diagnostics</title>
<style>body{{background:#101014;color:#ddd;font:13px sans-serif;margin:16px}}
img{{max-width:100%;display:block;margin:4px 0}}
.kf{{border-top:1px solid #333;padding:8px 0}}
.cap{{color:#888;margin-bottom:10px}}</style></head><body>
<h1>zenslam_tpu run diagnostics</h1>
<p>{len(entries)} keyframes · spatial ≡ opencv_window stereo view ·
temporal ≡ opencv_window track view</p>
{plots}
{''.join(rows)}
</body></html>"""
    path = os.path.join(output_dir, "diagnostics.html")
    with open(path, "w") as f:
        f.write(doc)
    return path
