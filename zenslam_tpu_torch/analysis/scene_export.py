"""Headless 3D scene export: coloured landmark PLY, a self-contained
interactive HTML view and a matplotlib snapshot — the port's own copy of
``zenslam_tpu/analysis/scene_export.py``, reading this package's
``SlamSystem`` (tensors on any device).

- ``export_ply``: ASCII PLY of the landmark cloud with per-point gray colour;
- ``export_scene_html``: one HTML file (inline data, canvas JS, no network)
  with the cloud, estimated and groundtruth trajectories and keyframe
  frusta;
- ``export_scene_png``: the same scene as a matplotlib 3D snapshot (needs
  matplotlib; ``export_scene`` skips it without).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def collect_scene(system, est_positions=None, gt_positions=None):
    """Pull the renderable scene out of a SlamSystem: landmark positions +
    colors (live map ∪ dormant archive), keyframe poses, trajectories."""
    lmap = system.state.lmap
    valid = _np(lmap.valid)
    xyz = _np(lmap.xyz)[valid]
    col = _np(lmap.color)[valid]
    if system.archive is not None and len(system.archive):
        dorm = system.archive.dormant
        if dorm.any():
            xyz = np.concatenate([xyz, system.archive.xyz[dorm]])
            col = np.concatenate([col, system.archive.color[dorm]])
    db = system.kf_db
    kv = _np(db.valid)
    order = np.argsort(_np(db.frame_idx)[kv])
    kf_R = _np(db.R)[kv][order]
    kf_t = _np(db.t)[kv][order]
    # 3D keyline segments of the line map (empty when keylines are off or
    # the state has no line map)
    lm3 = getattr(system.state, "line_map", None)
    lines = (_np(lm3.xyz)[_np(lm3.valid)] if lm3 is not None
             else np.zeros((0, 2, 3), np.float32))
    return {
        "points": xyz.astype(np.float32),
        "colors": np.clip(col, 0.0, 1.0).astype(np.float32),
        "lines": lines.astype(np.float32),
        "kf_R": kf_R.astype(np.float32),
        "kf_t": kf_t.astype(np.float32),
        "est": (np.asarray(est_positions, np.float32)
                if est_positions is not None and len(est_positions)
                else np.zeros((0, 3), np.float32)),
        "gt": (np.asarray(gt_positions, np.float32)
               if gt_positions is not None and len(gt_positions)
               else np.zeros((0, 3), np.float32)),
    }


def export_ply(path: str, points: np.ndarray, colors=None) -> None:
    """ASCII PLY point cloud; ``colors`` is (N,) gray in [0,1] or (N,3) RGB."""
    n = len(points)
    if colors is None:
        colors = np.full(n, 0.7, np.float32)
    colors = np.asarray(colors)
    if colors.ndim == 1:
        colors = np.stack([colors] * 3, axis=-1)
    rgb = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(points, rgb):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")


def read_ply(path: str):
    """Minimal reader for the files export_ply writes (tests/tools)."""
    with open(path) as f:
        line = f.readline()
        assert line.strip() == "ply"
        n = 0
        while True:
            line = f.readline()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line.strip() == "end_header":
                break
        rows = [f.readline().split() for _ in range(n)]
    pts = np.asarray([[float(x) for x in r[:3]] for r in rows], np.float32)
    rgb = np.asarray([[int(x) for x in r[3:6]] for r in rows], np.uint8)
    return pts, rgb


def _frustum_segments(R, t, scale=0.15):
    """Line segments of one camera frustum (world frame); R,t world->cam."""
    c = -R.T @ t
    corners_cam = np.array([[-1, -0.75, 1.5], [1, -0.75, 1.5],
                            [1, 0.75, 1.5], [-1, 0.75, 1.5]]) * scale
    corners = corners_cam @ R + c  # R.T.T = R applied as cam->world on rows
    segs = []
    for i in range(4):
        segs.append([c, corners[i]])
        segs.append([corners[i], corners[(i + 1) % 4]])
    return segs


# the figure style and fixed categorical palette of the reference's plots
PALETTE = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100",
           "#e87ba4", "#008300", "#4a3aa7", "#e34948"]
_STYLE = {
    "figure.facecolor": "#fcfcfb", "axes.facecolor": "#fcfcfb", "axes.edgecolor": "#898781",
    "axes.labelcolor": "#0b0b0b", "axes.grid": True, "grid.color": "#e1e0d9",
    "grid.linewidth": 0.8, "axes.spines.top": False, "axes.spines.right": False,
    "xtick.color": "#898781", "ytick.color": "#898781", "text.color": "#0b0b0b",
    "lines.linewidth": 2.0, "legend.frameon": False, "font.size": 10,
}

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>zenslam_tpu scene</title>
<style>body{margin:0;background:#101014;color:#ddd;font:12px sans-serif}
#hud{position:fixed;top:8px;left:10px}</style></head>
<body><canvas id="c"></canvas><div id="hud"></div>
<script>
const SCENE = __SCENE_JSON__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; function resize(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
resize(); addEventListener('resize', ()=>{resize(); draw();});
// center/scale the scene
const pts = SCENE.points;
let cx=0,cy=0,cz=0;
for (const p of pts){cx+=p[0];cy+=p[1];cz+=p[2];}
const n = Math.max(pts.length,1); cx/=n; cy/=n; cz/=n;
let rad=1e-3;
for (const p of pts){const d=Math.hypot(p[0]-cx,p[1]-cy,p[2]-cz); if(d>rad&&d<1e4)rad=d;}
let yaw=0.6, pitch=0.4, dist=2.2*rad;
function proj(p){
  let x=p[0]-cx, y=p[1]-cy, z=p[2]-cz;
  let x1=x*Math.cos(yaw)+z*Math.sin(yaw), z1=-x*Math.sin(yaw)+z*Math.cos(yaw);
  let y1=y*Math.cos(pitch)-z1*Math.sin(pitch), z2=y*Math.sin(pitch)+z1*Math.cos(pitch);
  const zc=z2+dist; if (zc<=0.05) return null;
  const f=0.9*Math.min(W,H);
  return [W/2+f*x1/zc, H/2+f*y1/zc, zc];
}
function polyline(arr, color, width){
  ctx.strokeStyle=color; ctx.lineWidth=width; ctx.beginPath(); let started=false;
  for (const p of arr){const q=proj(p); if(!q){started=false;continue;}
    if(!started){ctx.moveTo(q[0],q[1]);started=true;} else ctx.lineTo(q[0],q[1]);}
  ctx.stroke();
}
function draw(){
  ctx.fillStyle='#101014'; ctx.fillRect(0,0,W,H);
  for (let i=0;i<pts.length;i++){
    const q=proj(pts[i]); if(!q) continue;
    const g=Math.round(80+170*SCENE.colors[i]);
    ctx.fillStyle=`rgb(${g},${g},${g})`;
    const s=Math.max(1, 3*rad/q[2]); ctx.fillRect(q[0],q[1],s,s);
  }
  for (const seg of SCENE.frusta) polyline(seg, '#4a90d9', 1);
  for (const seg of SCENE.lines) polyline(seg, '#d9c04a', 1.5);
  polyline(SCENE.gt, '#30c060', 2);
  polyline(SCENE.est, '#e87d2f', 2);
  document.getElementById('hud').textContent =
    `${pts.length} landmarks · ${SCENE.lines.length} keylines · ` +
    `${SCENE.frusta.length/8} keyframes · ` +
    `orange=estimated  green=groundtruth  yellow=3D keylines · ` +
    `drag to rotate, wheel to zoom`;
}
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
onmouseup=()=>drag=null;
onmousemove=e=>{if(!drag)return; yaw+=(e.clientX-drag[0])*0.008;
  pitch+=(e.clientY-drag[1])*0.008; drag=[e.clientX,e.clientY]; draw();};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001); draw(); e.preventDefault();};
draw();
</script></body></html>
"""


def export_scene_html(path: str, scene: dict) -> None:
    """Self-contained interactive HTML (no network, no deps)."""
    frusta = []
    for R, t in zip(scene["kf_R"], scene["kf_t"]):
        frusta.extend([[list(map(float, a)), list(map(float, b))]
                       for a, b in _frustum_segments(R, t)])
    payload = {
        "points": [[round(float(v), 4) for v in p] for p in scene["points"]],
        "colors": [round(float(c), 3) for c in scene["colors"]],
        "lines": [[[round(float(v), 4) for v in seg[0]],
                   [round(float(v), 4) for v in seg[1]]]
                  for seg in scene.get("lines", [])],
        "frusta": frusta,
        "est": [[round(float(v), 4) for v in p] for p in scene["est"]],
        "gt": [[round(float(v), 4) for v in p] for p in scene["gt"]],
    }
    html = _HTML_TEMPLATE.replace("__SCENE_JSON__", json.dumps(payload))
    with open(path, "w") as f:
        f.write(html)


def export_scene_png(path: str, scene: dict) -> None:
    """Matplotlib 3D snapshot: landmark cloud + trajectories + frusta.
    Needs matplotlib (ImportError without it)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rcParams.update(_STYLE)
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    p = scene["points"]
    if len(p):
        # cap render size for file weight; subsample uniformly
        step = max(1, len(p) // 20000)
        ax.scatter(p[::step, 0], p[::step, 2], -p[::step, 1], s=1.5,
                   c=np.clip(scene["colors"][::step], 0, 1), cmap="gray",
                   alpha=0.7, linewidths=0)
    if len(scene["gt"]):
        g = scene["gt"]
        ax.plot(g[:, 0], g[:, 2], -g[:, 1], color=PALETTE[5], lw=2,
                label="groundtruth")
    if len(scene["est"]):
        e = scene["est"]
        ax.plot(e[:, 0], e[:, 2], -e[:, 1], color=PALETTE[1], lw=2,
                label="estimated")
    for R, t in zip(scene["kf_R"], scene["kf_t"]):
        for a, b in _frustum_segments(R, t):
            ax.plot([a[0], b[0]], [a[2], b[2]], [-a[1], -b[1]],
                    color=PALETTE[0], lw=0.6, alpha=0.8)
    for seg in scene.get("lines", []):
        a, b = seg
        ax.plot([a[0], b[0]], [a[2], b[2]], [-a[1], -b[1]],
                color=PALETTE[3], lw=1.2, alpha=0.9)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_zlabel("-y [m]")
    ax.legend(loc="upper left")
    ax.set_title("zenslam_tpu scene (landmarks + trajectories + keyframes)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def export_scene(output_dir: str, system, est_positions=None,
                 gt_positions=None) -> dict:
    """Write scene.ply / scene.html / scene_3d.png into ``output_dir``.
    Returns the collected scene dict (for tests). The PNG is garnish:
    without matplotlib it is skipped, with one printed line, and the dict's
    ``"png"`` is False."""
    scene = collect_scene(system, est_positions, gt_positions)
    export_ply(os.path.join(output_dir, "scene.ply"),
               scene["points"], scene["colors"])
    export_scene_html(os.path.join(output_dir, "scene.html"), scene)
    try:
        export_scene_png(os.path.join(output_dir, "scene_3d.png"), scene)
        scene["png"] = True
    except ImportError as e:
        print(f"scene: scene_3d.png skipped ({e})")
        scene["png"] = False
    return scene
