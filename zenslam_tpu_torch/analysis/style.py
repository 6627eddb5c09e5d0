"""Shared matplotlib style for the analysis scripts (headless Agg) — the
port's own copy of ``zenslam_tpu/analysis/style.py``. Only the plot mains
import it; it needs matplotlib.

Categorical hues are assigned in FIXED order (never cycled past 8 — fold
into 'other' instead); the palette is a colorblind-validated 8-slot set
(adjacent-pair CVD deltaE >= 8, normal-vision >= 15, light surface).
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt

# fixed categorical order: blue, orange, aqua, yellow, magenta, green,
# violet, red (light-mode steps; validated adjacent-pair CVD-safe)
PALETTE = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100",
           "#e87ba4", "#008300", "#4a3aa7", "#e34948"]

_INK = "#0b0b0b"
_MUTED = "#898781"
_GRID = "#e1e0d9"
_SURFACE = "#fcfcfb"


def apply_style():
    plt.rcParams.update({
        "figure.facecolor": _SURFACE,
        "axes.facecolor": _SURFACE,
        "axes.edgecolor": _MUTED,
        "axes.labelcolor": _INK,
        "axes.grid": True,
        "grid.color": _GRID,
        "grid.linewidth": 0.8,
        "axes.spines.top": False,
        "axes.spines.right": False,
        "xtick.color": _MUTED,
        "ytick.color": _MUTED,
        "text.color": _INK,
        "lines.linewidth": 2.0,
        "legend.frameon": False,
        "font.size": 10,
    })


def save(fig, path):
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {path}")
