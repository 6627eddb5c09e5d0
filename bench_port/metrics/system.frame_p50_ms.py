"""Median frame time of the window, every frame (the harness's clock)."""

import numpy as np


def read(run):
    lat = run["latency_ms"]
    return float(np.median(lat)) if len(lat) else None
