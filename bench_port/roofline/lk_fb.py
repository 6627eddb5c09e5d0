"""The LK forward-backward kernel (``csrc/lk_fb.cu``): frozen from
``chip_smoke.py``'s count on the 1024x1024 arc frame with 512 keypoints
(``lk_bytes`` and the plain version's sample counts; 0.00163 ms, bound by
operations). A launch's least time scales with the keypoints it tracks."""

from bench_port.roofline import bound

MATCH = "lk_fb_kernel"
KEYPOINTS = 512
BYTES = 2374848    # pyramid sectors read, plus the rows' inputs and outputs
GRID_SAMPLES = 1354240
WINDOW_SAMPLES = 3107286
# f32 ops per bilinear sample ~ 20; per Newton cell +3; per template cell +8
OPS = 20 * (GRID_SAMPLES + WINDOW_SAMPLES) + 3 * WINDOW_SAMPLES + 8 * GRID_SAMPLES


def bound_s(config: dict) -> float:
    k = config.get("slam", {}).get("max_keypoints", KEYPOINTS) / KEYPOINTS
    return bound(BYTES * k, OPS * k)
