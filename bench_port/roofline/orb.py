"""The steered-BRIEF ORB kernel (``csrc/orb.cu``): frozen from
``chip_smoke.py``'s count on the 1024x1024 arc frame with 512 keypoints
(``orb_bytes`` plus the rows' inputs and outputs; 0.00029 ms, bound by
bytes). A launch's least time scales with the keypoints it describes."""

from bench_port.roofline import bound

MATCH = "orb_kernel"
KEYPOINTS = 512
BYTES = 977440
# per keypoint: 961 moment taps x 4 ops, 512 rotated samples x 8 ops, 256 compares
OPS = KEYPOINTS * (961 * 4 + 512 * 8 + 256)


def bound_s(config: dict) -> float:
    k = config.get("slam", {}).get("max_keypoints", KEYPOINTS) / KEYPOINTS
    return bound(BYTES * k, OPS * k)
