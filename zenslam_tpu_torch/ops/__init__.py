"""Image ops, detectors, descriptors, matching, the stacked pyramidal LK and
the two CUDA kernels' wrappers (``lk_ragged``, ``orb_steered_brief``: the
reference's ``lk_ragged_pallas`` and ``orb_pallas``). Importing the package
builds no kernel; each builds at its first launch."""

from zenslam_tpu_torch.ops.image import (
    bilinear_sample,
    build_pyramid,
    clahe,
    gaussian_blur,
    remap,
    rgb_to_gray,
    scharr_gradients,
)
from zenslam_tpu_torch.ops.fast import detect_grid_keypoints, fast_score
from zenslam_tpu_torch.ops.harris import harris_score, harris_score_multiscale
from zenslam_tpu_torch.ops.dog import dog_score
from zenslam_tpu_torch.ops.orb import ORB_PATTERN, orb_descriptors, orb_orientation
from zenslam_tpu_torch.ops.sift import sift_descriptors
from zenslam_tpu_torch.ops.freak import freak_descriptors
from zenslam_tpu_torch.ops.match import hamming_matrix, match_descriptors, unpack_bits
from zenslam_tpu_torch.ops.lk import pyramidal_lk
from zenslam_tpu_torch.ops.lk_cuda import lk_ragged
from zenslam_tpu_torch.ops.orb_cuda import orb_steered_brief

__all__ = ["ORB_PATTERN", "bilinear_sample", "build_pyramid", "clahe", "detect_grid_keypoints",
           "dog_score", "fast_score", "freak_descriptors", "gaussian_blur", "hamming_matrix",
           "harris_score", "harris_score_multiscale", "lk_ragged", "match_descriptors",
           "orb_descriptors", "orb_orientation", "orb_steered_brief", "pyramidal_lk", "remap",
           "rgb_to_gray", "scharr_gradients", "sift_descriptors", "unpack_bits"]
