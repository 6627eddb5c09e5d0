"""Distributed bundle adjustment (``torch.distributed`` process groups), the
multi-process scaffold around it, and the offline chunked mode —
counterpart of ``zenslam_tpu/parallel``."""

from zenslam_tpu_torch.parallel.dist_ba import (
    shard_ba_problem,
    dist_bundle_adjust,
    make_ba_mesh,
)
from zenslam_tpu_torch.parallel.multihost import (
    init_multihost,
    global_ba_mesh,
    distribute_ba_problem,
    gather_landmarks,
)
from zenslam_tpu_torch.parallel.offline import (
    run_offline_chunks,
    run_offline_multiprocess,
    split_chunks,
    stitch_chunks,
)
