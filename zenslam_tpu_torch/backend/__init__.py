"""The keyframe back end: bundle adjustment, the pose graph, the keyframe
database and the bag-of-words vocabulary and database."""

from zenslam_tpu_torch.backend.ba import (
    BAProblem,
    ba_cost,
    bundle_adjust,
    bundle_adjust_cg,
    make_ba_problem,
)
from zenslam_tpu_torch.backend.pose_graph import PoseGraph, optimize_pose_graph
from zenslam_tpu_torch.backend.keyframes import KeyframeDB, covisibility, kf_db_add, kf_db_init
from zenslam_tpu_torch.backend.bow import (
    BowDatabase,
    Vocabulary,
    bow_db_add,
    bow_db_init,
    bow_db_query,
    build_vocabulary,
    build_vocabulary_tree,
    descriptors_to_bow,
    load_vocabulary,
    save_vocabulary,
)

__all__ = ["BAProblem", "BowDatabase", "KeyframeDB", "PoseGraph", "Vocabulary", "ba_cost",
           "bow_db_add", "bow_db_init", "bow_db_query", "build_vocabulary",
           "build_vocabulary_tree", "bundle_adjust", "bundle_adjust_cg", "covisibility",
           "descriptors_to_bow", "kf_db_add", "kf_db_init", "load_vocabulary",
           "make_ba_problem", "optimize_pose_graph", "save_vocabulary"]
