"""Fixed-capacity feature and landmark table bookkeeping."""

from zenslam_tpu_torch.frontend.tables import allocate_landmark_slots, insert_into_free_slots

__all__ = ["allocate_landmark_slots", "insert_into_free_slots"]
