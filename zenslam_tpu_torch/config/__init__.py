"""Options: nested dataclasses <-> YAML."""

from zenslam_tpu_torch.config.options import (
    AllOptions, FolderOptions, load_options, save_options)

__all__ = ["AllOptions", "FolderOptions", "load_options", "save_options"]
