"""Options: nested dataclasses <-> YAML with per-key defaulting — counterpart
of ``zenslam_tpu/config/options.py`` over this package's ``SlamConfig`` and
``BackendConfig`` (same field names and defaults, so a YAML file loads into
both packages with the same values, and ``save_options`` emits the same
text).

Sections: ``log_level``, ``folder`` (dataset layout, calibration, output),
``slam`` (``SlamConfig``) and ``backend`` (``BackendConfig``). Unknown keys
are ignored and missing keys keep their defaults.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from zenslam_tpu_torch.pipeline.state import SlamConfig
from zenslam_tpu_torch.pipeline.system import BackendConfig


@dataclass
class FolderOptions:
    root: str = ""
    left: str = "cam0/data"
    right: str = "cam1/data"
    output: str = "./output"
    calibration_file: str = ""
    imu_calibration_file: str = ""
    imu_file: str = "imu0/data.csv"
    groundtruth_file: str = ""
    timescale: float = 1e-9
    skip_frames: int = 0
    take_frames: int = 0


@dataclass
class AllOptions:
    log_level: str = "info"
    folder: FolderOptions = field(default_factory=FolderOptions)
    slam: SlamConfig = field(default_factory=SlamConfig)
    backend: BackendConfig = field(default_factory=BackendConfig)


def _from_dict(cls, d: dict):
    """A dataclass from the known keys of ``d``; the rest keep defaults."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in (d or {}).items() if k in names})


def load_options(path: str) -> AllOptions:
    import yaml

    with open(path) as f:
        d = yaml.safe_load(f) or {}
    opts = AllOptions()
    if "folder" in d:
        opts.folder = _from_dict(FolderOptions, d["folder"])
    if "slam" in d:
        opts.slam = SlamConfig(**{k: v for k, v in (d["slam"] or {}).items()
                                  if k in SlamConfig._fields})
    if "backend" in d:
        opts.backend = _from_dict(BackendConfig, d["backend"])
    if "log_level" in d:
        opts.log_level = d["log_level"]
    return opts


def save_options(opts: AllOptions, path: str) -> None:
    """Write the effective options back as YAML."""
    import yaml

    d = {
        "log_level": opts.log_level,
        "folder": dataclasses.asdict(opts.folder),
        "slam": dict(opts.slam._asdict()),
        "backend": dataclasses.asdict(opts.backend),
    }
    with open(path, "w") as f:
        yaml.safe_dump(d, f, sort_keys=False)
