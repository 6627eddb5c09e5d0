"""Find the benchmark's parts by the names that ``BENCHMARK.json`` gives them,
so that a later change adds a configuration, a traffic mix, a metric or a
limit by adding a file:

- ``configs/<config>.json``: a configuration (the rig, ``SlamConfig`` and
  ``BackendConfig`` fields, the IMU, its source and cuts);
- ``traffic/<traffic>.json``: a traffic mix, read by ``traffic.py``;
- ``metrics/<metric>.py``: a per-layer metric's reader, whose
  ``read(run)`` returns a number, or None when it finds nothing to read;
- ``reference/limits/<cell>.json``: the limits of a cell's comparison with
  the reference.

``root`` is the benchmark's folder; tests pass another one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
REPO_DIR = BENCH_DIR.parent


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"benchmark part not found: {path}")
    return json.loads(path.read_text())


def manifest(repo: Path = REPO_DIR) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return _json(Path(repo) / "BENCHMARK.json")


def cell(man: dict, name: str) -> dict:
    """The ``workloads`` entry called ``name``."""
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"({', '.join(w['name'] for w in man['workloads'])})")


def config(name: str, root: Path = BENCH_DIR) -> dict:
    return _json(Path(root) / "configs" / f"{name}.json")


def traffic(name: str, root: Path = BENCH_DIR) -> dict:
    return _json(Path(root) / "traffic" / f"{name}.json")


def limits(cell_name: str, root: Path = BENCH_DIR) -> dict:
    return _json(Path(root) / "reference" / "limits" / f"{cell_name}.json")


def metric_reader(name: str, root: Path = BENCH_DIR):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = Path(root) / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def layer_metrics(man: dict, cell_name: str) -> list:
    """The per-layer metrics that ``cell_name`` reports: those that list it
    under ``workloads``, or, without the key, those whose end-to-end metric
    the cell reports."""
    reported = {m["name"] for m in e2e_metrics(man, cell_name)}
    return [m for m in man["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def e2e_metrics(man: dict, cell_name: str) -> list:
    """The end-to-end metrics that ``cell_name`` reports."""
    return [m for m in man["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
