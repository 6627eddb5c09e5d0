"""BENCHMARK.json against the contract's shapes, and the finder."""

import json
import re

import pytest

from bench_port import finder

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    return finder.manifest()


def test_names_and_units(man):
    names = [c["name"] for c in man["configs"]] + [w["name"] for w in man["workloads"]]
    names += [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    names += [w["traffic"] for w in man["workloads"]]
    names += [k for c in man["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in man["end_to_end"] + man["per_layer"]}) == \
        len(man["end_to_end"]) + len(man["per_layer"])


def test_every_part_found(man):
    for w in man["workloads"]:
        cfg = finder.config(w["config"])
        assert finder.traffic(w["traffic"])["pool_frames"] > 1
        assert set(finder.limits(w["name"])) >= {"stereo_px", "track_px"}
        assert any(c["file"].endswith(f"{w['config']}.json") for c in man["configs"])
        assert cfg["width"] > 0
        assert finder.layer_metrics(man, w["name"]) and finder.e2e_metrics(man, w["name"])
    for m in man["per_layer"]:
        assert callable(finder.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in man["end_to_end"]}
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}


def test_new_parts_are_files(tmp_path):
    """A later change adds a configuration, a traffic mix and a metric as
    new files, found by name without editing any file there is."""
    for sub in ("configs", "traffic", "metrics"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "new-rig.json").write_text(json.dumps({"width": 64}))
    (tmp_path / "traffic" / "new-mix.json").write_text(json.dumps({"pool_frames": 7}))
    (tmp_path / "metrics" / "new.layer_ms.py").write_text(
        "def read(run):\n    return run['frames'] * 2.0\n")
    assert finder.config("new-rig", tmp_path)["width"] == 64
    assert finder.traffic("new-mix", tmp_path)["pool_frames"] == 7
    assert finder.metric_reader("new.layer_ms", tmp_path)({"frames": 3}) == 6.0
    with pytest.raises(FileNotFoundError):
        finder.metric_reader("absent", tmp_path)


def test_layer_metric_selection():
    man = {"end_to_end": [{"name": "fps"}, {"name": "lat", "workloads": ["a"]}],
           "per_layer": [{"name": "x", "moves": "fps"}, {"name": "y", "moves": "lat"},
                         {"name": "z", "moves": "fps", "workloads": ["b"]}]}
    assert [m["name"] for m in finder.layer_metrics(man, "a")] == ["x", "y"]
    assert [m["name"] for m in finder.layer_metrics(man, "b")] == ["x", "z"]
