"""``correct`` at a size a test run holds: the port on the CPU through the
harness's whole run but its look for a card, a tiny rig on a room
orbit, judged with ``tumvi1024.patrol``'s limits. The program passes; the
control (the reference's own answers held in bfloat16) and the timed path
broken underneath do not: a step that leaves its state unchanged, a pose
altered where it is produced, a PnP that hands back the motion prior, a
windowed BA that hands back its input. The cells run one stream on one
card, so there is no batch to halve and no exchange between cards to leave
out."""

import json
import shutil
import subprocess
import sys

import pytest

from bench_port import finder, run
from bench_port.reference import judge
from bench_port.tests.test_bench_traffic import ORBIT

SECONDS = 6.0


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    man = finder.manifest()
    man["workloads"] = [{"name": "tiny.orbit", "config": "tiny-rig", "traffic": "tiny-orbit",
                         "chips": 1, "why": "test"}]
    for m in man["end_to_end"] + man["per_layer"]:      # reported as the patrol cell's
        if "tumvi1024.patrol" in m.get("workloads", []):
            m["workloads"] = ["tiny.orbit"]
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    for sub in ("configs", "traffic", "reference/limits"):
        (root / sub).mkdir(parents=True)
    shutil.copytree(finder.BENCH_DIR / "metrics", root / "metrics")
    (root / "configs" / "tiny-rig.json").write_text(json.dumps(
        {"width": 192, "height": 160, "fx": 120.0, "fy": 120.0, "cx": 96.0, "cy": 80.0,
         "baseline": 0.101, "imu": None, "slam": {"max_keypoints": 256, "max_landmarks": 2048},
         "backend": {"telemetry_lag": 3, "enable_loop_closure": False}}))
    (root / "traffic" / "tiny-orbit.json").write_text(json.dumps(
        dict(ORBIT, warmup_frames=20, trace_before_end_s=2.0, trace_frames=3, judge_per_s=1.5,
             judge_skip=2)))
    shutil.copy(finder.BENCH_DIR / "reference" / "limits" / "tumvi1024.patrol.json",
                root / "reference" / "limits" / "tiny.orbit.json")
    return root


def _measure(tiny, seed=5):
    return run.measure("tiny.orbit", seed, SECONDS, False, "cpu", tiny, tiny, log=_quiet)


def _quiet(*a, **k):
    pass


def _correct(m, out=None):
    limits = finder.limits("tiny.orbit", m["_root"])
    return judge.judge(judge.readings(out or m["out"], m["truth"]), limits)


@pytest.fixture(scope="module")
def sound(tiny):
    m = _measure(tiny)
    m["_root"] = tiny
    return m


def test_program_is_correct(sound):
    ok, checks = _correct(sound)
    assert ok, checks
    assert len(sound["out"]["snaps"]) >= 4 and len(sound["out"]["ba"]) >= 2


def test_control_is_not_correct(sound):
    ok, checks = _correct(sound, judge.control_outputs(sound["out"], sound["truth"]))
    assert not ok, checks


def test_run_result_shape(tiny):
    r = run.run_cell("tiny.orbit", 11, SECONDS, True, "cpu", tiny, tiny, log=_quiet)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(finder.limits("tiny.orbit", tiny))
    assert "system.frame_p50_ms" in r["metrics"] and "fps" not in r["metrics"]
    assert r["device"]["window_s"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "pose_altered", "pnp_prior",
                                   "ba_unchanged"])
def test_broken_timed_path_is_not_correct(tiny, monkeypatch, fault):
    from zenslam_tpu_torch.pipeline import step, system
    from zenslam_tpu_torch.utils.graphs import fresh

    real_frame, real_pose, real_ba = (system.process_frame, step.estimate_pose_cascade,
                                      system._WINDOWED_BA)

    def frame_unchanged(sysm, *a, **k):
        kept = fresh(sysm.state) if sysm.n_frames > 20 else None
        tel, info = real_frame(sysm, *a, **k)
        if kept is not None:
            sysm.state = kept
        return tel, info

    def pose(*a, **k):
        est = real_pose(*a, **k)
        if fault == "pnp_prior":          # R_pred, t_pred
            return est._replace(R=a[11].clone(), t=a[12].clone())
        return est._replace(t=est.t + 0.02)

    def ba_unchanged(db, lmap_xyz, lmap_valid, lmap_gen, R_cw, t_cw, rig, **k):
        res = real_ba(db, lmap_xyz, lmap_valid, lmap_gen, R_cw, t_cw, rig, **k)
        return (db.R.clone(), db.t.clone(), lmap_xyz.clone(), R_cw.clone(), t_cw.clone(),
                res[5])

    if fault == "state_unchanged":
        monkeypatch.setattr(system, "process_frame", frame_unchanged)
    elif fault == "ba_unchanged":
        monkeypatch.setattr(system, "_WINDOWED_BA", ba_unchanged)
    else:
        monkeypatch.setattr(step, "estimate_pose_cascade", pose)
    m = _measure(tiny, seed=6)
    m["_root"] = tiny
    ok, checks = _correct(m)
    assert not ok, checks


def test_no_card_no_result(tmp_path):
    p = subprocess.run([sys.executable, "-m", "bench_port.run", "--workload",
                        "tumvi1024.patrol", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=finder.REPO_DIR, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_bare_checkout_fails(tmp_path):
    shutil.copy(finder.REPO_DIR / "BENCHMARK.json", tmp_path)
    shutil.copytree(finder.BENCH_DIR, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "bench_port.run", "--workload",
                        "tumvi1024.patrol", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
