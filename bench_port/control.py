"""The readings that the limits of ``reference/limits/<cell>.json`` are set
from: for each seed, one run of the cell (set-up and a window of
``--seconds``, as a benchmark run makes them) judged by the reference, and
the control judged the same way, the reference's own answers held in
bfloat16 in the program's place (``reference/judge.py:control_outputs``).
All seeds run in one process.

    python3 -m bench_port.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

One JSON line per seed on stdout, then the largest program reading and the
smallest control reading of each number. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys

from bench_port import run
from bench_port.reference import judge


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("bench_port.control", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    run.cache_dirs(run.finder.REPO_DIR)
    import torch

    torch.set_num_threads(run.HOST_THREADS)
    progs, ctls = [], []
    for seed in args.seeds:
        m = run.measure(args.workload, seed, args.seconds, False)
        if m["out"] is None:
            print(json.dumps({"seed": seed, "raised": repr(m["raised"])}), flush=True)
            continue
        prog = judge.readings(m["out"], m["truth"])
        ctl = judge.readings(judge.control_outputs(m["out"], m["truth"]), m["truth"])
        progs.append(prog)
        ctls.append(ctl)
        st = m["stats"]
        print(json.dumps({"seed": seed, "program": prog, "control": ctl,
                          "fps": st["fps"], "frame_p95_ms": st["frame_p95_ms"],
                          "setup_s": m["setup_s"], "failed": m["failed"],
                          "keyframes": m["n_kf"], "loops": m["n_loops"],
                          "captures": m["captures"],
                          "judged_frames": sorted(m["out"]["snaps"]),
                          "judged_ba": len(m["out"]["ba"])}), flush=True)
    if progs:
        print(json.dumps({
            "program_max": {k: max(p[k] for p in progs) for k in judge.NUMBERS},
            "control_min": {k: min(c[k] for c in ctls) for k in judge.NUMBERS}}))
    return 0 if len(progs) == len(args.seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
