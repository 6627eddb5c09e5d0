"""Offline-chunk worker process — counterpart of
``zenslam_tpu/parallel/offline_worker.py``.

    python -m zenslam_tpu_torch.parallel.offline_worker in.npz out.npz

One process per chunk (one host or GPU per chunk in a deployment): loads the
chunk arrays, the ``SlamConfig`` fields, the device and the seed from
``in.npz``, optionally pins itself to a CPU subset, caps torch's threads to
its share of the cores (so that workers do not fight over them), runs the
front end (``run_sequence``) and writes the chunk's arrays for
``offline.stitch_chunks``.
"""

from __future__ import annotations

import json
import os
import sys


def main(in_path: str, out_path: str) -> int:
    import numpy as np

    blob = np.load(in_path, allow_pickle=False)
    meta = json.loads(str(blob["meta"]))
    cpus = meta.get("cpus")
    if cpus:
        os.sched_setaffinity(0, cpus)

    import torch

    torch.set_num_threads(len(cpus) if cpus else meta["threads"])

    from zenslam_tpu_torch.geometry.camera import PinholeCamera, StereoRig
    from zenslam_tpu_torch.parallel.offline import _chunk_result
    from zenslam_tpu_torch.pipeline.runner import run_sequence
    from zenslam_tpu_torch.pipeline.state import SlamConfig

    dev = torch.device(meta["device"])
    cfg = SlamConfig(**meta["cfg"])

    def t(name):
        return torch.from_numpy(np.asarray(blob[name], np.float32)).to(dev)

    def cam(p):
        return PinholeCamera(fx=t(p + "fx"), fy=t(p + "fy"), cx=t(p + "cx"), cy=t(p + "cy"),
                             dist=t(p + "dist"), width=int(blob[p + "w"]),
                             height=int(blob[p + "h"]))

    rig = StereoRig(left=cam("l_"), right=cam("r_"), R_rl=t("R_rl"), t_rl=t("t_rl"),
                    R_ci=t("R_ci"), t_ci=t("t_ci"))
    imu = None
    if "gyro" in blob:
        imu = (blob["gyro"], blob["accel"], blob["imu_dts"], blob["imu_mask"])
    st, tel = run_sequence(cfg, rig, blob["left"], blob["right"], seed=int(meta["seed"]),
                           imu=imu, device=dev)
    np.savez(out_path, **dict(zip(("R_cw", "t_cw", "map_xyz", "map_valid", "map_desc"),
                                  _chunk_result(tel, st))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1], sys.argv[2]))
