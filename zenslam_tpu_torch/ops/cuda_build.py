"""Build the CUDA sources under ``zenslam_tpu_torch/csrc/`` with ``nvcc`` into
plain-C shared libraries and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports ``extern "C"`` launch functions that take
device pointers and the stream as ``void*`` and return ``cudaGetLastError()``.
Libraries go to ``zenslam_tpu_torch/_build/lib<name>-<hash>.so``; the hash
covers the source and the flags, so a changed source is rebuilt and a stale
library is never loaded. Nothing builds at import: the first launch builds
what it needs, and ``build(names)`` runs one ``nvcc`` per source in parallel.
Each function takes the source directory (``CSRC_DIR`` unless the caller
names another, as ``chip_smoke.py --compare`` does to time other revisions).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def library_path(name: str, csrc_dir=CSRC_DIR) -> Path:
    src = (Path(csrc_dir) / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names, csrc_dir=CSRC_DIR) -> dict:
    """Compile every source in ``names`` that is not built yet, one nvcc per
    source, all started together. Returns {name: ptxas/compiler log}; raises
    RuntimeError naming each source that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs = {}
    for name in names:
        out = library_path(name, csrc_dir)
        log = out.with_suffix(".log")
        if out.is_file():
            logs[name] = log.read_text() if log.is_file() else ""
            continue
        tmp = out.with_name(out.name + f".tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(Path(csrc_dir) / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        log.write_text(text)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return logs


def load(name: str, csrc_dir=CSRC_DIR) -> ctypes.CDLL:
    """The loaded library for ``<csrc_dir>/<name>.cu``, built first if needed."""
    key = (name, str(csrc_dir))
    if key not in _LIBS:
        path = library_path(name, csrc_dir)
        if not path.is_file():
            build([name], csrc_dir)
        _LIBS[key] = ctypes.CDLL(str(path))
    return _LIBS[key]


def check(status: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")
