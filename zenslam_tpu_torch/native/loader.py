"""ctypes bindings for the native loader (PNG decode + threaded prefetch) —
counterpart of ``zenslam_tpu/native/loader.py``.

The library is built from ``png_decode.cpp`` and ``prefetch.cpp`` beside this
file by ``g++ -O3 ... -lz`` at first use, into ``zenslam_tpu_torch/_build/``
(beside the CUDA kernels, ``ops/cuda_build.py``), under a name that carries a
hash of the sources and flags, so a changed source is rebuilt and a stale
library is never loaded. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from zenslam_tpu_torch.ops.cuda_build import BUILD_DIR

_DIR = Path(__file__).resolve().parent
_SOURCES = (_DIR / "png_decode.cpp", _DIR / "prefetch.cpp")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(b"".join(s.read_bytes() for s in _SOURCES) + " ".join(_FLAGS).encode())
    return BUILD_DIR / f"libzenslam_native-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    cmd = ["g++", *_FLAGS, *map(str, _SOURCES), "-lz", "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native loader build failed (g++ exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _get_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.zs_decode_png_gray.restype = ctypes.c_int
        lib.zs_decode_png_gray.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.zs_free.restype = None
        lib.zs_free.argtypes = [ctypes.c_void_p]
        lib.zs_reader_create.restype = ctypes.c_void_p
        lib.zs_reader_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.zs_reader_next.restype = ctypes.c_int
        lib.zs_reader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int]
        lib.zs_reader_destroy.restype = None
        lib.zs_reader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def decode_png_gray(path: str) -> np.ndarray:
    """Decode a PNG file to a grayscale uint8 or uint16 (H, W) array."""
    lib = _get_lib()
    with open(path, "rb") as f:
        data = f.read()
    out = ctypes.POINTER(ctypes.c_uint8)()
    w, h, depth = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.zs_decode_png_gray(data, len(data), ctypes.byref(out), ctypes.byref(w),
                                ctypes.byref(h), ctypes.byref(depth))
    if rc != 0:
        raise ValueError(f"PNG decode failed ({rc}): {path}")
    n = w.value * h.value
    try:
        if depth.value == 8:
            arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
        else:
            arr = np.ctypeslib.as_array(ctypes.cast(out, ctypes.POINTER(ctypes.c_uint16)),
                                        shape=(n,)).copy()
    finally:
        lib.zs_free(ctypes.cast(out, ctypes.c_void_p))
    return arr.reshape(h.value, w.value)


class PrefetchReader:
    """Ordered stereo-frame prefetcher over native worker threads: yields
    (index, left, right) float32 frames in [0, 1], in order."""

    def __init__(self, left_paths, right_paths, width: int, height: int,
                 queue_cap: int = 4, n_threads: int = 2):
        if len(left_paths) != len(right_paths):
            raise ValueError("left and right path lists differ in length")
        self._lib = _get_lib()
        self._n = len(left_paths)
        self._w, self._h = width, height
        self._handle = self._lib.zs_reader_create(
            "\n".join(left_paths).encode(), "\n".join(right_paths).encode(), self._n,
            queue_cap, n_threads)

    def __iter__(self):
        try:
            while True:
                left = np.empty((self._h, self._w), np.float32)
                right = np.empty((self._h, self._w), np.float32)
                rc = self._lib.zs_reader_next(
                    self._handle, left.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    right.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), self._w * self._h)
                if rc == -1:
                    return
                if rc < 0:
                    raise RuntimeError(f"prefetch reader error {rc}")
                yield rc, left, right
        finally:
            self.close()

    def close(self):
        if self._handle:
            self._lib.zs_reader_destroy(self._handle)
            self._handle = None
