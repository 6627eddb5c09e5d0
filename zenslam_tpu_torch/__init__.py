"""zenslam_tpu_torch — the stereo SLAM front end in PyTorch, with hand-written
CUDA kernels for Hopper (sm_90a).

The JAX package ``zenslam_tpu`` is the reference; this package mirrors its
module layout (``geometry``, ``ops``, ``frontend``, ``estimation``,
``pipeline``, ``io``, ``eval``) so the counterpart of each module is easy to
find, and keeps its public signatures. It imports neither ``jax`` nor
``zenslam_tpu``.

Conventions fixed once for the whole package:

- state tables are NamedTuples of tensors on one explicit device;
- packed binary descriptors (ORB, FREAK, keylines, the SIFT family's LSH
  codes) are ``(N, 8) torch.int32`` holding the same bit patterns as the
  reference's ``uint32`` words; SIFT descriptors are ``(N, 128)`` float32;
- randomness comes from ``torch.Generator``s seeded from a per-state seed and
  frame counter, and every random draw can be injected instead;
- the two TPU kernels (pyramidal LK, ORB) are CUDA C++ under ``csrc/``, built
  with ``nvcc`` at first use; on CPU tensors their wrappers run the plain
  PyTorch version of the same function.
"""

import torch as _torch

# Geometry leans on small f32 matmuls (3x3 .. 12x12 solves); TF32 keeps only
# ~3 decimal digits. Counterpart of the reference's f32 matmul precision pin.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
