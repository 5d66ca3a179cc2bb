"""bsmr_sddmm — an SDDMM framework with BSMR-style reordering, in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
CX9898/sddmm-gpu reference (BSMR: Block-wise Similarity-based Matrix
Reordering + hybrid dense-block / sparse-residual SDDMM kernels).  Its
accelerator is an NVIDIA GPU (one H100; four for the sharded path);
everything also runs on the CPU, which is how the tests run.
``chip_smoke.py`` at the repository root is the end-to-end check on the
card.

Layer map (not a port):

- ``bsmr_sddmm.data``     — matrix containers, Matrix Market / DLMC / SNAP IO,
  random generators (reference: src/Matrix.cpp, include/Matrix.hpp).
- ``bsmr_sddmm.reorder``  — BSMR row clustering + column dense/sparse split +
  device packing (reference: src/rowReordering.cu, src/colReordering.cu,
  src/BSMR.cpp).
- ``bsmr_sddmm.ops``      — compute paths: pure-JAX CSR SDDMM (the
  cuSPARSE-equivalent baseline), hybrid dense-block + residual SDDMM as
  batched matmuls, dense-tiling class, CSR-order delivery, batched SDDMM,
  SpMM (reference:
  src/sddmmKernel.cu, include/cuSparseSDDMM.cuh).
- ``bsmr_sddmm.parallel`` — multi-device sharding of the hybrid SDDMM over a
  ``jax.sharding.Mesh`` (new capability; the reference is single-GPU).
- ``bsmr_sddmm.models``   — model families built on the ops: sparse matrix
  factorization (ALS-style training), graph attention, and block-sparse
  transformer attention (sliding-window + global-token masks).
- ``bsmr_sddmm.utils``    — logger ([key : value] format compatible with the
  reference's analyze_results schema), timing, tolerance checks, options,
  device record, persistent compilation cache, checkpoint/resume.
- ``bsmr_sddmm.native``   — optional C++ (OpenMP) host preprocessing
  accelerators with pure-Python fallbacks.
"""

from bsmr_sddmm import config as config

config.check_environment()

from bsmr_sddmm.data.sparse import CSR, COO  # noqa: E402
from bsmr_sddmm.ops.reference import sddmm_reference  # noqa: E402
from bsmr_sddmm.ops.csr_sddmm import csr_sddmm  # noqa: E402
from bsmr_sddmm.reorder.bsmr import BSMR  # noqa: E402
from bsmr_sddmm.reorder.pack import PackedMatrix, pack  # noqa: E402
from bsmr_sddmm.ops.hybrid import sddmm_hybrid, HybridSDDMM  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "CSR",
    "COO",
    "BSMR",
    "PackedMatrix",
    "pack",
    "sddmm_reference",
    "csr_sddmm",
    "sddmm_hybrid",
    "HybridSDDMM",
    "config",
    "__version__",
]
