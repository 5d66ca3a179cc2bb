from bsmr_sddmm.ops.reference import sddmm_reference
from bsmr_sddmm.ops.csr_sddmm import csr_sddmm, csr_sddmm_jax
from bsmr_sddmm.ops.hybrid import sddmm_hybrid, HybridSDDMM
from bsmr_sddmm.ops.dense import dense_masked_sddmm
from bsmr_sddmm.ops.spmm import csr_spmm
from bsmr_sddmm.ops.batch import batched_csr_sddmm, batched_transpose

__all__ = [
    "sddmm_reference",
    "csr_sddmm",
    "csr_sddmm_jax",
    "sddmm_hybrid",
    "HybridSDDMM",
    "dense_masked_sddmm",
    "csr_spmm",
    "batched_csr_sddmm",
    "batched_transpose",
]
