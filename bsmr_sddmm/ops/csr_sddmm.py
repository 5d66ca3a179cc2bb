"""Pure-JAX CSR SDDMM — the cuSPARSE-equivalent baseline path.

Reference counterpart: the cuSPARSE baseline (include/cuSparseSDDMM.cuh and
baselines/cuSPARSE_SDDMM).  Formulation: a per-nnz gather of A rows and
B columns followed by a row-wise contraction.  All shapes are static per
(matrix, K) pair; XLA fuses the two gathers with the multiply-reduce so
the op runs at gather bandwidth.

B is taken pre-transposed (``bt`` of shape (N, K)) so that gathering a
column of B is a contiguous row gather — the counterpart of the
reference's column-major B requirement (src/main.cu:23-27).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bsmr_sddmm.data.sparse import CSR


@jax.jit
def csr_sddmm_jax(a: jax.Array, bt: jax.Array, rows: jax.Array,
                  cols: jax.Array) -> jax.Array:
    """values[i] = dot(a[rows[i]], bt[cols[i]]).

    a: (M, K); bt: (N, K); rows/cols: (nnz,) int32 — returns (nnz,) in the
    dtype of the matmul accumulation (float32).
    """
    ag = jnp.take(a, rows, axis=0)
    bg = jnp.take(bt, cols, axis=0)
    return jnp.sum(ag.astype(jnp.float32) * bg.astype(jnp.float32), axis=-1)


@functools.partial(jax.jit, static_argnames=("block_nnz",))
def _csr_sddmm_blocked(a, bt, rows, cols, block_nnz: int):
    """Scan over nnz chunks to bound the gathered-intermediate footprint for
    very large nnz counts."""
    num_blocks = rows.shape[0] // block_nnz

    def body(_, idx):
        r = jax.lax.dynamic_slice_in_dim(rows, idx * block_nnz, block_nnz)
        c = jax.lax.dynamic_slice_in_dim(cols, idx * block_nnz, block_nnz)
        ag = jnp.take(a, r, axis=0).astype(jnp.float32)
        bg = jnp.take(bt, c, axis=0).astype(jnp.float32)
        return None, jnp.sum(ag * bg, axis=-1)

    _, vals = jax.lax.scan(body, None, jnp.arange(num_blocks))
    return vals.reshape(-1)


def csr_sddmm(a, b, s: CSR, scale_by_values: bool = False,
              max_gathered_mb: float = 512.0) -> np.ndarray:
    """Host-convenience wrapper: numpy in, numpy out, CSR entry order."""
    rows = jnp.asarray(s.row_indices(), dtype=jnp.int32)
    cols = jnp.asarray(s.col_idx, dtype=jnp.int32)
    a = jnp.asarray(a)
    bt = jnp.asarray(np.ascontiguousarray(np.asarray(b).T))
    k = a.shape[1]
    gathered_mb = 2 * s.nnz * k * 4 / 1e6
    if gathered_mb <= max_gathered_mb:
        vals = csr_sddmm_jax(a, bt, rows, cols)
    else:
        block_nnz = max(1, int(max_gathered_mb * 1e6 / (2 * k * 4)))
        block_nnz = min(block_nnz, s.nnz)
        pad = (-s.nnz) % block_nnz
        rows_p = jnp.pad(rows, (0, pad))
        cols_p = jnp.pad(cols, (0, pad))
        vals = _csr_sddmm_blocked(a, bt, rows_p, cols_p, block_nnz)[:s.nnz]
    vals = np.asarray(vals)
    if scale_by_values:
        vals = vals * np.asarray(s.values, dtype=vals.dtype)
    return vals
