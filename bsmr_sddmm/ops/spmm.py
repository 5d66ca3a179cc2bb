"""CSR SpMM (sparse @ dense) — companion op for the model layer.

Not present in the reference as a public op (its domain is SDDMM only), but
required by the model families built on top (graph attention aggregates
with SpMM after the SDDMM-softmax).  Formulation: gather rows of
the dense operand per nnz, scale by the sparse values, and segment-sum into
output rows — all static-shaped, no scatter-add collisions because
``jax.ops.segment_sum`` lowers to a sorted segment reduction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bsmr_sddmm.data.sparse import CSR


@functools.partial(jax.jit, static_argnames=("num_rows",))
def csr_spmm_jax(values: jax.Array, rows: jax.Array, cols: jax.Array,
                 dense: jax.Array, num_rows: int) -> jax.Array:
    """out[r] = sum_{i: rows[i]==r} values[i] * dense[cols[i]].

    values/rows/cols: (nnz,); dense: (N, K) -> out: (num_rows, K).
    """
    gathered = jnp.take(dense, cols, axis=0)
    contrib = gathered * values[:, None].astype(gathered.dtype)
    return jax.ops.segment_sum(contrib, rows, num_segments=num_rows)


def csr_spmm(s: CSR, dense, values=None) -> np.ndarray:
    """Host wrapper: S @ dense with S's stored values (or override)."""
    vals = s.values if values is None else values
    out = csr_spmm_jax(
        jnp.asarray(vals), jnp.asarray(s.row_indices(), dtype=jnp.int32),
        jnp.asarray(s.col_idx, dtype=jnp.int32), jnp.asarray(dense),
        num_rows=s.m)
    return np.asarray(out)
