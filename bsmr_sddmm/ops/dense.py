"""Dense-masked SDDMM: compute the full A@B product with one matmul and
gather the nnz positions.

This is the third comparison point of the harness (alongside the pure-JAX
CSR gather-dot path, ops/csr_sddmm.py, and the hybrid BSMR path) and the
dispatch class for *low-sparsity* matrices: its cost is the dense matmul
2*M*N*K plus one nnz gather, with zero per-tile index traffic.  The
reference has no equivalent (its densest baseline is cuSPARSE).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bsmr_sddmm.data.sparse import CSR
from bsmr_sddmm.ops.hybrid import _storage_dtypes, tile_dot

#: products with at least this many cells are gathered by (row, col)
#: pairs: a flat int32 index into them would overflow
FLAT_INDEX_LIMIT = 2 ** 31


@functools.partial(jax.jit, static_argnames=("compute_dtype",))
def _dense_masked_jit(a, b, rows, cols, compute_dtype="tf32"):
    """2-D (row, col) gather of the full product — no flattened index, so
    m*n >= 2**31 cannot overflow int32 (JAX silently downcasts int64
    arrays unless x64 is enabled)."""
    adt, bdt = _storage_dtypes(compute_dtype)
    full = tile_dot(a.astype(adt), b.astype(bdt), (((1,), (0,)), ((), ())),
                    compute_dtype)
    return full[rows, cols]


def dense_masked_sddmm(a, b, s: CSR,
                       compute_dtype: str = "tf32") -> np.ndarray:
    """(nnz,) values in CSR entry order via full dense product + gather."""
    rows = jnp.asarray(s.row_indices(), dtype=jnp.int32)
    cols = jnp.asarray(s.col_idx, dtype=jnp.int32)
    out = _dense_masked_jit(jnp.asarray(a), jnp.asarray(b), rows, cols,
                            compute_dtype=compute_dtype)
    return np.asarray(out)


@functools.partial(jax.jit, static_argnames=("compute_dtype",))
def _dense_full_jit(a, bt, compute_dtype="tf32"):
    """Full (M, N) product A @ B^T in the framework's compute modes."""
    return tile_dot(a, bt, (((1,), (1,)), ((), ())), compute_dtype)


class DenseSDDMM:
    """Dense-tiling SDDMM strategy for high-density matrices — the true
    DLMC regime (pruned-ML weights, density 0.1-0.5; the reference's DLMC
    corpus, scripts/exclude_invalid_dataset.py:46-49 keeps them).

    At this density the BSMR packing covers the matrix almost entirely
    with full 128x128 super tiles, so the hybrid kernel degenerates into
    a dense blocked product fed by per-tile gathers.
    This runner drops the indices entirely: ONE dot A @ B^T whose
    (M, N) output is the native layout — the value of CSR entry (r, c)
    sits at slot r*N + c, zero gathers to deliver.  CSR-entry order
    (``order="csr"``) costs one flat take (2-D gather when M*N would
    overflow int32).

    The reference has no counterpart (it always runs BSMR; its densest
    baseline is cuSPARSE); scripts/probe_dense_dlmc.py compares the two
    classes on one matrix.

    Interface-compatible with HybridSDDMM for the bench/probe harness:
    ``prepare_operands`` -> ``run_padded`` / ``measure_kernel_ms``.
    """

    def __init__(self, m: int, n: int, compute_dtype: str = "tf32",
                 csr: CSR | None = None):
        self.m, self.n = int(m), int(n)
        self.compute_dtype = compute_dtype
        self._csr = csr
        self._flat_idx = None
        self._rows_cols = None

    @staticmethod
    def from_csr(csr: CSR, compute_dtype: str = "tf32") -> "DenseSDDMM":
        return DenseSDDMM(csr.m, csr.n, compute_dtype=compute_dtype,
                          csr=csr)

    def prepare_operands(self, a, b=None, bt=None):
        """Device A (M, K) and B^T (N, K) in the storage dtypes (the
        analogue of HybridSDDMM.prepare_operands; no index arrays)."""
        a = np.asarray(a)
        if bt is None:
            bt = np.ascontiguousarray(np.asarray(b).T)
        else:
            bt = np.asarray(bt)
        adt, bdt = _storage_dtypes(self.compute_dtype)
        return jnp.asarray(a).astype(adt), jnp.asarray(bt).astype(bdt)

    def _csr_gather_ops(self):
        if self._csr is None:
            raise ValueError("order='csr' needs the CSR pattern; build "
                             "with DenseSDDMM.from_csr")
        if self.m * self.n < FLAT_INDEX_LIMIT:
            if self._flat_idx is None:
                flat = (self._csr.row_indices().astype(np.int64) * self.n
                        + self._csr.col_idx.astype(np.int64))
                self._flat_idx = jnp.asarray(flat.astype(np.int32))
            return self._flat_idx, None
        if self._rows_cols is None:
            self._rows_cols = (
                jnp.asarray(self._csr.row_indices(), dtype=jnp.int32),
                jnp.asarray(self._csr.col_idx, dtype=jnp.int32))
        return None, self._rows_cols

    @staticmethod
    def _gather(full: jax.Array, flat_idx, rows_cols) -> jax.Array:
        if flat_idx is not None:
            return jnp.take(full.reshape(-1), flat_idx)
        return full[rows_cols[0], rows_cols[1]]

    def to_csr_order(self, full: jax.Array) -> jax.Array:
        return self._gather(full, *self._csr_gather_ops())

    def run_padded(self, a_dev: jax.Array, bt_dev: jax.Array,
                   order: str = "packed") -> jax.Array:
        full = _dense_full_jit(a_dev, bt_dev,
                               compute_dtype=self.compute_dtype)
        if order == "packed":
            return full
        if order == "csr":
            return self.to_csr_order(full)
        raise ValueError(f"unknown order {order!r}")

    def __call__(self, a, b=None, bt=None, order: str = "csr"):
        a_dev, bt_dev = self.prepare_operands(a, b=b, bt=bt)
        return self.run_padded(a_dev, bt_dev, order=order)

    def make_looped_fn(self, iterations: int, order: str = "packed"):
        """Loop-differenced timing body (utils/timing.diff_time_ms): a
        dtype-preserving ``where`` on the carry masks A each iteration so
        XLA cannot hoist/CSE the dot out of the fori_loop, and an
        ``optimization_barrier`` + tiny slice stands in for the consumer
        so the full (M, N) HBM write — the strategy's dominant byte term
        — cannot be fused away into the reduction."""
        # nnz-sized gather indices enter as jit ARGUMENTS, not closure
        # constants — closed-over arrays are inlined into the HLO as
        # literals (see hybrid.make_looped_fn).
        gather = self._csr_gather_ops() if order == "csr" else None

        def looped(a_dev, bt_dev, gather_ix):
            def body(_, carry):
                live = carry > jnp.float32(-1e30)
                a_i = jnp.where(live, a_dev, jnp.zeros_like(a_dev))
                out = _dense_full_jit(a_i, bt_dev,
                                      compute_dtype=self.compute_dtype)
                if order == "csr":
                    out = self._gather(out, *gather_ix)
                # the barrier blocks dot->reduce fusion, so the (M, N)
                # product must be materialized before the consumer reads
                # it; the consumer is a ~1024-point strided checksum
                # across the WHOLE buffer (not a corner slice), so no
                # rewrite can serve it from a partial product
                out = jax.lax.optimization_barrier(out)
                flat_o = out.reshape(-1)
                stride = max(flat_o.shape[0] // 1024, 1)
                return jnp.sum(flat_o[::stride]) * jnp.float32(1e-38)

            return jax.lax.fori_loop(0, iterations, body, jnp.float32(0.0))

        jitted = jax.jit(looped)
        return lambda a_dev, bt_dev: jitted(a_dev, bt_dev, gather)

    def measure_kernel_ms(self, a_dev, bt_dev, iterations: int = 50,
                          repeats: int = 3, order: str = "packed") -> float:
        from bsmr_sddmm.utils.timing import diff_time_ms

        f_many = self.make_looped_fn(iterations, order=order)
        f_one = self.make_looped_fn(1, order=order)
        return diff_time_ms(lambda: float(f_many(a_dev, bt_dev)),
                            lambda: float(f_one(a_dev, bt_dev)),
                            iterations, repeats)
