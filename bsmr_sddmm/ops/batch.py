"""Batched SDDMM and batched transpose utilities.

Reference counterparts: ``sddmm_gpu_batch`` (include/sddmmKernel.cuh:41-47,
src/sddmmKernel.cu:2764-2850 — batched dense/sparse kernels with grid.z as
the batch axis) and ``batchedMatrixTranspose`` (:2486-2515, :2852-2869).
Here the batch axis is a ``jax.vmap`` over the same single-instance
paths; XLA batches the gathers and matmuls natively.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bsmr_sddmm.data.sparse import CSR
from bsmr_sddmm.ops.csr_sddmm import csr_sddmm_jax
from bsmr_sddmm.ops.hybrid import HybridSDDMM


_batched_csr_sddmm_jit = jax.jit(
    jax.vmap(csr_sddmm_jax, in_axes=(0, 0, None, None)))


def batched_csr_sddmm(a_batch, b_batch, s: CSR) -> np.ndarray:
    """(B, M, K) x (B, K, N) -> (B, nnz) values at the shared pattern of S."""
    rows = jnp.asarray(s.row_indices(), dtype=jnp.int32)
    cols = jnp.asarray(s.col_idx, dtype=jnp.int32)
    a_batch = jnp.asarray(a_batch)
    bt_batch = jnp.asarray(np.ascontiguousarray(
        np.swapaxes(np.asarray(b_batch), 1, 2)))
    return np.asarray(_batched_csr_sddmm_jit(a_batch, bt_batch, rows, cols))


class BatchedHybridSDDMM:
    """vmap of the hybrid path over a batch of (A, B) operand pairs sharing
    one sparsity pattern (the reference's batch mode semantics).

    Works for any layout: each batch element is routed through
    ``runner.device_prepare`` so grouped/chunked packings (G > 1, C > 1,
    column clustering) build their physical B^T layout on device inside
    the vmap."""

    def __init__(self, runner: HybridSDDMM):
        self._runner = runner

        def one(a_pad, bt_pad):
            return runner.run_padded(*runner.device_prepare(a_pad, bt_pad))

        self._fn = jax.jit(jax.vmap(one))

    def __call__(self, a_batch, b_batch):
        a_batch = np.asarray(a_batch)
        bt_batch = np.swapaxes(np.asarray(b_batch), 1, 2)
        bsz, m, k = a_batch.shape
        a_pad = np.concatenate(
            [a_batch, np.zeros((bsz, 1, k), a_batch.dtype)], axis=1)
        bt_pad = np.concatenate(
            [bt_batch, np.zeros((bsz, 1, k), bt_batch.dtype)], axis=1)
        return np.asarray(self._fn(jnp.asarray(a_pad), jnp.asarray(bt_pad)))


@jax.jit
def batched_transpose(x: jax.Array) -> jax.Array:
    """(B, M, N) -> (B, N, M).  XLA emits the tiled transpose directly
    (the reference hand-writes a 32x32 shared-memory transpose kernel)."""
    return jnp.swapaxes(x, -1, -2)


def batch_overlap_report(runner: HybridSDDMM, a_batch, b_batch,
                         iterations: int = 20) -> dict:
    """Batched-vs-sequential efficiency report — the analogue of the
    reference's batch-overlap printout (src/sddmmKernel.cu:2834-2844,
    which reports how much the batched kernel overlaps vs running the
    batch serially).

    Returns {batch_ms, serial_ms, overlap_efficiency} where
    overlap_efficiency = serial_ms / (batch_size * batch_ms_per_item)
    -- 1.0 means batching is free, >1.0 means superlinear (shared
    operand traffic amortized)."""
    import numpy as np

    from bsmr_sddmm.utils.timing import measure_loop_ms

    a_batch = np.asarray(a_batch)
    bt_batch = np.swapaxes(np.asarray(b_batch), 1, 2)
    bsz, m, k = a_batch.shape
    a_pad = np.concatenate(
        [a_batch, np.zeros((bsz, 1, k), a_batch.dtype)], axis=1)
    bt_pad = np.concatenate(
        [bt_batch, np.zeros((bsz, 1, k), bt_batch.dtype)], axis=1)
    a_d = jnp.asarray(a_pad)
    bt_d = jnp.asarray(bt_pad)

    def body_batch(c, a_d, bt_d):
        a2 = jnp.where(c > jnp.float32(-1e30), a_d, jnp.zeros_like(a_d))
        def one(ap, btp):
            return runner.run_padded(*runner.device_prepare(ap, btp))
        return jax.vmap(one)(a2, bt_d)

    def body_single(c, a_d, bt_d):
        a2 = jnp.where(c > jnp.float32(-1e30), a_d[0],
                       jnp.zeros_like(a_d[0]))
        return runner.run_padded(*runner.device_prepare(a2, bt_d[0]))

    batch_ms = measure_loop_ms(body_batch, (a_d, bt_d),
                               iterations=iterations)
    single_ms = measure_loop_ms(body_single, (a_d, bt_d),
                                iterations=iterations)
    serial_ms = single_ms * bsz
    return {"batch_size": bsz,
            "batch_ms": batch_ms,
            "serial_ms": serial_ms,
            "overlap_efficiency": serial_ms / batch_ms if batch_ms else 0.0}
