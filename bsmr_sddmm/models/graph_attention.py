"""Dot-product graph attention — the canonical *inference* use of SDDMM.

A graph-transformer attention layer over a sparse adjacency: attention
scores are exactly an SDDMM of the query/key projections at the edge
positions (``e_ij = (x_i W_q) . (x_j W_k) / sqrt(d)``), followed by a
per-row segment softmax over each node's neighbors and an SpMM aggregation
of the value projections.  This is the workload class (GNN attention /
TC-GNN, FlashSparse) the reference benchmarks against (SURVEY.md §2.4).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from bsmr_sddmm.data.sparse import CSR
from bsmr_sddmm.ops.hybrid import HybridSDDMM


class GraphAttentionParams(NamedTuple):
    w_q: jax.Array  # (F, D)
    w_k: jax.Array  # (F, D)
    w_v: jax.Array  # (F, D)


@functools.partial(jax.jit, static_argnames=("num_rows",))
def segment_softmax(scores: jax.Array, rows: jax.Array,
                    num_rows: int) -> jax.Array:
    """Numerically-stable softmax over per-row segments of edge scores."""
    row_max = jax.ops.segment_max(scores, rows, num_segments=num_rows)
    shifted = scores - jnp.take(row_max, rows)
    exp = jnp.exp(shifted)
    denom = jax.ops.segment_sum(exp, rows, num_segments=num_rows)
    return exp / jnp.take(jnp.maximum(denom, 1e-30), rows)


class GraphAttentionLayer:
    """Single-head sparse dot-product attention over a fixed graph."""

    def __init__(self, adj: CSR, feature_dim: int, head_dim: int,
                 alpha: float = 0.3, delta: float = 0.3,
                 compute_dtype: str = "float32"):
        self.adj = adj
        self.feature_dim = feature_dim
        self.head_dim = head_dim
        self.runner = HybridSDDMM.from_csr(adj, alpha, delta,
                                           compute_dtype=compute_dtype)
        # The whole layer runs in the framework's native packed layout:
        # per-slot (row, col) ids with sentinels (m, n) route padding cells
        # into an extra dropped segment / a zero V row — no CSR-order
        # permutation anywhere in the forward pass.
        self._rows = self.runner.packed_rows   # (F,), sentinel = m
        self._cols = self.runner.packed_cols   # (F,), sentinel = n
        self._num_rows = adj.m

    def init(self, rng_key) -> GraphAttentionParams:
        kq, kk, kv = jax.random.split(rng_key, 3)
        scale = 1.0 / np.sqrt(self.feature_dim)
        shape = (self.feature_dim, self.head_dim)
        return GraphAttentionParams(
            jax.random.normal(kq, shape) * scale,
            jax.random.normal(kk, shape) * scale,
            jax.random.normal(kv, shape) * scale,
        )

    def __call__(self, params: GraphAttentionParams,
                 x: jax.Array) -> jax.Array:
        """x: (num_nodes, F) -> (num_nodes, D) attention output."""
        q = x @ params.w_q                      # (N, D)
        k = x @ params.w_k                      # (N, D)
        v = x @ params.w_v                      # (N, D)
        q_pad = jnp.concatenate([q, jnp.zeros((1, q.shape[1]), q.dtype)])
        k_pad = jnp.concatenate([k, jnp.zeros((1, k.shape[1]), k.dtype)])
        scores = self.runner.run_padded(q_pad, k_pad, order="packed")
        scores = scores / np.sqrt(self.head_dim)
        # Segment m (the row sentinel) collects every padding slot and is
        # dropped; V is padded with a zero row for the col sentinel n.
        attn = segment_softmax(scores, self._rows, self._num_rows + 1)
        v_pad = jnp.concatenate([v, jnp.zeros((1, v.shape[1]), v.dtype)])
        gathered = jnp.take(v_pad, self._cols, axis=0) * attn[:, None]
        out = jax.ops.segment_sum(gathered, self._rows,
                                  num_segments=self._num_rows + 1)
        return out[:self._num_rows]
