"""Block-sparse transformer attention over structured masks.

The sequence-model counterpart of ``graph_attention``: multi-head
dot-product attention where only a structured subset of the (L, L) score
matrix is materialized — a sliding window plus optional global tokens
(the Longformer/BigBird pattern class the reference's GNN baselines
approximate on graphs; SURVEY.md §2.4).  The mask is a sparsity pattern,
so the score computation is exactly an SDDMM at the mask's nnz, and the
mask *structure* maps directly onto this framework's packer:

- the sliding window packs into banded pair/quad/super tiles,
- global columns are the hub-slab case (every row attends to them),
- global rows pack into dense row panels.

Forward pass per head: ``scores = SDDMM(Q_h, K_h) / sqrt(D)`` in the
native packed layout, per-row segment softmax (padding slots fall into
the dropped sentinel segment), then an SpMM aggregation of V.  The whole
layer is differentiable JAX (gather/segment ops/matmul), so it trains
under ``jax.grad`` without any custom VJP.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from bsmr_sddmm.data.sparse import COO, CSR
from bsmr_sddmm.models.graph_attention import segment_softmax
from bsmr_sddmm.ops.hybrid import HybridSDDMM


def make_attention_mask(seq_len: int, window: int = 64,
                        num_global: int = 0,
                        causal: bool = False) -> CSR:
    """Sliding-window (+ global-token) attention mask as a CSR pattern.

    Row i attends to columns within ``window`` of i (one-sided when
    ``causal``), to the first ``num_global`` columns, and the first
    ``num_global`` rows attend to every column.
    """
    rows_l = []
    cols_l = []
    i = np.arange(seq_len, dtype=np.int64)
    lo = np.maximum(i - window, 0)
    hi = i + 1 if causal else np.minimum(i + window + 1, seq_len)
    counts = np.maximum(hi - lo, 0)
    rows_w = np.repeat(i, counts)
    cols_w = (np.arange(int(counts.sum()), dtype=np.int64)
              - np.repeat(np.cumsum(counts) - counts, counts)
              + np.repeat(lo, counts))
    rows_l.append(rows_w)
    cols_l.append(cols_w)
    if num_global:
        g = np.arange(num_global, dtype=np.int64)
        # every row -> global columns (clipped to the past when causal)
        rg = np.repeat(i, num_global)
        cg = np.tile(g, seq_len)
        if causal:
            keep = cg <= rg
            rg, cg = rg[keep], cg[keep]
        rows_l.append(rg)
        cols_l.append(cg)
        # global rows -> every (non-future) column
        for gi in range(num_global):
            reach = gi + 1 if causal else seq_len
            rows_l.append(np.full(reach, gi, dtype=np.int64))
            cols_l.append(np.arange(reach, dtype=np.int64))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    keys = rows * seq_len + cols
    keys = np.unique(keys)
    rows = keys // seq_len
    cols = keys % seq_len
    return COO((seq_len, seq_len), rows, cols,
               np.ones(len(rows), dtype=np.float32)).to_csr()


class BlockSparseAttentionParams(NamedTuple):
    w_q: jax.Array   # (H, F, D)
    w_k: jax.Array   # (H, F, D)
    w_v: jax.Array   # (H, F, D)
    w_o: jax.Array   # (H * D, F)


class BlockSparseAttention:
    """Multi-head block-sparse self-attention over a fixed mask.

    The mask is packed once (BSMR + hybrid packing); every head reuses
    the same packed layout and its per-slot (row, col) sentinel
    metadata.  Scores never exist in CSR order — softmax and
    aggregation run directly on the packed flat vector.
    """

    def __init__(self, mask: CSR, feature_dim: int, num_heads: int,
                 head_dim: int, alpha: float = 0.3, delta: float = 0.3,
                 compute_dtype: str = "float32",
                 a_layout: str = "rows"):
        self.mask = mask
        self.feature_dim = feature_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.runner = HybridSDDMM.from_csr(mask, alpha, delta,
                                           compute_dtype=compute_dtype)
        if a_layout != "rows":
            self.runner = HybridSDDMM(self.runner.packed,
                                      compute_dtype=compute_dtype,
                                      a_layout=a_layout)
        self._rows = self.runner.packed_rows   # (F,), sentinel = L
        self._cols = self.runner.packed_cols   # (F,), sentinel = L
        self._len = mask.m

        runner = self.runner
        rows, cols, L = self._rows, self._cols, self._len
        scale = 1.0 / np.sqrt(head_dim)

        def head(q, k, v):
            q_pad = jnp.concatenate(
                [q, jnp.zeros((1, q.shape[1]), q.dtype)])
            k_pad = jnp.concatenate(
                [k, jnp.zeros((1, k.shape[1]), k.dtype)])
            scores = runner.run_padded(
                *runner.device_prepare(q_pad, k_pad), order="packed")
            attn = segment_softmax(scores * scale, rows, L + 1)
            v_pad = jnp.concatenate(
                [v, jnp.zeros((1, v.shape[1]), v.dtype)])
            gathered = jnp.take(v_pad, cols, axis=0) * attn[:, None]
            out = jax.ops.segment_sum(gathered, rows, num_segments=L + 1)
            return out[:L]                      # (L, D)

        def forward(params: BlockSparseAttentionParams, x: jax.Array):
            # x: (L, F).  Heads batch through vmap; XLA batches the
            # per-head gathers and tile matmuls natively (ops/batch.py).
            q = jnp.einsum("lf,hfd->hld", x, params.w_q)
            k = jnp.einsum("lf,hfd->hld", x, params.w_k)
            v = jnp.einsum("lf,hfd->hld", x, params.w_v)
            heads = jax.vmap(head)(q, k, v)     # (H, L, D)
            cat = jnp.transpose(heads, (1, 0, 2)).reshape(L, -1)
            return cat @ params.w_o             # (L, F)

        self._forward = jax.jit(forward)

    def init(self, rng_key) -> BlockSparseAttentionParams:
        kq, kk, kv, ko = jax.random.split(rng_key, 4)
        shape = (self.num_heads, self.feature_dim, self.head_dim)
        s_in = 1.0 / np.sqrt(self.feature_dim)
        s_out = 1.0 / np.sqrt(self.num_heads * self.head_dim)
        return BlockSparseAttentionParams(
            jax.random.normal(kq, shape) * s_in,
            jax.random.normal(kk, shape) * s_in,
            jax.random.normal(kv, shape) * s_in,
            jax.random.normal(
                ko, (self.num_heads * self.head_dim,
                     self.feature_dim)) * s_out,
        )

    def __call__(self, params: BlockSparseAttentionParams,
                 x: jax.Array) -> jax.Array:
        return self._forward(params, x)


def dense_reference_attention(params: BlockSparseAttentionParams,
                              x: np.ndarray, mask: CSR) -> np.ndarray:
    """O(L^2) golden model: full QK^T with -inf outside the mask."""
    L = mask.m
    dense_mask = mask.to_dense() > 0
    heads = []
    H = params.w_q.shape[0]
    for h in range(H):
        q = x @ np.asarray(params.w_q[h])
        k = x @ np.asarray(params.w_k[h])
        v = x @ np.asarray(params.w_v[h])
        s = (q @ k.T) / np.sqrt(q.shape[1])
        s = np.where(dense_mask, s, -np.inf)
        s = s - s.max(axis=1, keepdims=True)
        e = np.exp(s)
        p = e / np.maximum(e.sum(axis=1, keepdims=True), 1e-30)
        heads.append(p @ v)
    cat = np.concatenate(heads, axis=1)
    return cat @ np.asarray(params.w_o)
