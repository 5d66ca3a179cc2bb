"""BSMR column reordering: per-panel dense/sparse column split.

Reference: src/colReordering.cu:244-404 (colReordering_cpu +
analysisDescendingOrderColSegment).  Per 16-row panel of the reordered
rows: count nnz per column, order the nonzero columns by descending count,
pad to a multiple of 16 with a sentinel column (= N), then classify each
16-column group as *dense* iff its nnz sum >= ceil(delta * 256).  Because
counts are descending, dense groups form a prefix.  Remaining columns with
nnz > 0 form the *sparse residual* set (the reference's sparse list can
additionally carry zero-count sentinel padding columns — we drop those;
they carry no data).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from bsmr_sddmm import config
from bsmr_sddmm.data.sparse import CSR


@dataclasses.dataclass
class ColReorderResult:
    num_row_panels: int
    dense_cols: np.ndarray           # concatenated per-panel dense cols (sentinel = n)
    dense_col_offsets: np.ndarray    # (num_panels+1,)
    sparse_cols: np.ndarray          # concatenated per-panel sparse cols
    sparse_col_offsets: np.ndarray   # (num_panels+1,)
    sparse_data_offsets: np.ndarray  # (num_panels+1,) nnz counts in sparse part
    group_size: int = 1              # physical gather-group width G
    # (n,) rank of each column in the clustered global order (identity when
    # no clustering was used); dense_cols of grouped splits are G-aligned
    # runs of ranks expanded back to column ids.
    col_rank: Optional[np.ndarray] = None


def cluster_columns(csr: CSR, alpha: float = 0.3,
                    method: str = "auto") -> np.ndarray:
    """Global column-similarity ordering: BSMR's row clustering applied to
    S^T, so columns that occupy the same row panels become adjacent.

    This is new design surface (no reference counterpart): adjacent
    similar columns let the packer fetch G columns per gathered row (one
    physical row of the grouped B^T layout) with minimal wasted lanes,
    widening the gathered rows of small-K SDDMM.  Returns a permutation of [0, n): column ->
    position (columns with no nonzeros go last).
    """
    from bsmr_sddmm.data.sparse import COO
    from bsmr_sddmm.reorder.rows import row_reordering

    coo = csr.to_coo()
    csc = COO((csr.n, csr.m), coo.cols, coo.rows,
              coo.values).sorted_by_row().to_csr()
    rr = row_reordering(csc, alpha, method=method)
    ordered = rr.reordered_rows.astype(np.int64)
    missing = np.setdiff1d(np.arange(csr.n, dtype=np.int64), ordered,
                           assume_unique=False)
    return np.concatenate([ordered, missing])


def hub_first_rank(csr: CSR, hub_count: int,
                   base_order: Optional[np.ndarray] = None) -> np.ndarray:
    """Column rank with the ``hub_count`` highest-degree columns first
    (degree descending, column id tiebreak) and the rest in
    ``base_order`` (a cluster order, or identity) order.

    This is the column layout contract of the *dense hub slab* (pack.py):
    the leading ``hub_count`` ranks are computed by one plain matmul
    against a contiguous slice of the grouped B^T layout — no per-tile
    gathers — for scattered high-degree columns (power-law hubs,
    pruned-ML dense columns).  New design surface; the reference has no
    counterpart (it relies on the L2 cache for repeated hub-column
    fetches, src/sddmmKernel.cu:213-355)."""
    n = csr.n
    hub_count = int(min(hub_count, n))
    deg = np.bincount(csr.col_idx, minlength=n)
    hubs = np.lexsort((np.arange(n), -deg))[:hub_count]
    if base_order is None:
        base_order = np.arange(n, dtype=np.int64)
    is_hub = np.zeros(n, dtype=bool)
    is_hub[hubs] = True
    rest = base_order[~is_hub[base_order]]
    order = np.concatenate([hubs, rest])
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    return rank


def col_reordering(csr: CSR, reordered_rows: np.ndarray,
                   delta: float = config.DEFAULT_DELTA,
                   col_rank: Optional[np.ndarray] = None,
                   group_size: int = 1,
                   hub_cols: int = 0) -> ColReorderResult:
    """Per-panel dense/sparse split.

    Default (group_size=1, no col_rank): the reference-faithful per-column
    split.  With ``group_size`` G > 1 and a clustered ``col_rank``, the
    dense unit becomes a *physical group* of G rank-adjacent columns
    (one gather descriptor of the grouped B^T layout); a group is dense in
    a panel iff its nnz count >= ceil(delta * 16 * G).

    Fully vectorized: one global (panel, col) -> count histogram, one
    lexsort, and segment arithmetic — no per-panel Python loop (the
    reference parallelizes the same loop with OpenMP,
    src/colReordering.cu:292)."""
    if hub_cols > 0 and col_rank is None:
        raise ValueError("hub_cols requires a hub-first col_rank "
                         "(cols.hub_first_rank)")
    if group_size > 1 or col_rank is not None:
        if col_rank is None:
            col_rank = np.arange(csr.n, dtype=np.int64)
        return _grouped_col_reordering(csr, reordered_rows, delta,
                                       np.asarray(col_rank, dtype=np.int64),
                                       int(group_size), int(hub_cols))
    panel = config.ROW_PANEL_SIZE
    bcol = config.BLOCK_COL_SIZE
    n = csr.n
    reordered_rows = np.asarray(reordered_rows, dtype=np.int64)
    num_panels = (len(reordered_rows) + panel - 1) // panel
    threshold = int(math.ceil(delta * config.BLOCK_SIZE))

    def offsets(c):
        out = np.zeros(num_panels + 1, dtype=np.int64)
        np.cumsum(c, out=out[1:])
        return out

    if num_panels == 0 or csr.nnz == 0:
        z = np.zeros(0, dtype=np.int64)
        return ColReorderResult(num_panels, z, offsets([]), z,
                                offsets([]), offsets([]))

    # (panel, col) histogram over the entries of the reordered rows.
    row_panel = np.full(csr.m, -1, dtype=np.int64)
    row_panel[reordered_rows] = np.arange(len(reordered_rows)) // panel
    entry_panel = row_panel[csr.row_indices().astype(np.int64)]
    keep = entry_panel >= 0  # rows not in the reordering contribute nothing
    keys = entry_panel[keep] * np.int64(n) + csr.col_idx[keep]
    uniq, counts = np.unique(keys, return_counts=True)
    u_panel = uniq // n
    u_col = uniq % n

    # Per panel: descending count, ascending col as tiebreak.
    order = np.lexsort((u_col, -counts, u_panel))
    u_panel = u_panel[order]
    u_col = u_col[order]
    counts = counts[order]

    # Position of each (panel, col) within its panel.
    cols_per_panel = np.bincount(u_panel, minlength=num_panels).astype(
        np.int64)
    panel_start = offsets(cols_per_panel)
    pos = np.arange(len(u_col), dtype=np.int64) - panel_start[u_panel]

    # 16-col group sums per panel (trailing partial group = zero-padded).
    group_id = u_panel * ((n // bcol) + 1) + pos // bcol
    uniq_g, g_inv = np.unique(group_id, return_inverse=True)
    g_sums = np.bincount(g_inv, weights=counts.astype(np.float64))
    g_panel = (uniq_g // ((n // bcol) + 1)).astype(np.int64)
    g_dense = g_sums >= threshold
    dense_groups_per_panel = np.bincount(
        g_panel[g_dense], minlength=num_panels).astype(np.int64)
    nd_per_panel = dense_groups_per_panel * bcol  # incl sentinel padding

    is_dense = pos < nd_per_panel[u_panel]
    sparse_counts = np.bincount(u_panel[~is_dense],
                                minlength=num_panels).astype(np.int64)
    sparse_data = np.bincount(
        u_panel[~is_dense], weights=counts[~is_dense].astype(np.float64),
        minlength=num_panels).astype(np.int64)

    dense_off = offsets(nd_per_panel)
    sparse_off = offsets(sparse_counts)
    dense_cols = np.full(int(dense_off[-1]), n, dtype=np.int64)
    dense_cols[dense_off[u_panel[is_dense]] + pos[is_dense]] = \
        u_col[is_dense]
    sparse_pos = pos[~is_dense] - nd_per_panel[u_panel[~is_dense]]
    sparse_cols = np.empty(int(sparse_off[-1]), dtype=np.int64)
    sparse_cols[sparse_off[u_panel[~is_dense]] + sparse_pos] = \
        u_col[~is_dense]

    return ColReorderResult(
        num_row_panels=num_panels,
        dense_cols=dense_cols,
        dense_col_offsets=dense_off,
        sparse_cols=sparse_cols,
        sparse_col_offsets=sparse_off,
        sparse_data_offsets=offsets(sparse_data),
    )


def _grouped_col_reordering(csr: CSR, reordered_rows: np.ndarray,
                            delta: float, col_rank: np.ndarray,
                            group_size: int,
                            hub_cols: int = 0) -> ColReorderResult:
    """Group-granular dense/sparse split (see col_reordering docstring).

    Columns with rank < ``hub_cols`` are excluded from both the dense and
    sparse lists: they are covered by the dense hub slab (pack.py), not
    by tiles or residual."""
    panel = config.ROW_PANEL_SIZE
    G = group_size
    n = csr.n
    reordered_rows = np.asarray(reordered_rows, dtype=np.int64)
    num_panels = (len(reordered_rows) + panel - 1) // panel
    threshold = int(math.ceil(delta * panel * G))
    num_groups_total = (n + G - 1) // G

    def offsets(c):
        out = np.zeros(num_panels + 1, dtype=np.int64)
        np.cumsum(c, out=out[1:])
        return out

    if num_panels == 0 or csr.nnz == 0:
        z = np.zeros(0, dtype=np.int64)
        return ColReorderResult(num_panels, z, offsets([]), z,
                                offsets([]), offsets([]),
                                group_size=G, col_rank=col_rank)

    # order: rank position -> column id, padded with sentinel n.
    order = np.full(num_groups_total * G, n, dtype=np.int64)
    order[col_rank] = np.arange(n, dtype=np.int64)

    row_panel = np.full(csr.m, -1, dtype=np.int64)
    row_panel[reordered_rows] = np.arange(len(reordered_rows)) // panel
    entry_panel = row_panel[csr.row_indices().astype(np.int64)]
    keep = entry_panel >= 0
    e_panel = entry_panel[keep]
    e_col = csr.col_idx[keep].astype(np.int64)
    if hub_cols > 0:
        nonhub = col_rank[e_col] >= hub_cols
        e_panel = e_panel[nonhub]
        e_col = e_col[nonhub]
    e_grp = col_rank[e_col] // G

    # (panel, group) histogram.
    gkeys = e_panel * np.int64(num_groups_total) + e_grp
    uniq_g, counts_g = np.unique(gkeys, return_counts=True)
    g_panel = uniq_g // num_groups_total
    g_grp = uniq_g % num_groups_total
    g_dense = counts_g >= max(threshold, 1)

    # Dense groups per panel, descending count (ascending group tiebreak).
    dorder = np.lexsort((g_grp[g_dense], -counts_g[g_dense],
                         g_panel[g_dense]))
    dg_panel = g_panel[g_dense][dorder]
    dg_grp = g_grp[g_dense][dorder]
    dense_groups_per_panel = np.bincount(
        dg_panel, minlength=num_panels).astype(np.int64)
    dense_off = offsets(dense_groups_per_panel * G)

    # Expand groups to their member columns (G-aligned runs).
    member = (dg_grp[:, None] * G
              + np.arange(G, dtype=np.int64)[None, :]).reshape(-1)
    dense_cols = order[member]

    # Entry-level density; sparse residual per (panel, col).
    e_dense = g_dense[np.searchsorted(uniq_g, gkeys)]
    ckeys = e_panel[~e_dense] * np.int64(n) + e_col[~e_dense]
    uniq_c, counts_c = np.unique(ckeys, return_counts=True)
    s_panel = uniq_c // n
    s_col = uniq_c % n
    sparse_counts = np.bincount(s_panel, minlength=num_panels).astype(
        np.int64)
    sparse_off = offsets(sparse_counts)
    sparse_data = np.bincount(
        s_panel, weights=counts_c.astype(np.float64),
        minlength=num_panels).astype(np.int64)
    # uniq_c is already (panel, col)-sorted, matching sparse_off segments.
    sparse_cols = s_col

    return ColReorderResult(
        num_row_panels=num_panels,
        dense_cols=dense_cols,
        dense_col_offsets=dense_off,
        sparse_cols=sparse_cols,
        sparse_col_offsets=sparse_off,
        sparse_data_offsets=offsets(sparse_data),
        group_size=G,
        col_rank=col_rank,
    )
