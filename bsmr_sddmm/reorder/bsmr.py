"""BSMR controller: row reordering -> column reordering, with stage timing.

Reference: class BSMR (include/BSMR.hpp:21-63, src/BSMR.cpp:16-81) and the
reordering-quality evaluation (evaluationReordering, src/BSMR.cpp:826-930;
original-matrix counterpart :955-994).
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np

from bsmr_sddmm import config
from bsmr_sddmm.data.sparse import CSR
from bsmr_sddmm.reorder.cols import col_reordering
from bsmr_sddmm.reorder.rows import row_reordering


class BSMR:
    """Block-wise Similarity-based Matrix Reordering."""

    def __init__(self, alpha: float, delta: float, csr: CSR,
                 method: str = "auto",
                 col_block_size: Optional[int] = None,
                 group_size: int = 1,
                 col_rank: Optional[np.ndarray] = None,
                 cluster_cols: bool = False,
                 hub_cols: int = 0,
                 compute: bool = True):
        self.alpha = float(alpha)
        self.delta = float(delta)
        self._method = method
        self._col_block_size = col_block_size
        self.group_size = int(group_size)
        self.hub_cols = int(hub_cols)
        if self.hub_cols > 0 and col_rank is None:
            # hub slab requires the hub-first column layout
            from bsmr_sddmm.reorder.cols import hub_first_rank
            col_rank = hub_first_rank(csr, self.hub_cols)
        if col_rank is None and cluster_cols:
            from bsmr_sddmm.reorder.cols import cluster_columns
            t0 = time.perf_counter()
            order = cluster_columns(csr, alpha, method=method)
            col_rank = np.empty(csr.n, dtype=np.int64)
            col_rank[order] = np.arange(csr.n)
            self.col_clustering_ms = (time.perf_counter() - t0) * 1e3
        else:
            self.col_clustering_ms = 0.0
        self.col_rank = col_rank
        self.reordered_rows = np.zeros(0, dtype=np.int64)
        self.cluster_ids = np.zeros(csr.m, dtype=np.int64)
        self.num_clusters = 0
        self.dense_cols = np.zeros(0, dtype=np.int64)
        self.dense_col_offsets = np.zeros(1, dtype=np.int64)
        self.sparse_cols = np.zeros(0, dtype=np.int64)
        self.sparse_col_offsets = np.zeros(1, dtype=np.int64)
        self.sparse_data_offsets = np.zeros(1, dtype=np.int64)
        self.row_reordering_ms = 0.0
        self.col_reordering_ms = 0.0
        if compute:
            self.run_row_reordering(csr)
            self.run_col_reordering(csr)

    # -- stages (separately callable so the alpha/delta sweep in test mode
    #    can reuse one row reordering across deltas, reference
    #    src/sddmm.cu:62-118) --

    def run_row_reordering(self, csr: CSR, alpha: Optional[float] = None):
        if alpha is not None:
            self.alpha = float(alpha)
        t0 = time.perf_counter()
        rr = row_reordering(csr, self.alpha, method=self._method,
                            col_block_size=self._col_block_size)
        self.row_reordering_ms = (time.perf_counter() - t0) * 1e3
        self.reordered_rows = rr.reordered_rows
        self.cluster_ids = rr.cluster_ids
        self.num_clusters = rr.num_clusters
        return self

    def run_col_reordering(self, csr: CSR, delta: Optional[float] = None):
        if delta is not None:
            self.delta = float(delta)
        t0 = time.perf_counter()
        cc = col_reordering(csr, self.reordered_rows, self.delta,
                            col_rank=self.col_rank,
                            group_size=self.group_size,
                            hub_cols=self.hub_cols)
        self.col_reordering_ms = (time.perf_counter() - t0) * 1e3
        self.num_row_panels = cc.num_row_panels
        self.dense_cols = cc.dense_cols
        self.dense_col_offsets = cc.dense_col_offsets
        self.sparse_cols = cc.sparse_cols
        self.sparse_col_offsets = cc.sparse_col_offsets
        self.sparse_data_offsets = cc.sparse_data_offsets
        return self

    @property
    def num_dense_blocks(self) -> int:
        return int(self.dense_col_offsets[-1] // config.BLOCK_COL_SIZE)

    @property
    def reordering_ms(self) -> float:
        return self.row_reordering_ms + self.col_reordering_ms


def original_matrix_block_stats(csr: CSR,
                                delta: float) -> tuple[int, float]:
    """(num_dense_blocks, average_density) of the *unreordered* matrix,
    using the same per-panel dense/sparse split — the no-reordering
    comparison the reference logs (src/BSMR.cpp:955-994)."""
    identity = np.nonzero(csr.row_nnz() > 0)[0]
    cc = col_reordering(csr, identity, delta)
    num_blocks = int(cc.dense_col_offsets[-1] // config.BLOCK_COL_SIZE)
    if not num_blocks:
        return 0, 0.0
    dense_nnz = csr.nnz - int(cc.sparse_data_offsets[-1])
    return num_blocks, dense_nnz / (num_blocks * config.BLOCK_SIZE)
