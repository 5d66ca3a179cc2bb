"""Host-side sparse matrix containers (CSR / COO).

Equivalent surface to the reference's ``sparseMatrix::CSR/COO``
(include/Matrix.hpp:172-397, src/Matrix.cpp:280-953) but numpy-backed:
these are *host preprocessing* containers; device data is produced by
``bsmr_sddmm.reorder.pack`` as jax.Arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class COO:
    """Coordinate-format sparse matrix (pattern + optional values)."""

    shape: Tuple[int, int]
    rows: np.ndarray  # (nnz,) int32
    cols: np.ndarray  # (nnz,) int32
    values: np.ndarray  # (nnz,) float

    def __post_init__(self):
        self.rows = np.asarray(self.rows, dtype=np.int32)
        self.cols = np.asarray(self.cols, dtype=np.int32)
        self.values = np.asarray(self.values)
        if not (len(self.rows) == len(self.cols) == len(self.values)):
            raise ValueError("rows/cols/values length mismatch")

    @property
    def nnz(self) -> int:
        return int(len(self.values))

    def validate(self) -> None:
        """Bounds + duplicate validation (reference src/Matrix.cpp:442-465)."""
        m, n = self.shape
        if self.nnz:
            if self.rows.min(initial=0) < 0 or self.rows.max(initial=0) >= m:
                raise ValueError("row index out of bounds")
            if self.cols.min(initial=0) < 0 or self.cols.max(initial=0) >= n:
                raise ValueError("col index out of bounds")
            keys = self.rows.astype(np.int64) * n + self.cols
            if len(np.unique(keys)) != self.nnz:
                raise ValueError("duplicate (row, col) entries")

    def sorted_by_row(self) -> "COO":
        """Row-major (row, then col) ordering — the CSR entry order."""
        order = np.lexsort((self.cols, self.rows))
        return COO(self.shape, self.rows[order], self.cols[order],
                   self.values[order])

    def to_csr(self, dtype=np.float32) -> "CSR":
        s = self.sorted_by_row()
        m = self.shape[0]
        row_ptr = np.zeros(m + 1, dtype=np.int64)
        np.add.at(row_ptr, s.rows.astype(np.int64) + 1, 1)
        row_ptr = np.cumsum(row_ptr)
        return CSR(self.shape, row_ptr.astype(np.int64), s.cols,
                   s.values.astype(dtype))

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.values.dtype)
        out[self.rows, self.cols] = self.values
        return out


@dataclasses.dataclass
class CSR:
    """Compressed-sparse-row matrix."""

    shape: Tuple[int, int]
    row_ptr: np.ndarray  # (m+1,) int64
    col_idx: np.ndarray  # (nnz,) int32
    values: np.ndarray   # (nnz,) float

    def __post_init__(self):
        self.row_ptr = np.asarray(self.row_ptr, dtype=np.int64)
        self.col_idx = np.asarray(self.col_idx, dtype=np.int32)
        self.values = np.asarray(self.values)

    @property
    def nnz(self) -> int:
        return int(len(self.col_idx))

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def sparsity(self) -> float:
        total = self.shape[0] * self.shape[1]
        return 1.0 - self.nnz / total if total else 0.0

    def row_indices(self) -> np.ndarray:
        """Expanded (nnz,) row index per entry."""
        counts = np.diff(self.row_ptr)
        return np.repeat(
            np.arange(self.m, dtype=np.int32), counts.astype(np.int64))

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.row_ptr).astype(np.int64)

    def to_coo(self) -> COO:
        return COO(self.shape, self.row_indices(), self.col_idx, self.values)

    def to_dense(self) -> np.ndarray:
        return self.to_coo().to_dense()

    def validate(self) -> None:
        if len(self.row_ptr) != self.m + 1:
            raise ValueError("row_ptr length mismatch")
        if self.row_ptr[0] != 0 or self.row_ptr[-1] != self.nnz:
            raise ValueError("row_ptr endpoints invalid")
        if np.any(np.diff(self.row_ptr) < 0):
            raise ValueError("row_ptr not monotone")
        self.to_coo().validate()
