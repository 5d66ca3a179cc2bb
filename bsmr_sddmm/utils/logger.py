"""Run metadata logger emitting the reference's ``[key : value]`` log schema.

Reference: include/Logger.hpp — ~40 fields (config, device, reordering
statistics, launch geometry, stage times, derived GFLOPS) serialized as
bracketed ``[key : value]`` lines so the analyze_results-style CSV tooling
(scripts/analyze_results.cpp) can parse logs from either implementation.
GFLOPS = 2*NNZ*K / (time * 1e6)  (Logger.hpp:178-180).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, TextIO

import jax


def _device_name() -> str:
    try:
        d = jax.devices()[0]
        return f"{d.platform}:{d.device_kind}"
    except Exception:  # pragma: no cover - device query is best-effort
        return "unknown"


@dataclasses.dataclass
class RunLog:
    """All metadata for one SDDMM run."""

    input_file: str = ""
    build_type: str = "Release"
    device: str = dataclasses.field(default_factory=_device_name)

    # Logical tile shape (the reference reports its WMMA shape here; we
    # report the logical dense-block shape the clustering uses).
    tile_m: int = 16
    tile_n: int = 16
    tile_k: int = 0  # filled with K

    k: int = 0
    m: int = 0
    n: int = 0
    nnz: int = 0
    sparsity: float = 0.0

    matrix_a_type: str = "float32"
    matrix_b_type: str = "float32"
    matrix_c_type: str = "float32"
    matrix_a_storage_order: str = "row_major"
    matrix_b_storage_order: str = "col_major"

    num_iterations: int = 10
    num_row_panels: int = 0

    original_num_dense_block: int = 0
    original_average_density: float = 0.0

    alpha: float = 0.0
    delta: float = 0.0
    num_clusters: int = 0
    num_dense_block: int = 0
    average_density: float = 0.0

    row_reordering_ms: float = 0.0
    col_reordering_ms: float = 0.0
    packing_ms: float = 0.0

    # "launch geometry": tile counts of the dense / residual paths.
    dense_grid: tuple = (0, 0, 0)
    sparse_grid: tuple = (0, 0, 0)
    num_dense_data: int = 0
    num_sparse_data: int = 0

    sddmm_time_ms: float = 0.0
    error_rate: float = 0.0
    check_passed: Optional[bool] = None

    @property
    def reordering_ms(self) -> float:
        return self.row_reordering_ms + self.col_reordering_ms

    @property
    def gflops(self) -> float:
        if self.sddmm_time_ms <= 0:
            return 0.0
        return 2.0 * self.nnz * self.k / (self.sddmm_time_ms * 1e6)

    def set_matrix(self, csr) -> None:
        self.m, self.n, self.nnz = csr.m, csr.n, csr.nnz
        self.sparsity = csr.sparsity

    def print_log(self, out: Optional[TextIO] = None) -> str:
        lines = []
        a = lines.append
        a(f"[File : {self.input_file}]")
        a(f"[Build type : {self.build_type}]")
        a(f"[Device : {self.device}]")
        a(f"[WMMA_M : {self.tile_m}], [WMMA_N : {self.tile_n}], "
          f"[WMMA_K : {self.tile_k}]")
        sparsity_pct = math.floor(self.sparsity * 10000) / 100.0
        a(f"[K : {self.k}], [M : {self.m}], [N : {self.n}], "
          f"[NNZ : {self.nnz}], [sparsity : {sparsity_pct:.2f}%]")
        a(f"[matrixA type : {self.matrix_a_type}]")
        a(f"[matrixB type : {self.matrix_b_type}]")
        a(f"[matrixC type : {self.matrix_c_type}]")
        a(f"[matrixA storageOrder : {self.matrix_a_storage_order}]")
        a(f"[matrixB storageOrder : {self.matrix_b_storage_order}]")
        a(f"[Num iterations : {self.num_iterations}]")
        a(f"[NumRowPanel : {self.num_row_panels}]")
        a(f"[original_numDenseBlock : {self.original_num_dense_block}]")
        a(f"[original_averageDensity : {self.original_average_density}]")
        a(f"[bsmr_alpha : {self.alpha}]")
        a(f"[bsmr_delta : {self.delta}]")
        a(f"[bsmr_numClusters : {self.num_clusters}]")
        a(f"[bsmr_numDenseBlock : {self.num_dense_block}]")
        a(f"[bsmr_averageDensity : {self.average_density}]")
        a(f"[bsmr_rowReordering : {self.row_reordering_ms}]")
        a(f"[bsmr_colReordering : {self.col_reordering_ms}]")
        a(f"[bsmr_reordering : {self.reordering_ms}]")
        a(f"[gridDim_dense : "
          f"{', '.join(str(x) for x in self.dense_grid)}]")
        a(f"[blockDim_dense : 0, 0, 0]")
        a(f"[gridDim_sparse : {self.sparse_grid[0]}, {self.sparse_grid[1]}, "
          f"{self.sparse_grid[2]}]")
        a(f"[blockDim_sparse : 0, 0, 0]")
        a(f"[bsmr_numDenseThreadBlocks : {sum(self.dense_grid)}]")
        a(f"[bsmr_numSparseThreadBlocks : {self.sparse_grid[0]}]")
        ratio = (sum(self.dense_grid) / self.sparse_grid[0]
                 if self.sparse_grid[0] else 0.0)
        a(f"[bsmr_threadBlockRatio : {ratio:.2f}]")
        a(f"[bsmr_numDenseData : {self.num_dense_data}]")
        a(f"[bsmr_numSparseData : {self.num_sparse_data}]")
        data_ratio = (self.num_dense_data / self.num_sparse_data
                      if self.num_sparse_data else 0.0)
        a(f"[bsmr_dataRatio: {data_ratio:.2f}]")
        a(f"[bsmr_gflops : {self.gflops}]")
        a(f"[bsmr_sddmm : {self.sddmm_time_ms}]")
        if self.error_rate > 0:
            a(f"[checkResults : NO PASS Error rate : "
              f"{self.error_rate * 100:.2f}%]")
        text = "\n".join(lines) + "\n"
        if out is not None:
            out.write(text)
        return text


def parse_log(text: str, prefer_nonzero: tuple = ()) -> dict:
    """Parse ``[key : value]`` lines back into a dict (analyze-results
    compatible).  Duplicate keys are last-wins, except keys ending with
    a suffix in ``prefer_nonzero``: there a non-zero value is never
    overwritten by a later zero placeholder (merged multi-pass logs
    emit ``[bsmr_gflops : 0.0]`` schema lines in passes that did not
    run that tool)."""
    def keep_old(key, old_val, new_val):
        if not any(key.endswith(sfx) for sfx in prefer_nonzero):
            return False
        try:
            return float(old_val) != 0.0 and float(new_val) == 0.0
        except ValueError:
            return False

    result = {}
    for line in text.splitlines():
        segment = line
        while "[" in segment and "]" in segment:
            start = segment.index("[")
            end = segment.index("]", start)
            body = segment[start + 1:end]
            if " : " in body:
                key, val = body.split(" : ", 1)
            elif ": " in body:
                key, val = body.split(": ", 1)
            else:
                key = None
            if key is not None:
                key, val = key.strip(), val.strip()
                if not (key in result and keep_old(key, result[key], val)):
                    result[key] = val
            segment = segment[end + 1:]
    return result
