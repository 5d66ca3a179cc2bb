"""Matrix file IO: Matrix Market (.mtx), DLMC (.smtx), SNAP edge lists (.txt).

Equivalent capability to the reference loaders (src/Matrix.cpp:280-294 suffix
dispatch; .mtx at :398-480; .smtx at :297-371; .txt SNAP at :482-585; Market
writer at :595-744), with two capability extensions the reference's harness
had to patch around externally: ``symmetric`` and ``pattern`` Matrix Market
headers are handled natively (the reference requires
scripts/exclude_invalid_dataset.py to rewrite such files first).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from bsmr_sddmm.data.sparse import COO, CSR


def load(path: str | Path, dtype=np.float32) -> CSR:
    """Load a sparse matrix by file suffix (.mtx / .smtx / .txt)."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".mtx":
        return load_mtx(path, dtype=dtype)
    if suffix == ".smtx":
        return load_smtx(path, dtype=dtype)
    if suffix == ".txt":
        return load_snap(path, dtype=dtype)
    raise ValueError(f"unsupported matrix file suffix: {suffix}")


def _mtx_header(first_line: str):
    parts = first_line.strip().lower().split()
    if len(parts) < 5 or parts[0] != "%%matrixmarket" or parts[1] != "matrix":
        raise ValueError(f"bad MatrixMarket header: {first_line!r}")
    layout, field, symmetry = parts[2], parts[3], parts[4]
    return layout, field, symmetry


def load_mtx(path: str | Path, dtype=np.float32,
             use_native: bool = True) -> CSR:
    """Matrix Market coordinate reader (1-based indices).

    Uses the C++ buffered parser (bsmr_sddmm.native) when available, with
    this pure-Python reader as fallback."""
    if use_native:
        from bsmr_sddmm import native
        parsed = native.mtx_read(path) if native.available() else None
        if parsed is not None:
            m, n, rows, cols, vals, symmetry = parsed
            rows = rows.astype(np.int64)
            cols_l = cols.astype(np.int64)
            vals = vals.astype(dtype)
            if symmetry in ("symmetric", "skew-symmetric"):
                off = rows != cols_l
                sign = -1.0 if symmetry == "skew-symmetric" else 1.0
                rows, cols_l, vals = (
                    np.concatenate([rows, cols_l[off]]),
                    np.concatenate([cols_l, rows[off]]),
                    np.concatenate([vals, (sign * vals[off]).astype(dtype)]))
            coo = COO((m, n), rows, cols_l, vals)
            coo.validate()
            return coo.to_csr(dtype=dtype)
    with open(path, "r") as f:
        first = f.readline()
        layout, field, symmetry = _mtx_header(first)
        if layout != "coordinate":
            raise ValueError("only coordinate MatrixMarket files supported")
        if field == "complex":
            raise ValueError("complex matrices not supported")
        # Skip remaining comments.
        line = f.readline()
        while line and line.lstrip().startswith("%"):
            line = f.readline()
        m, n, nnz = (int(tok) for tok in line.split()[:3])
        data = np.loadtxt(f, dtype=np.float64, ndmin=2, max_rows=nnz)
    if data.size == 0:
        data = np.zeros((0, 3))
    rows = data[:, 0].astype(np.int64) - 1
    cols = data[:, 1].astype(np.int64) - 1
    if field == "pattern" or data.shape[1] < 3:
        vals = np.ones(len(rows), dtype=dtype)
    else:
        vals = data[:, 2].astype(dtype)
    if len(rows) != nnz:
        raise ValueError(f"{path}: expected {nnz} entries, got {len(rows)}")
    if symmetry in ("symmetric", "skew-symmetric", "hermitian"):
        off = rows != cols
        rows = np.concatenate([rows, cols[off]])
        cols2 = np.concatenate([cols, data[:, 0][off].astype(np.int64) - 1])
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        vals = np.concatenate([vals, (sign * vals[off]).astype(dtype)])
        cols = cols2
    coo = COO((m, n), rows, cols, vals)
    coo.validate()
    return coo.to_csr(dtype=dtype)


def save_mtx(path: str | Path, csr: CSR) -> None:
    """Matrix Market coordinate writer (general real), 1-based."""
    coo = csr.to_coo()
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{csr.m} {csr.n} {csr.nnz}\n")
        for r, c, v in zip(coo.rows, coo.cols, coo.values):
            f.write(f"{int(r) + 1} {int(c) + 1} {float(v)}\n")


_SPLIT = re.compile(r"[,\s]+")


def load_smtx(path: str | Path, dtype=np.float32) -> CSR:
    """DLMC .smtx reader: line 1 = "m, n, nnz"; line 2 = row offsets;
    line 3 = column indices.  Values are set to 1 (pattern-only format),
    matching the reference (src/Matrix.cpp:350)."""
    with open(path, "r") as f:
        line = f.readline()
        while line and line.lstrip().startswith("%"):
            line = f.readline()
        m, n, nnz = tuple(int(t) for t in _SPLIT.split(line.strip()) if t)[:3]
        row_ptr = np.array(
            [int(t) for t in _SPLIT.split(f.readline().strip()) if t],
            dtype=np.int64)
        col_idx = np.array(
            [int(t) for t in _SPLIT.split(f.readline().strip()) if t],
            dtype=np.int32)
    if len(row_ptr) != m + 1 or len(col_idx) != nnz:
        raise ValueError(f"{path}: inconsistent smtx header/arrays")
    csr = CSR((m, n), row_ptr, col_idx, np.ones(nnz, dtype=dtype))
    csr.validate()
    return csr


def save_smtx(path: str | Path, csr: CSR) -> None:
    with open(path, "w") as f:
        f.write(f"{csr.m}, {csr.n}, {csr.nnz}\n")
        f.write(" ".join(str(int(x)) for x in csr.row_ptr) + "\n")
        f.write(" ".join(str(int(x)) for x in csr.col_idx) + "\n")


def load_snap(path: str | Path, dtype=np.float32) -> CSR:
    """SNAP graph edge-list reader.  Nodes are relabeled densely in
    first-appearance order (reference src/Matrix.cpp:523-556); the adjacency
    value of each edge is 1."""
    nodes = edges = None
    src, dst = [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("#"):
                mm = re.search(r"Nodes:\s*(\d+)", line)
                if mm:
                    nodes = int(mm.group(1))
                mm = re.search(r"Edges:\s*(\d+)", line)
                if mm:
                    edges = int(mm.group(1))
                continue
            toks = line.split()
            if len(toks) < 2:
                continue
            src.append(int(toks[0]))
            dst.append(int(toks[1]))
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    # Dense relabel in first-appearance order over the interleaved stream.
    stream = np.empty(2 * len(src), dtype=np.int64)
    stream[0::2] = src
    stream[1::2] = dst
    _, first_pos, inverse = np.unique(stream, return_index=True,
                                      return_inverse=True)
    order = np.argsort(np.argsort(first_pos))  # rank by first appearance
    relabeled = order[inverse]
    rows, cols = relabeled[0::2], relabeled[1::2]
    num_nodes = nodes if nodes is not None else int(relabeled.max() + 1)
    num_nodes = max(num_nodes, int(relabeled.max() + 1) if len(relabeled) else 0)
    # Deduplicate repeated edges (SNAP lists can repeat).
    keys = rows * num_nodes + cols
    _, uniq = np.unique(keys, return_index=True)
    rows, cols = rows[np.sort(uniq)], cols[np.sort(uniq)]
    coo = COO((num_nodes, num_nodes), rows, cols,
              np.ones(len(rows), dtype=dtype))
    return coo.to_csr(dtype=dtype)


def save_npz_graph(path: str | Path, csr: CSR) -> None:
    """Write the FlashSparse-style .npz graph format the reference's
    harness converts to for cross-tool comparisons
    (reference scripts/convert_mtx_to_npz.py: keys src_li/dst_li/
    num_nodes_src/num_nodes_dst/num_edges)."""
    np.savez(Path(path),
             src_li=csr.row_indices().astype(np.int32),
             dst_li=csr.col_idx.astype(np.int32),
             num_nodes_src=csr.m,
             num_nodes_dst=csr.n,
             num_edges=csr.nnz)


def load_npz_graph(path: str | Path, dtype=np.float32) -> CSR:
    """Load a FlashSparse-style .npz graph back into CSR (unit values,
    pattern semantics — matching the converter above)."""
    with np.load(Path(path)) as z:
        rows = z["src_li"].astype(np.int64)
        cols = z["dst_li"].astype(np.int64)
        m = int(z["num_nodes_src"])
        n = int(z["num_nodes_dst"])
    coo = COO((m, n), rows, cols, np.ones(len(rows), dtype=dtype))
    return coo.to_csr(dtype=dtype)
