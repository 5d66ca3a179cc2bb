"""Data layer: containers, IO round-trips, generators, validation."""

import numpy as np
import pytest

from bsmr_sddmm.data import generate, io
from bsmr_sddmm.data.sparse import COO, CSR


def test_coo_csr_roundtrip():
    coo = COO((4, 5), [2, 0, 1, 2], [3, 1, 4, 0], [1.0, 2.0, 3.0, 4.0])
    csr = coo.to_csr()
    assert csr.nnz == 4
    assert np.array_equal(csr.row_ptr, [0, 1, 2, 4, 4])
    dense = csr.to_dense()
    assert dense[2, 3] == 1.0 and dense[0, 1] == 2.0
    back = csr.to_coo()
    assert np.array_equal(back.to_dense(), dense)


def test_coo_validate_rejects_duplicates():
    coo = COO((3, 3), [0, 0], [1, 1], [1.0, 2.0])
    with pytest.raises(ValueError, match="duplicate"):
        coo.validate()


def test_coo_validate_rejects_out_of_bounds():
    coo = COO((3, 3), [0, 5], [1, 1], [1.0, 2.0])
    with pytest.raises(ValueError, match="out of bounds"):
        coo.validate()


def test_csr_row_indices(small_random_csr):
    csr = small_random_csr
    rows = csr.row_indices()
    assert len(rows) == csr.nnz
    # Row indices are non-decreasing and match row_ptr counts.
    assert np.all(np.diff(rows) >= 0)
    counts = np.bincount(rows, minlength=csr.m)
    assert np.array_equal(counts, np.diff(csr.row_ptr))


def test_mtx_roundtrip(tmp_path, small_random_csr):
    path = tmp_path / "x.mtx"
    io.save_mtx(path, small_random_csr)
    back = io.load(path)
    assert back.shape == small_random_csr.shape
    assert back.nnz == small_random_csr.nnz
    np.testing.assert_allclose(back.to_dense(), small_random_csr.to_dense(),
                               rtol=1e-6)


def test_mtx_symmetric(tmp_path):
    path = tmp_path / "sym.mtx"
    path.write_text(
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "% comment\n"
        "3 3 3\n"
        "1 1 5.0\n"
        "2 1 2.0\n"
        "3 2 7.0\n")
    csr = io.load(path)
    dense = csr.to_dense()
    assert dense[0, 0] == 5.0
    assert dense[1, 0] == 2.0 and dense[0, 1] == 2.0
    assert dense[2, 1] == 7.0 and dense[1, 2] == 7.0
    assert csr.nnz == 5


def test_mtx_pattern(tmp_path):
    path = tmp_path / "pat.mtx"
    path.write_text(
        "%%MatrixMarket matrix coordinate pattern general\n"
        "2 2 2\n"
        "1 2\n"
        "2 1\n")
    csr = io.load(path)
    assert csr.nnz == 2
    assert np.all(csr.values == 1.0)


def test_smtx_roundtrip(tmp_path, small_random_csr):
    path = tmp_path / "x.smtx"
    io.save_smtx(path, small_random_csr)
    back = io.load(path)
    assert back.shape == small_random_csr.shape
    assert np.array_equal(back.row_ptr, small_random_csr.row_ptr)
    assert np.array_equal(back.col_idx, small_random_csr.col_idx)
    assert np.all(back.values == 1.0)  # smtx is pattern-only


def test_snap_loader(tmp_path):
    path = tmp_path / "g.txt"
    path.write_text(
        "# Directed graph\n"
        "# Nodes: 4 Edges: 4\n"
        "10 20\n"
        "20 30\n"
        "10 30\n"
        "40 10\n")
    csr = io.load(path)
    assert csr.shape == (4, 4)
    assert csr.nnz == 4
    # first-appearance relabeling: 10->0, 20->1, 30->2, 40->3
    dense = csr.to_dense()
    assert dense[0, 1] == 1 and dense[1, 2] == 1
    assert dense[0, 2] == 1 and dense[3, 0] == 1


def test_generators_deterministic():
    a1 = generate.make_dense(8, 4, seed=11)
    a2 = generate.make_dense(8, 4, seed=11)
    assert np.array_equal(a1, a2)
    assert a1.min() >= 0.0 and a1.max() < 2.0
    s1 = generate.random_sparse(50, 40, 0.1, seed=5)
    s2 = generate.random_sparse(50, 40, 0.1, seed=5)
    assert np.array_equal(s1.col_idx, s2.col_idx)
    s1.validate()


def test_block_clustered_has_structure():
    csr = generate.block_clustered(10, 10, block_prob=0.3, seed=1)
    csr.validate()
    assert csr.nnz > 100


def test_powerlaw_graph():
    csr = generate.powerlaw_graph(300, avg_degree=8, seed=2)
    csr.validate()
    assert csr.shape == (300, 300)
    assert csr.nnz > 300


def test_smtx_to_bf16_hybrid_pipeline(tmp_path):
    """BASELINE config 4: DLMC-style .smtx matrix through the bfloat16
    accumulate-fp32 hybrid path (pattern-only values)."""
    from bsmr_sddmm.ops.hybrid import HybridSDDMM
    from bsmr_sddmm.ops.reference import sddmm_reference

    csr0 = generate.block_clustered(8, 8, block_prob=0.25, seed=77)
    path = tmp_path / "dlmc.smtx"
    io.save_smtx(path, csr0)
    csr = io.load(path)
    k = 64
    a = generate.make_dense(csr.m, k, seed=1)
    b = generate.make_dense(k, csr.n, seed=2)
    runner = HybridSDDMM.from_csr(csr, 0.3, 0.2, compute_dtype="bfloat16")
    got = np.asarray(runner(a, b, order="csr"))
    want = sddmm_reference(a, b, csr)
    # bf16 inputs: ~2^-9 relative error class
    rel = np.abs(got - want) / (np.abs(want) + 1e-6)
    assert np.median(rel) < 5e-3
    assert rel.max() < 5e-2


def test_npz_graph_roundtrip(tmp_path, small_random_csr):
    from bsmr_sddmm.data import io

    path = tmp_path / "g.npz"
    io.save_npz_graph(path, small_random_csr)
    back = io.load_npz_graph(path)
    assert back.m == small_random_csr.m
    assert back.n == small_random_csr.n
    assert np.array_equal(back.col_idx, small_random_csr.col_idx)
    assert np.array_equal(back.row_ptr, small_random_csr.row_ptr)


def test_convert_mtx_to_npz_script(tmp_path, small_random_csr):
    import runpy
    import sys

    from bsmr_sddmm.data import io

    mtx = tmp_path / "m.mtx"
    io.save_mtx(mtx, small_random_csr)
    argv = sys.argv
    sys.argv = ["convert_mtx_to_npz.py", str(mtx), "-o",
                str(tmp_path / "npz")]
    try:
        with pytest.raises(SystemExit):
            runpy.run_path("scripts/convert_mtx_to_npz.py",
                           run_name="__main__")
    finally:
        sys.argv = argv
    back = io.load_npz_graph(tmp_path / "npz" / "m.npz")
    assert back.nnz == small_random_csr.nnz
