"""Native C++ accelerators: build, parse parity, clustering parity."""

import numpy as np
import pytest

from bsmr_sddmm import native
from bsmr_sddmm.data import generate, io
from bsmr_sddmm.reorder import rows as rows_mod

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ toolchain")


def test_native_builds():
    assert native.available()


def test_mtx_parse_parity(tmp_path, small_random_csr):
    path = tmp_path / "x.mtx"
    io.save_mtx(path, small_random_csr)
    fast = io.load_mtx(path, use_native=True)
    slow = io.load_mtx(path, use_native=False)
    assert fast.shape == slow.shape
    assert np.array_equal(fast.row_ptr, slow.row_ptr)
    assert np.array_equal(fast.col_idx, slow.col_idx)
    np.testing.assert_allclose(fast.values, slow.values, rtol=1e-6)


def test_mtx_parse_symmetric(tmp_path):
    path = tmp_path / "sym.mtx"
    path.write_text(
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "3 3 3\n"
        "1 1 5.0\n2 1 2.0\n3 2 7.0\n")
    fast = io.load_mtx(path, use_native=True)
    slow = io.load_mtx(path, use_native=False)
    assert np.array_equal(fast.to_dense(), slow.to_dense())


def test_mtx_parse_error(tmp_path):
    path = tmp_path / "bad.mtx"
    path.write_text("%%MatrixMarket matrix coordinate real general\n"
                    "2 2 3\n1 1 1.0\n")  # too few entries
    with pytest.raises(ValueError, match="parse error"):
        native.mtx_read(path)


def test_greedy_cluster_parity(clustered_csr):
    """Native greedy clustering must agree exactly with the numpy
    implementation (same algorithm, same order)."""
    csr = clustered_csr
    block_ptr, block_idx, block_cnt, nb = rows_mod.row_encodings(csr, 16)
    disp = rows_mod.dispersion_scores(csr, block_ptr, block_cnt, 16)
    nonempty = np.nonzero(disp > 0)[0]
    order = nonempty[np.argsort(disp[nonempty], kind="stable")]

    ref_cl, ref_nc = rows_mod._greedy_cluster(
        order, block_ptr, block_idx, block_cnt, nb, 0.3)
    nat = native.greedy_cluster(block_ptr, block_idx, block_cnt, order,
                                csr.m, nb, 0.3)
    assert nat is not None
    nat_cl, nat_nc = nat
    assert nat_nc == ref_nc
    assert np.array_equal(nat_cl, ref_cl)


def test_cpu_golden_parity(small_random_csr):
    from bsmr_sddmm.ops.reference import sddmm_reference
    csr = small_random_csr
    a = generate.make_dense(csr.m, 16, seed=1)
    b = generate.make_dense(16, csr.n, seed=2)
    got = native.cpu_golden_sddmm(a, np.ascontiguousarray(b.T),
                                  csr.row_ptr, csr.col_idx)
    assert got is not None
    want = sddmm_reference(a, b, csr)
    np.testing.assert_allclose(got, want, rtol=1e-5)
