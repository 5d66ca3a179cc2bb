"""Golden model, pure-JAX CSR SDDMM, SpMM, batched ops, tolerance checker."""

import numpy as np

from bsmr_sddmm.data import generate
from bsmr_sddmm.ops import (batched_csr_sddmm, batched_transpose, csr_sddmm,
                           csr_spmm, sddmm_reference)
from bsmr_sddmm.ops.csr_sddmm import csr_sddmm as csr_sddmm_fn
from bsmr_sddmm.utils.check import check_values


def _mats(m=64, n=48, k=16, density=0.1, seed=0):
    s = generate.random_sparse(m, n, density, seed=seed)
    a = generate.make_dense(m, k, seed=seed + 1)
    b = generate.make_dense(k, n, seed=seed + 2)
    return a, b, s


def test_reference_matches_dense_masked():
    a, b, s = _mats()
    vals = sddmm_reference(a, b, s)
    full = a.astype(np.float64) @ b.astype(np.float64)
    coo = s.to_coo()
    expect = full[coo.rows, coo.cols]
    np.testing.assert_allclose(vals, expect, rtol=1e-5)


def test_reference_scale_by_values():
    a, b, s = _mats()
    vals = sddmm_reference(a, b, s, scale_by_values=True)
    base = sddmm_reference(a, b, s)
    np.testing.assert_allclose(vals, base * s.values, rtol=1e-6)


def test_csr_sddmm_matches_reference():
    a, b, s = _mats(m=100, n=80, k=32, density=0.07)
    got = csr_sddmm(a, b, s)
    want = sddmm_reference(a, b, s)
    res = check_values(want, got)
    assert res.passed, str(res)


def test_csr_sddmm_blocked_path():
    a, b, s = _mats(m=128, n=96, k=32, density=0.2, seed=3)
    got = csr_sddmm_fn(a, b, s, max_gathered_mb=0.05)  # force chunking
    want = sddmm_reference(a, b, s)
    res = check_values(want, got)
    assert res.passed, str(res)


def test_check_values_detects_errors():
    expect = np.ones(100)
    actual = expect.copy()
    actual[7] = 2.0
    res = check_values(expect, actual)
    assert not res.passed
    assert res.num_errors == 1
    assert res.first_errors[0][0] == 7


def test_spmm_matches_dense():
    _, _, s = _mats(density=0.1, seed=9)
    x = generate.make_dense(s.n, 8, seed=10)
    got = csr_spmm(s, x)
    want = s.to_dense().astype(np.float64) @ x.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_batched_csr_sddmm():
    bsz, m, n, k = 3, 40, 30, 8
    s = generate.random_sparse(m, n, 0.1, seed=4)
    rng = np.random.default_rng(5)
    a = rng.random((bsz, m, k)).astype(np.float32)
    b = rng.random((bsz, k, n)).astype(np.float32)
    got = batched_csr_sddmm(a, b, s)
    assert got.shape == (bsz, s.nnz)
    for i in range(bsz):
        want = sddmm_reference(a[i], b[i], s)
        res = check_values(want, got[i])
        assert res.passed, f"batch {i}: {res}"


def test_batched_transpose():
    rng = np.random.default_rng(6)
    x = rng.random((4, 7, 5)).astype(np.float32)
    got = np.asarray(batched_transpose(x))
    np.testing.assert_array_equal(got, np.swapaxes(x, 1, 2))


def test_dense_masked_sddmm_matches_reference():
    from bsmr_sddmm.ops.dense import dense_masked_sddmm
    a, b, s = _mats(m=100, n=80, k=32, density=0.3, seed=9)
    got = dense_masked_sddmm(a, b, s, compute_dtype="float32")
    want = sddmm_reference(a, b, s)
    res = check_values(want, got)
    assert res.passed, str(res)


def test_dense_runner_csr_order_matches_reference():
    from bsmr_sddmm.ops.dense import DenseSDDMM
    a, b, s = _mats(m=100, n=80, k=32, density=0.3, seed=9)
    runner = DenseSDDMM.from_csr(s, compute_dtype="float32")
    got = np.asarray(runner(a, b=b, order="csr"))
    want = sddmm_reference(a, b, s)
    res = check_values(want, got)
    assert res.passed, str(res)


def test_dense_runner_packed_layout_contract():
    # native layout: value of CSR entry (r, c) sits at full[r, c]
    from bsmr_sddmm.ops.dense import DenseSDDMM
    a, b, s = _mats(m=64, n=48, k=16, density=0.25, seed=3)
    runner = DenseSDDMM.from_csr(s, compute_dtype="float32")
    a_dev, bt_dev = runner.prepare_operands(a, b=b)
    full = np.asarray(runner.run_padded(a_dev, bt_dev, order="packed"))
    assert full.shape == (s.m, s.n)
    coo = s.to_coo()
    want = sddmm_reference(a, b, s)
    res = check_values(want, full[coo.rows, coo.cols])
    assert res.passed, str(res)
    # to_csr_order of the packed output equals the csr-order run
    flat = np.asarray(runner.to_csr_order(
        runner.run_padded(a_dev, bt_dev, order="packed")))
    np.testing.assert_allclose(flat, np.asarray(want), rtol=1e-3,
                               atol=1e-5)


def test_dense_runner_measure_paths_run():
    from bsmr_sddmm.ops.dense import DenseSDDMM
    a, b, s = _mats(m=64, n=48, k=16, density=0.25, seed=3)
    runner = DenseSDDMM.from_csr(s, compute_dtype="tf32")
    a_dev, bt_dev = runner.prepare_operands(a, b=b)
    for order in ("packed", "csr"):
        ms = runner.measure_kernel_ms(a_dev, bt_dev, iterations=3,
                                      repeats=1, order=order)
        assert ms >= 0.0


def test_profiling_wrappers_noop_safe(tmp_path):
    import jax.numpy as jnp
    from bsmr_sddmm.utils.profiling import annotate, trace
    with trace(tmp_path):
        with annotate("stage"):
            assert float(jnp.asarray(1.0) + 1.0) == 2.0


def test_batch_overlap_report():
    from bsmr_sddmm.data import generate
    from bsmr_sddmm.ops.batch import batch_overlap_report
    from bsmr_sddmm.ops.hybrid import HybridSDDMM

    csr = generate.block_clustered(8, 8, block_prob=0.3, seed=9)
    runner = HybridSDDMM.from_csr(csr, 0.3, 0.3, compute_dtype="float32")
    rng = np.random.default_rng(0)
    a = rng.random((2, csr.m, 16), dtype=np.float32)
    b = rng.random((2, 16, csr.n), dtype=np.float32)
    rep = batch_overlap_report(runner, a, b, iterations=3)
    assert rep["batch_size"] == 2
    assert rep["batch_ms"] > 0 and rep["serial_ms"] > 0
    assert rep["overlap_efficiency"] > 0
