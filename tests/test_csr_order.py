"""CSR-order delivery: one per-entry gather of the packed output.

The contract is bit-exactness against indexing the packed vector by the
packing's ``inv_idx`` (reference output convention: matrixP[csrIdx],
src/sddmmKernel.cu:213-355), and the reference's tolerance against the
float64 golden model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bsmr_sddmm.data import generate
from bsmr_sddmm.data.sparse import COO
from bsmr_sddmm.ops import dense as dense_mod
from bsmr_sddmm.ops.dense import DenseSDDMM
from bsmr_sddmm.ops.hybrid import HybridSDDMM
from bsmr_sddmm.ops.reference import sddmm_reference
from bsmr_sddmm.reorder.bsmr import BSMR
from bsmr_sddmm.reorder.pack import pack
from bsmr_sddmm.utils.check import check_values


def _clustered():
    return generate.block_clustered(64, 64, block_prob=0.08,
                                    block_density=0.7,
                                    noise_density=0.001, seed=7)


def _scattered():
    return generate.random_sparse(300, 400, density=0.02, seed=2)


def _ragged():
    # empty rows and a row count that is no multiple of the panel height
    return COO((37, 50), [0, 5, 5, 36], [1, 2, 3, 49], np.ones(4)).to_csr()


def _single():
    return COO((16, 16), [3], [9], np.ones(1)).to_csr()


@pytest.mark.parametrize("make", [_clustered, _scattered, _ragged, _single],
                         ids=["clustered", "scattered", "ragged", "single"])
def test_hybrid_csr_order_is_the_inv_idx_gather(make):
    csr = make()
    a = generate.make_dense(csr.m, 32, seed=1)
    b = generate.make_dense(32, csr.n, seed=2)
    runner = HybridSDDMM.from_csr(csr, compute_dtype="float32",
                                  method="greedy")
    ops = runner.prepare_operands(a, b=b)
    flat = runner.run_padded(*ops, order="packed")
    got = np.asarray(runner.to_csr_order(flat))
    np.testing.assert_array_equal(
        got, np.asarray(flat)[runner.packed.inv_idx])
    np.testing.assert_array_equal(
        got, np.asarray(runner.run_padded(*ops, order="csr")))
    res = check_values(sddmm_reference(a, b, csr), got)
    assert res.passed, str(res)


@pytest.mark.parametrize("a_layout", ["rows", "panels"])
def test_hybrid_csr_order_each_a_layout(a_layout):
    csr = _clustered()
    a = generate.make_dense(csr.m, 32, seed=3)
    b = generate.make_dense(32, csr.n, seed=4)
    runner = HybridSDDMM(pack(csr, BSMR(0.3, 0.05, csr)),
                         compute_dtype="float32", a_layout=a_layout)
    got = np.asarray(runner(a, b=b, order="csr"))
    res = check_values(sddmm_reference(a, b, csr), got)
    assert res.passed, str(res)


@pytest.mark.parametrize("order", ["packed", "csr"])
def test_hybrid_looped_fn_runs_each_order(order):
    csr = generate.block_clustered(32, 32, block_prob=0.1,
                                   block_density=0.8,
                                   noise_density=0.002, seed=8)
    runner = HybridSDDMM.from_csr(csr)
    ops = runner.prepare_operands(generate.make_dense(csr.m, 32, seed=1),
                                  b=generate.make_dense(32, csr.n, seed=2))
    f = runner.make_looped_fn(3, order=order)
    assert np.isfinite(float(f(*ops)))


def test_csr_order_gradient_routes_to_the_entry_slots():
    """d sum(w * csr(flat)) / d flat puts w[i] at slot inv_idx[i] and
    zero on padding slots — the transpose of the gather."""
    csr = _clustered()
    runner = HybridSDDMM.from_csr(csr, compute_dtype="float32")
    flat = jnp.zeros(runner.packed.packed_size, jnp.float32)
    w = jnp.asarray(np.random.default_rng(0).standard_normal(csr.nnz),
                    jnp.float32)
    g = np.asarray(jax.grad(
        lambda f: jnp.sum(w * runner.to_csr_order(f)))(flat))
    want = np.zeros(runner.packed.packed_size, np.float32)
    want[runner.packed.inv_idx] = np.asarray(w)
    np.testing.assert_array_equal(g, want)


def test_light_pack_looped_csr_raises():
    csr = generate.block_clustered(10, 9, block_prob=0.35, seed=21)
    light = HybridSDDMM(pack(csr, BSMR(0.3, 0.1, csr), full_metadata=False))
    with pytest.raises(ValueError, match="light packing"):
        light.make_looped_fn(2, order="csr")


@pytest.mark.parametrize("flat_index", [True, False],
                         ids=["flat-take", "row-col-gather"])
def test_dense_csr_order(flat_index, monkeypatch):
    """DenseSDDMM delivers CSR order by one flat take, or by (row, col)
    pairs where a flat int32 index into the (M, N) product would
    overflow (forced here by lowering the limit)."""
    if not flat_index:
        monkeypatch.setattr(dense_mod, "FLAT_INDEX_LIMIT", 1)
    csr = generate.random_sparse(96, 160, density=0.2, seed=11)
    a = generate.make_dense(csr.m, 32, seed=1)
    b = generate.make_dense(32, csr.n, seed=2)
    runner = DenseSDDMM.from_csr(csr, compute_dtype="float32")
    flat_idx, rows_cols = runner._csr_gather_ops()
    assert (flat_idx is not None) == flat_index
    assert (rows_cols is not None) != flat_index
    got = np.asarray(runner(a, b=b, order="csr"))
    res = check_values(sddmm_reference(a, b, csr), got)
    assert res.passed, str(res)
    # the looped timing body compiles and runs the same gather
    ops = runner.prepare_operands(a, b=b)
    assert np.isfinite(float(runner.make_looped_fn(2, order="csr")(*ops)))


def test_dense_csr_order_needs_the_pattern():
    runner = DenseSDDMM(8, 8, compute_dtype="float32")
    a = generate.make_dense(8, 16, seed=1)
    b = generate.make_dense(16, 8, seed=2)
    assert np.asarray(runner(a, b=b, order="packed")).shape == (8, 8)
    with pytest.raises(ValueError, match="from_csr"):
        runner(a, b=b, order="csr")
