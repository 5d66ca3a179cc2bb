"""Dense hub-column slab (reorder/pack.py "Dense hub slab"): correctness
against the golden SDDMM, structural invariants, autotune candidate
generation, and the explicit-config builder."""

import numpy as np
import pytest

from bsmr_sddmm.data import generate
from bsmr_sddmm.ops.hybrid import HybridSDDMM
from bsmr_sddmm.ops.reference import sddmm_reference
from bsmr_sddmm.reorder.autotune import from_params, hub_candidates
from bsmr_sddmm.reorder.bsmr import BSMR
from bsmr_sddmm.reorder.cols import cluster_columns, hub_first_rank
from bsmr_sddmm.reorder.pack import pack
from bsmr_sddmm.reorder.validate import (check_col_reordering, check_pack)
from bsmr_sddmm.utils.check import check_values


def _powerlawish(seed=3):
    return generate.powerlaw_graph(512, avg_degree=12, seed=seed)


def _run(csr, bsmr, k=32, compute_dtype="float32", order="csr"):
    packed = pack(csr, bsmr, k_hint=k, compute_dtype=compute_dtype)
    check_pack(csr, bsmr, packed)
    a = generate.make_dense(csr.m, k, seed=1)
    b = generate.make_dense(k, csr.n, seed=2)
    runner = HybridSDDMM(packed, compute_dtype=compute_dtype)
    got = np.asarray(runner(a, b, order=order))
    want = sddmm_reference(a, b, csr)
    res = check_values(want, got)
    assert res.passed, res
    return packed


def test_hub_first_rank_degrees_lead():
    csr = _powerlawish()
    rank = hub_first_rank(csr, 128)
    deg = np.bincount(csr.col_idx, minlength=csr.n)
    order = np.argsort(rank)
    hub_degs = deg[order[:128]]
    rest_degs = deg[order[128:]]
    assert np.all(np.diff(hub_degs) <= 0), "hubs not degree-descending"
    if len(rest_degs):
        assert hub_degs.min() >= rest_degs.max(), \
            "a non-hub column out-degrees a hub column"
    assert np.array_equal(np.sort(order), np.arange(csr.n))


@pytest.mark.parametrize("hub", [128, 256])
def test_hub_slab_correctness_g1(hub):
    csr = _powerlawish()
    bsmr = BSMR(0.3, 0.05, csr, hub_cols=hub)
    packed = _run(csr, bsmr)
    assert packed.hub_cols == hub
    assert packed.nnz_hub > 0
    # no residual/tile entry has a hub-ranked column
    rank = bsmr.col_rank
    assert np.all(rank[packed.res_cols] >= hub)
    check_col_reordering(csr, bsmr)


def test_hub_slab_correctness_grouped():
    csr = _powerlawish(seed=4)
    order = cluster_columns(csr, 0.3)
    rank = hub_first_rank(csr, 128, base_order=order)
    bsmr = BSMR(0.3, 0.05, csr, group_size=2, col_rank=rank, hub_cols=128)
    packed = _run(csr, bsmr, k=32)
    assert packed.hub_cols == 128
    assert packed.group_size == 2


def test_hub_all_columns_full_dense():
    """H = n covers every column: no tiles, no residual, pure slab."""
    csr = generate.random_sparse(96, 128, density=0.05, seed=5)
    bsmr = BSMR(0.3, 0.3, csr, hub_cols=128)
    packed = _run(csr, bsmr, k=16)
    assert packed.nnz_hub == csr.nnz
    assert packed.nnz_res == 0
    assert packed.num_super + packed.num_quads + packed.num_pairs \
        + packed.num_groups == 0


def test_hub_packed_order_layout():
    """Slab values sit between the tile families and the residual in the
    packed flat vector, at slot row*H + rank."""
    csr = _powerlawish(seed=6)
    bsmr = BSMR(0.3, 0.05, csr, hub_cols=128)
    packed = pack(csr, bsmr, compute_dtype="float32")
    H = packed.hub_cols
    dense_cells = packed.packed_size - packed.m * H - packed.nnz_res
    slot = dense_cells + packed.hub_rows * H + packed.hub_rank
    assert np.array_equal(packed.inv_idx[packed.hub_csr], slot)


def test_hub_candidates_powerlaw_nonempty():
    # strong hubs: star-ish graph
    csr = generate.powerlaw_graph(4096, avg_degree=32, seed=7)
    cands = hub_candidates(csr, 128)
    assert all(h % 128 == 0 and h > 0 for h in cands)


def test_hub_candidates_low_degree_empty():
    """Uniform low-degree matrices have no column worth a slab lane."""
    csr = generate.random_sparse(8192, 8192, density=4e-4, seed=8)
    assert hub_candidates(csr, 128) == []


def test_from_params_hub():
    csr = _powerlawish(seed=9)
    tuned = from_params(csr, 32, alpha=0.3, delta=0.05, hub_cols=128,
                        compute_dtype="float32")
    assert tuned.hub_cols == 128
    assert tuned.packed.hub_cols == 128
    a = generate.make_dense(csr.m, 32, seed=1)
    b = generate.make_dense(32, csr.n, seed=2)
    runner = HybridSDDMM(tuned.packed, compute_dtype="float32")
    res = check_values(sddmm_reference(a, b, csr),
                       np.asarray(runner(a, b)))
    assert res.passed, res
