"""Round-5 pack layout levers: run-order gid sort, residual gid sort,
B-cost-scaled carve.

All three are pure layout/carve permutations — the packed-order
contract, inv_idx and every metadata array must follow whatever order
the lever chooses (validated by check_pack + a value-level golden
check), and the gid streams must actually have the promised order.
"""

import numpy as np
import pytest

from bsmr_sddmm.data import generate
from bsmr_sddmm.ops.hybrid import HybridSDDMM
from bsmr_sddmm.ops.reference import sddmm_reference
from bsmr_sddmm.reorder.autotune import from_params
from bsmr_sddmm.reorder.bsmr import BSMR
from bsmr_sddmm.reorder.pack import pack
from bsmr_sddmm.reorder.validate import check_pack
from bsmr_sddmm.utils.check import check_values


def _csr():
    return generate.block_clustered(48, 48, block_prob=0.08,
                                    block_density=0.6,
                                    noise_density=0.001, seed=7)


@pytest.mark.parametrize("sort_runs,sort_res,bscale", [
    ("gid", "csr", 1.0),
    ("cid", "gid", 1.0),
    ("gid", "gid", 2.0),
    ("cid", "csr", 3.0),
])
def test_levers_preserve_pack_contract(sort_runs, sort_res, bscale):
    csr = _csr()
    bsmr = BSMR(0.3, 0.05, csr)
    packed = pack(csr, bsmr, sort_runs=sort_runs, sort_res=sort_res,
                  b_cost_scale=bscale)
    check_pack(csr, bsmr, packed)
    a = generate.make_dense(csr.m, 32, seed=1)
    b = generate.make_dense(32, csr.n, seed=2)
    out = np.asarray(HybridSDDMM(packed)(a, b, order="csr"))
    res = check_values(sddmm_reference(a, b, csr), out)
    assert res.passed, res


def test_sort_runs_gid_orders_bucket_streams():
    csr = _csr()
    bsmr = BSMR(0.3, 0.05, csr)
    packed = pack(csr, bsmr, sort_runs="gid")
    # within every (family, bucket) segment, runs' first real gid must
    # be non-decreasing
    for gids, buckets in ((packed.super_gids, packed.super_buckets),
                          (packed.quad_gids, packed.quad_buckets),
                          (packed.pair_gids, packed.pair_buckets),
                          (packed.group_gids, packed.group_buckets)):
        for (b, start, n_runs) in buckets:
            seg = gids[start:start + n_runs * b].reshape(n_runs, -1)
            firsts = seg[:, 0]
            assert (np.diff(firsts) >= 0).all(), (b, start, firsts)


def test_sort_res_gid_orders_residual_stream():
    csr = _csr()
    bsmr = BSMR(0.3, 0.5, csr)   # high delta -> plenty of residual
    packed = pack(csr, bsmr, sort_res="gid")
    assert packed.nnz_res > 0
    assert (np.diff(packed.res_gids) >= 0).all()
    check_pack(csr, bsmr, packed)


def test_b_cost_scale_biases_toward_taller_containers():
    csr = _csr()
    bsmr = BSMR(0.3, 0.05, csr)
    base = pack(csr, bsmr, b_cost_scale=1.0)
    tall = pack(csr, bsmr, b_cost_scale=3.0)

    def mean_height(p):
        tiles = (p.num_super * 128 + p.num_quads * 64 + p.num_pairs * 32
                 + p.num_groups * 16)
        n = p.num_super + p.num_quads + p.num_pairs + p.num_groups
        return tiles / max(n, 1)

    assert mean_height(tall) >= mean_height(base)


def test_from_params_passthrough():
    csr = _csr()
    t = from_params(csr, 32, alpha=0.3, delta=0.05, sort_runs="gid",
                    sort_res="gid", b_cost_scale=2.0)
    assert (np.diff(t.packed.res_gids) >= 0).all()


def test_rowslab_moves_hot_residual_rows():
    csr = generate.powerlaw_graph(1024, avg_degree=12, seed=3)
    t = from_params(csr, 32, alpha=0.1, delta=0.05, hot_rows=64)
    pk = t.packed
    from bsmr_sddmm.reorder.validate import check_pack
    check_pack(csr, t.bsmr, pk)
    assert pk.rowslab_nrows == 64
    assert pk.rowslab_width == csr.n
    # slab + residual partition the pre-slab residual; hot rows gone
    # from the residual entirely
    hot = set(pk.rowslab_rows[pk.rowslab_rows < csr.m].tolist())
    assert not (set(pk.res_rows.tolist()) & hot)
    a = generate.make_dense(csr.m, 32, seed=1)
    b = generate.make_dense(32, csr.n, seed=2)
    out = np.asarray(HybridSDDMM(pk)(a, b, order="csr"))
    res = check_values(sddmm_reference(a, b, csr), out)
    assert res.passed, res


def test_rowslab_with_hub_and_grouping():
    csr = generate.powerlaw_graph(1024, avg_degree=12, seed=5)
    t = from_params(csr, 32, alpha=0.1, delta=0.05, group_size=2,
                    hub_cols=128, hot_rows=32)
    from bsmr_sddmm.reorder.validate import check_pack
    check_pack(csr, t.bsmr, t.packed)
    assert (t.packed.rowslab_rank >= 0).all()
    a = generate.make_dense(csr.m, 32, seed=1)
    b = generate.make_dense(32, csr.n, seed=2)
    runner = HybridSDDMM(t.packed)
    out = np.asarray(runner(a, b, order="csr"))
    res = check_values(sddmm_reference(a, b, csr), out)
    assert res.passed, res


def test_bad_sort_values_raise():
    csr = _csr()
    bsmr = BSMR(0.3, 0.05, csr)
    with pytest.raises(ValueError):
        pack(csr, bsmr, sort_runs="alphabetical")
    with pytest.raises(ValueError):
        pack(csr, bsmr, sort_res="random")
