"""Reordering pipeline: encodings, dispersion, clustering invariants,
column split invariants, packing invariants, and end-to-end hybrid
correctness vs the golden model."""

import numpy as np
import pytest

from bsmr_sddmm import config
from bsmr_sddmm.data import generate
from bsmr_sddmm.data.sparse import COO
from bsmr_sddmm.ops.hybrid import HybridSDDMM, sddmm_hybrid
from bsmr_sddmm.ops.reference import sddmm_reference
from bsmr_sddmm.reorder.bsmr import BSMR, original_matrix_block_stats
from bsmr_sddmm.reorder.pack import pack
from bsmr_sddmm.reorder.rows import (dispersion_scores, row_encodings,
                                    row_reordering)
from bsmr_sddmm.reorder import validate
from bsmr_sddmm.utils.check import check_values


def test_row_encodings_and_dispersion():
    # 2 rows, 64 cols, block size 16 -> 4 blocks
    coo = COO((2, 64), [0, 0, 0, 1], [0, 1, 40, 17], np.ones(4))
    csr = coo.to_csr()
    block_ptr, block_idx, block_cnt, nb = row_encodings(csr, 16)
    assert nb == 4
    # row 0: block 0 count 2, block 2 count 1; row 1: block 1 count 1
    assert np.array_equal(block_ptr, [0, 2, 3])
    assert np.array_equal(block_idx, [0, 2, 1])
    assert np.array_equal(block_cnt, [2, 1, 1])
    disp = dispersion_scores(csr, block_ptr, block_cnt, 16)
    # row0: (16-2)+(16-1) + 3*2 = 35 ; row1: (16-1) + 1*1 = 16
    assert disp[0] == 35 and disp[1] == 16


@pytest.mark.parametrize("method", ["greedy", "batched", "none"])
def test_row_reordering_invariants(clustered_csr, method):
    rr = row_reordering(clustered_csr, alpha=0.3, method=method)
    nonempty = np.nonzero(clustered_csr.row_nnz() > 0)[0]
    assert np.array_equal(np.sort(rr.reordered_rows), nonempty)
    assert rr.num_clusters >= 1
    # cluster ids of kept rows are contiguous groups in the output order
    cl = rr.cluster_ids[rr.reordered_rows]
    assert np.all(np.diff(cl) >= 0)


def test_greedy_clusters_similar_rows():
    # Two groups of identical rows -> exactly 2 clusters.
    rows, cols = [], []
    for r in range(8):
        base = 0 if r < 4 else 64
        for c in range(8):
            rows.append(r)
            cols.append(base + c)
    csr = COO((8, 128), rows, cols, np.ones(len(rows))).to_csr()
    rr = row_reordering(csr, alpha=0.5, method="greedy", col_block_size=16)
    assert rr.num_clusters == 2
    first_half = set(rr.reordered_rows[:4].tolist())
    assert first_half in ({0, 1, 2, 3}, {4, 5, 6, 7})


def test_alpha_monotonicity(clustered_csr):
    # Higher alpha -> stricter merging -> at least as many clusters.
    n_low = row_reordering(clustered_csr, 0.1, method="greedy").num_clusters
    n_high = row_reordering(clustered_csr, 0.9, method="greedy").num_clusters
    assert n_high >= n_low


@pytest.mark.parametrize("delta", [0.0, 0.3, 0.7, 1.1])
def test_bsmr_invariants(clustered_csr, delta):
    bsmr = BSMR(0.3, delta, clustered_csr, method="greedy")
    validate.check_row_reordering(clustered_csr, bsmr)
    validate.check_col_reordering(clustered_csr, bsmr)
    packed = pack(clustered_csr, bsmr)
    validate.check_pack(clustered_csr, bsmr, packed)
    if delta > 1.0:
        assert packed.num_blocks == 0  # threshold > max possible density
    # data split accounting
    assert packed.nnz_dense + packed.nnz_res == clustered_csr.nnz


def test_delta_zero_means_all_dense(clustered_csr):
    bsmr = BSMR(0.3, 0.0, clustered_csr, method="greedy")
    packed = pack(clustered_csr, bsmr)
    assert packed.nnz_res == 0
    assert packed.nnz_dense == clustered_csr.nnz


def test_reordering_improves_density(clustered_csr):
    """BSMR's whole point: after reordering, more nnz land in dense blocks
    than in the original row order."""
    bsmr = BSMR(0.3, 0.3, clustered_csr, method="greedy")
    packed = pack(clustered_csr, bsmr)
    orig_blocks, orig_density = original_matrix_block_stats(
        clustered_csr, 0.3)
    orig_dense_nnz = orig_blocks * config.BLOCK_SIZE * orig_density
    assert packed.nnz_dense >= orig_dense_nnz


@pytest.mark.parametrize("method", ["greedy", "batched"])
def test_hybrid_matches_reference(clustered_csr, method):
    k = 32
    a = generate.make_dense(clustered_csr.m, k, seed=1)
    b = generate.make_dense(k, clustered_csr.n, seed=2)
    runner = HybridSDDMM.from_csr(clustered_csr, 0.3, 0.3, method=method)
    got = np.asarray(runner(a, b))
    want = sddmm_reference(a, b, clustered_csr)
    res = check_values(want, got)
    assert res.passed, str(res)


def test_hybrid_random_matrix(small_random_csr):
    k = 16
    a = generate.make_dense(small_random_csr.m, k, seed=3)
    b = generate.make_dense(k, small_random_csr.n, seed=4)
    bsmr = BSMR(0.3, 0.3, small_random_csr, method="greedy")
    packed = pack(small_random_csr, bsmr)
    got = sddmm_hybrid(a, b, packed)
    want = sddmm_reference(a, b, small_random_csr)
    res = check_values(want, got)
    assert res.passed, str(res)


def test_hybrid_packed_order_roundtrip(clustered_csr):
    """Packed-order output gathered through inv_idx equals CSR order, and
    the jitted conversion agrees."""
    k = 32
    a = generate.make_dense(clustered_csr.m, k, seed=1)
    b = generate.make_dense(k, clustered_csr.n, seed=2)
    runner = HybridSDDMM.from_csr(clustered_csr, 0.3, 0.3)
    a_pad, bt_pad = runner.prepare_operands(a, b=b)
    flat = np.asarray(runner.run_padded(a_pad, bt_pad, order="packed"))
    csr_vals = np.asarray(runner.run_padded(a_pad, bt_pad, order="csr"))
    np.testing.assert_array_equal(flat[runner.packed.inv_idx], csr_vals)
    from bsmr_sddmm.ops.hybrid import _to_csr_order_jit
    import jax.numpy as jnp
    np.testing.assert_array_equal(
        np.asarray(_to_csr_order_jit(jnp.asarray(flat), runner._inv_idx)),
        csr_vals)
    # packed metadata: real slots carry the right (row, col)
    pm = runner.packed
    rows_of = clustered_csr.row_indices()
    assert np.array_equal(pm.packed_rows[pm.inv_idx], rows_of)
    assert np.array_equal(pm.packed_cols[pm.inv_idx], clustered_csr.col_idx)
    # padding slots carry sentinels
    mask = np.ones(pm.packed_size, dtype=bool)
    mask[pm.inv_idx] = False
    assert np.all(pm.packed_rows[mask] == clustered_csr.m)
    assert np.all(pm.packed_cols[mask] == clustered_csr.n)


def test_hybrid_bf16_path(clustered_csr):
    k = 32
    a = generate.make_dense(clustered_csr.m, k, seed=1)
    b = generate.make_dense(k, clustered_csr.n, seed=2)
    runner = HybridSDDMM.from_csr(clustered_csr, 0.3, 0.3,
                                  compute_dtype="bfloat16")
    got = np.asarray(runner(a, b))
    want = sddmm_reference(a, b, clustered_csr)
    # bf16 inputs: loose tolerance (~8-bit mantissa)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert np.median(rel) < 0.02
    assert np.max(rel) < 0.2


def test_hybrid_empty_rows_and_panels():
    # Matrix with empty rows and a panel-misaligned row count.
    coo = COO((37, 50), [0, 5, 5, 36], [1, 2, 3, 49], np.ones(4))
    csr = coo.to_csr()
    a = generate.make_dense(37, 8, seed=0)
    b = generate.make_dense(8, 50, seed=1)
    runner = HybridSDDMM.from_csr(csr, 0.3, 0.3, method="greedy")
    got = np.asarray(runner(a, b))
    want = sddmm_reference(a, b, csr)
    res = check_values(want, got)
    assert res.passed, str(res)


def test_calibration_load_and_script(tmp_path):
    """calibrate.py --quick produces a JSON the autotuner can load."""
    import json
    import runpy
    import subprocess
    import sys

    from bsmr_sddmm.reorder import autotune

    out = tmp_path / "cal.json"
    r = subprocess.run(
        [sys.executable, "scripts/calibrate.py", "--quick", "--cpu", "-o",
         str(out)], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    cal = json.loads(out.read_text())
    assert cal["stream_gbps"] > 0
    assert set(cal["row_rate_8mb"]) == {"128", "256", "512", "1024",
                                        "2048"}
    old_stream = autotune.STREAM_GBPS
    old_rates = dict(autotune._ROW_RATE_8MB)
    old_dots = dict(autotune._DOT_G16_MS)
    try:
        autotune.load_calibration(cal)
        assert autotune.STREAM_GBPS == cal["stream_gbps"]
        assert autotune._ROW_RATE_8MB[512] == cal["row_rate_8mb"]["512"]
        # the split modes are priced from the bf16 rate (2 and 3 passes)
        assert autotune._DOT_G16_MS[("mixed", 16)] == \
            autotune._DOT_G16_MS[("bfloat16", 16)] / 2.0
        assert autotune._DOT_G16_MS[("float16", 16)] == \
            autotune._DOT_G16_MS[("bfloat16", 16)] / 3.0
    finally:
        autotune.STREAM_GBPS = old_stream
        autotune._ROW_RATE_8MB.update(old_rates)
        autotune._DOT_G16_MS.update(old_dots)


def test_bucket_merge_ratio_bounded():
    """Exact-first bucket merging must not pad small containers into a
    vastly larger bucket (review finding: a lone 128-chunk container
    must not swallow 1-chunk neighbors)."""
    from bsmr_sddmm.reorder.bsmr import BSMR
    from bsmr_sddmm.reorder.pack import pack

    # one very wide dense row-panel + several narrow ones
    rng = np.random.default_rng(5)
    rows_l, cols_l = [], []
    for r in range(16):                      # panel 0: dense 4096 cols
        cols = np.arange(0, 4096)
        rows_l.append(np.full(len(cols), r)); cols_l.append(cols)
    for p in range(1, 6):                    # panels 1-5: 64 cols each
        for r in range(16):
            cols = np.arange(p * 64, p * 64 + 64)
            rows_l.append(np.full(len(cols), p * 16 + r))
            cols_l.append(cols)
    from bsmr_sddmm.data.sparse import COO
    rows = np.concatenate(rows_l); cols = np.concatenate(cols_l)
    csr = COO((96, 4096), rows, cols,
              np.ones(len(rows), np.float32)).to_csr()
    packed = pack(csr, BSMR(0.3, 0.0, csr, method="none"))
    # padding must stay bounded: < 3x the real cells
    real_cells = csr.nnz - packed.nnz_res
    total_cells = packed.packed_size - packed.nnz_res
    assert total_cells < 3 * real_cells, (total_cells, real_cells)


def test_light_pack_skips_metadata_and_raises_on_csr_use():
    from bsmr_sddmm.data import generate
    from bsmr_sddmm.data.generate import make_dense
    from bsmr_sddmm.ops.hybrid import HybridSDDMM
    from bsmr_sddmm.reorder.bsmr import BSMR
    from bsmr_sddmm.reorder.pack import pack
    csr = generate.block_clustered(10, 9, block_prob=0.35, seed=21)
    light = pack(csr, BSMR(0.3, 0.1, csr), full_metadata=False)
    full = pack(csr, BSMR(0.3, 0.1, csr))
    assert light.packed_rows is None and light.csr_dest is None
    assert light.super_csr is None or light.num_super == 0
    # layout identical to the full pack
    assert light.packed_size == full.packed_size
    np.testing.assert_array_equal(light.inv_idx, full.inv_idx)
    np.testing.assert_array_equal(light.group_gids, full.group_gids)
    r = HybridSDDMM(light, compute_dtype="float32")
    a = make_dense(csr.m, 32, seed=1)
    b = make_dense(32, csr.n, seed=2)
    ops = r.prepare_operands(a, b=b)
    packed_out = np.asarray(r.run_padded(*ops, order="packed"))
    full_out = np.asarray(HybridSDDMM(full, compute_dtype="float32")
                          .run_padded(*ops, order="packed"))
    np.testing.assert_allclose(packed_out, full_out)
    with pytest.raises(ValueError):
        r.run_padded(*ops, order="csr")
    with pytest.raises(ValueError):
        _ = r.packed_rows


def test_route_by_cost(monkeypatch):
    # cost-based clustering routing: cheap sample -> host greedy
    # regardless of row count; expensive sample -> the accelerator path
    # (or multi-leader host when no device is viable).
    from bsmr_sddmm.reorder import rows as rows_mod

    # fast sample on a big matrix: extrapolated host time under budget
    assert rows_mod._route_by_cost(1e-5, 500_000, 500_000, 4096) == \
        "greedy"
    # slow sample, device model cheaper than host estimate -> device
    # (512 blocks: est_device ~11 s < est_host ~318 s native)
    monkeypatch.setattr(rows_mod, "_device_cluster_viable",
                        lambda m, b: True)
    assert rows_mod._route_by_cost(0.5, 200_000, 200_000, 512) == \
        "device"
    # device model MORE expensive than host (16384 blocks: ~362 s) ->
    # stay on native greedy even over budget
    assert rows_mod._route_by_cost(0.5, 200_000, 200_000, 16384) == \
        "greedy"
    # no native, no device -> the numpy multi-leader fallback
    monkeypatch.setattr(rows_mod, "_device_cluster_viable",
                        lambda m, b: False)
    monkeypatch.setattr("bsmr_sddmm.native.available", lambda: False)
    assert rows_mod._route_by_cost(0.5, 200_000, 200_000, 4096) == \
        "batched"
    # env override widens the budget back to host greedy
    monkeypatch.setenv("BSMR_SDDMM_HOST_CLUSTER_BUDGET_S", "1e9")
    assert rows_mod._route_by_cost(0.5, 200_000, 200_000, 4096) == \
        "greedy"
