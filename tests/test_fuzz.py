"""Property/fuzz tests: random matrices x random configurations, every
packing invariant checked and every result compared to the golden model.

This is the safety net the reference lacks entirely (SURVEY.md §4): its
VALIDATE path only runs hand-picked inputs.  Seeds are fixed so failures
reproduce.
"""

import numpy as np
import pytest

from bsmr_sddmm.data import generate
from bsmr_sddmm.ops.hybrid import HybridSDDMM
from bsmr_sddmm.ops.reference import sddmm_reference
from bsmr_sddmm.reorder.bsmr import BSMR
from bsmr_sddmm.reorder.pack import pack
from bsmr_sddmm.reorder.validate import (check_col_reordering, check_pack,
                                        check_row_reordering)
from bsmr_sddmm.utils.check import check_values


def _random_matrix(rng):
    kind = rng.integers(0, 4)
    if kind == 0:
        return generate.random_sparse(
            int(rng.integers(17, 200)), int(rng.integers(17, 160)),
            float(rng.uniform(0.01, 0.3)), seed=int(rng.integers(1e6)))
    if kind == 1:
        return generate.block_clustered(
            int(rng.integers(2, 10)), int(rng.integers(2, 8)),
            block_prob=float(rng.uniform(0.05, 0.4)),
            block_density=float(rng.uniform(0.2, 0.9)),
            noise_density=float(rng.uniform(0, 0.02)),
            seed=int(rng.integers(1e6)))
    if kind == 2:
        return generate.banded(
            int(rng.integers(32, 200)), int(rng.integers(32, 200)),
            bandwidth=int(rng.integers(2, 20)),
            fill=float(rng.uniform(0.2, 0.9)), seed=int(rng.integers(1e6)))
    return generate.powerlaw_graph(
        int(rng.integers(64, 300)), avg_degree=int(rng.integers(2, 12)),
        seed=int(rng.integers(1e6)))


@pytest.mark.parametrize("trial", range(12))
def test_fuzz_pipeline_invariants_and_values(trial):
    rng = np.random.default_rng(1000 + trial)
    csr = _random_matrix(rng)
    if csr.nnz == 0:
        return
    alpha = float(rng.choice([0.1, 0.3, 0.6]))
    delta = float(rng.choice([0.0, 0.1, 0.3, 0.8, 1.1]))
    g = int(rng.choice([1, 2, 4]))
    cluster_cols = bool(rng.integers(0, 2)) or g > 1
    k = int(rng.choice([8, 32, 48]))
    k_chunks = int(rng.choice([1, 2]))
    while k % k_chunks:
        k_chunks //= 2
    merge = bool(rng.integers(0, 2))
    pair = bool(rng.integers(0, 2))
    absorb = bool(rng.integers(0, 2))
    window_dp = bool(rng.integers(0, 2))

    bsmr = BSMR(alpha, delta, csr, group_size=g, cluster_cols=cluster_cols)
    check_row_reordering(csr, bsmr)
    check_col_reordering(csr, bsmr)
    packed = pack(csr, bsmr, merge_superpanels=merge, pair_panels=pair,
                  absorb_residual=absorb, window_dp=window_dp)
    check_pack(csr, bsmr, packed)

    a = generate.make_dense(csr.m, k, seed=trial)
    b = generate.make_dense(k, csr.n, seed=trial + 1)
    runner = HybridSDDMM(packed, compute_dtype="float32",
                         k_chunks=k_chunks)
    got = np.asarray(runner(a, b, order="csr"))
    want = sddmm_reference(a, b, csr)
    res = check_values(want, got)
    assert res.passed, (
        f"trial={trial} alpha={alpha} delta={delta} G={g} C={k_chunks} "
        f"merge={merge} pair={pair} absorb={absorb} dp={window_dp} "
        f"k={k}: {res}")


def test_fuzz_autotune_strategy_dispatch():
    """Random densities across the dense/hybrid boundary: whatever
    strategy the autotuner picks must deliver checkData-tolerance
    results through its own runner class."""
    from bsmr_sddmm.ops.dense import DenseSDDMM
    from bsmr_sddmm.reorder.autotune import autotune

    rng = np.random.default_rng(99)
    for _ in range(6):
        m = int(rng.integers(48, 160))
        n = int(rng.integers(48, 160))
        density = float(rng.uniform(0.005, 0.45))
        csr = generate.random_sparse(m, n, density,
                                     seed=int(rng.integers(1e6)))
        if csr.nnz == 0:
            continue
        k = int(rng.choice([16, 32, 64]))
        tuned = autotune(csr, k=k, alphas=(0.3,), deltas=(0.0, 0.3),
                         merges=(False,))
        a = generate.make_dense(csr.m, k, seed=1)
        b = generate.make_dense(k, csr.n, seed=2)
        if tuned.dense:
            runner = DenseSDDMM.from_csr(csr, compute_dtype="float32")
        else:
            runner = HybridSDDMM(tuned.packed, compute_dtype="float32",
                                 k_chunks=tuned.k_chunks)
        got = np.asarray(runner(a, b, order="csr"))
        res = check_values(sddmm_reference(a, b, csr), got)
        assert res.passed, (m, n, density, k, tuned.dense, str(res))
