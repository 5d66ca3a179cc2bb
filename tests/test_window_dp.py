"""Cross-window DP tile carve (reorder/pack.py window_dp=True, round 3).

The DP relaxes the reference's fixed 8-panel window blocking
(src/BSMR.cpp:83-265, a GPU-grid constraint) and may form containers
spanning any consecutive panels.  These tests pin down:

- the DP solution never models worse than the per-window carve (it
  optimizes over a strict superset of partitions under the same cost),
- containers really do cross old window boundaries when structure
  rewards it,
- the distributed shard plan handles window-straddling containers
  (the unit partition must never split one).
"""

import numpy as np

from bsmr_sddmm.data import generate
from bsmr_sddmm.ops.hybrid import HybridSDDMM
from bsmr_sddmm.ops.reference import sddmm_reference
from bsmr_sddmm.reorder.bsmr import BSMR
from bsmr_sddmm.reorder.pack import pack
from bsmr_sddmm.reorder.validate import check_pack
from bsmr_sddmm.utils.check import check_values


def _dense_rowblock():
    """12 identical-column panels -> one container would ideally span
    all of them, which no 8-aligned carve can do."""
    m, n = 12 * 16, 256
    rows = np.repeat(np.arange(m), 96)
    cols = np.tile(np.arange(96), m)
    vals = np.ones(len(rows), dtype=np.float32)
    from bsmr_sddmm.data.sparse import COO
    return COO((m, n), rows.astype(np.int64), cols.astype(np.int64),
               vals).to_csr()


def test_dp_cost_never_worse_than_windowed():
    for gen, al, dl in (
            (lambda: generate.block_clustered(64, 64, block_prob=0.05,
                                              block_density=0.6,
                                              noise_density=1e-4,
                                              seed=11), 0.3, 0.05),
            (lambda: generate.banded(2048, 2048, bandwidth=30, fill=0.5,
                                     seed=12), 0.3, 0.0),
            (lambda: generate.powerlaw_graph(2048, avg_degree=12,
                                             seed=13), 0.1, 0.05)):
        csr = gen()
        bsmr = BSMR(al, dl, csr)
        win = pack(csr, bsmr, window_dp=False)
        dp = pack(csr, bsmr, window_dp=True)
        # the carve's own objective: the DP searches a superset of the
        # windowed partitions under the same cost, so it is never worse
        assert dp.carve_cost_ns > 0
        assert dp.carve_cost_ns <= win.carve_cost_ns * (1 + 1e-12), \
            (dp.carve_cost_ns, win.carve_cost_ns)
        # and both carves cover the same dense blocks
        check_pack(csr, bsmr, win)
        check_pack(csr, bsmr, dp)


def test_dp_containers_cross_window_boundaries():
    csr = _dense_rowblock()
    bsmr = BSMR(0.3, 0.0, csr, method="none")
    packed = pack(csr, bsmr, window_dp=True)
    check_pack(csr, bsmr, packed)
    off = packed.cont_panel_off
    ids = packed.cont_panel_ids
    spans_boundary = any(
        ids[off[c]] // 8 != ids[off[c + 1] - 1] // 8
        for c in range(len(off) - 1))
    assert spans_boundary, "expected a container straddling a window"
    # windowed carve on the same input strands the tail panels
    win = pack(csr, bsmr, window_dp=False)
    assert packed.packed_size <= win.packed_size


def test_dp_unaligned_container_distributed_correct():
    """The shard plan's unit partition must keep window-straddling
    containers whole (the round-3 dist.py regression)."""
    import jax

    if jax.device_count() < 8:
        return
    from bsmr_sddmm.parallel.dist import DistributedHybridSDDMM
    from bsmr_sddmm.parallel.mesh import make_mesh

    csr = _dense_rowblock()
    bsmr = BSMR(0.3, 0.0, csr, method="none")
    packed = pack(csr, bsmr, window_dp=True)
    mesh = make_mesh((8, 1), ("rows", "feat"))
    dist = DistributedHybridSDDMM(packed, mesh)
    k = 16
    a = generate.make_dense(csr.m, k, seed=1)
    b = generate.make_dense(k, csr.n, seed=2)
    got = np.asarray(dist(a, b))
    want = sddmm_reference(a, b, csr)
    res = check_values(want, got)
    assert res.passed, res
    # single-chip agreement on the same packing
    runner = HybridSDDMM(packed, compute_dtype="float32")
    got1 = np.asarray(runner(a, b, order="csr"))
    np.testing.assert_allclose(got, got1, rtol=2e-5, atol=2e-5)
