"""a_layout="panels": panel-major A relayout vs the row-gather path.

The panels layout must deliver bit-comparable values at every real CSR
entry for any packing (grouped, K-chunked, hub slab, residual, short
last panel) — the non-entry packed slots may legitimately differ
(neighbour-panel garbage instead of zeros; see ops/hybrid.py).
"""

import numpy as np
import pytest

from bsmr_sddmm.data import generate
from bsmr_sddmm.data.generate import make_dense
from bsmr_sddmm.ops.hybrid import HybridSDDMM
from bsmr_sddmm.ops.reference import sddmm_reference
from bsmr_sddmm.reorder.bsmr import BSMR
from bsmr_sddmm.reorder.pack import pack


def _golden_check(csr, k, bsmr, k_chunks=1):
    p = pack(csr, bsmr)
    a = make_dense(csr.m, k, seed=1)
    b = make_dense(k, csr.n, seed=2)
    golden = sddmm_reference(a, b, csr)
    outs = {}
    for a_layout in ("rows", "panels"):
        r = HybridSDDMM(p, compute_dtype="float32", k_chunks=k_chunks,
                        a_layout=a_layout)
        ops = r.prepare_operands(a, b=b)
        out = np.asarray(r.run_padded(*ops, order="csr"))
        err = np.max(np.abs(out - golden) / (np.abs(golden) + 1e-6))
        assert err < 1e-4, (a_layout, err)
        outs[a_layout] = out
    # identical entry values between layouts (same dots, same order)
    np.testing.assert_allclose(outs["rows"], outs["panels"], rtol=1e-6)
    return p


@pytest.mark.parametrize("k_chunks", [1, 2])
def test_panels_blocks(k_chunks):
    csr = generate.block_clustered(20, 18, block_prob=0.3, seed=5)
    _golden_check(csr, 64, BSMR(0.3, 0.1, csr), k_chunks=k_chunks)


def test_panels_grouped():
    csr = generate.block_clustered(20, 18, block_prob=0.3, seed=5)
    _golden_check(csr, 64, BSMR(0.3, 0.1, csr, group_size=4,
                                cluster_cols=True))


def test_panels_powerlaw_residual_and_hub():
    csr = generate.powerlaw_graph(800, 8.0, seed=7)
    p = _golden_check(csr, 32, BSMR(0.3, 0.1, csr, hub_cols=16))
    assert p.nnz_hub > 0 and p.nnz_res > 0


def test_panels_short_last_panel():
    # m % 16 != 0 and a trailing container shorter than its family
    # height: rows past the member panels read neighbour panels whose
    # slots hold no entries.
    csr = generate.banded(777, 640, 40, seed=9)
    _golden_check(csr, 128, BSMR(0.3, 0.1, csr))


def test_panels_requires_prepared_operands():
    csr = generate.block_clustered(8, 8, block_prob=0.4, seed=3)
    p = pack(csr, BSMR(0.3, 0.1, csr))
    r = HybridSDDMM(p, compute_dtype="float32", a_layout="panels")
    a = make_dense(csr.m, 32, seed=1)
    b = make_dense(32, csr.n, seed=2)
    a_pad = np.concatenate([a, np.zeros((1, 32), np.float32)])
    bt_pad = np.concatenate([b.T, np.zeros((1, 32), np.float32)])
    with pytest.raises(ValueError):
        r.run_padded(a_pad, bt_pad)


def test_rows_runner_accepts_panels_operands():
    # a rows-layout runner must ignore (not crash on) the panel relayout
    # in panels-prepared operands
    csr = generate.block_clustered(10, 9, block_prob=0.35, seed=13)
    p = pack(csr, BSMR(0.3, 0.1, csr))
    a = make_dense(csr.m, 32, seed=1)
    b = make_dense(32, csr.n, seed=2)
    ops = HybridSDDMM(p, compute_dtype="float32",
                      a_layout="panels").prepare_operands(a, b=b)
    rows_runner = HybridSDDMM(p, compute_dtype="float32")
    out = np.asarray(rows_runner.run_padded(*ops, order="csr"))
    golden = sddmm_reference(a, b, csr)
    np.testing.assert_allclose(out, golden, rtol=1e-4)


def test_panels_device_prepare_matches():
    import jax.numpy as jnp
    csr = generate.block_clustered(12, 10, block_prob=0.35, seed=11)
    p = pack(csr, BSMR(0.3, 0.1, csr))
    a = make_dense(csr.m, 32, seed=1)
    b = make_dense(32, csr.n, seed=2)
    r = HybridSDDMM(p, compute_dtype="float32", a_layout="panels")
    host_ops = r.prepare_operands(a, b=b)
    a_pad = jnp.asarray(np.concatenate(
        [a, np.zeros((1, 32), np.float32)]))
    bt_pad = jnp.asarray(np.concatenate(
        [b.T.copy(), np.zeros((1, 32), np.float32)]))
    dev_ops = r.device_prepare(a_pad, bt_pad)
    out_h = np.asarray(r.run_padded(*host_ops, order="csr"))
    out_d = np.asarray(r.run_padded(*dev_ops, order="csr"))
    np.testing.assert_allclose(out_h, out_d, rtol=1e-6)
