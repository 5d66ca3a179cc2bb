"""Device-side batched clustering (reorder/device_cluster.py): exact
agreement with the host multi-leader algorithm at matched (fp32)
precision, across regimes."""

import numpy as np
import pytest

from bsmr_sddmm.data import generate
from bsmr_sddmm.reorder.device_cluster import batched_cluster_device
from bsmr_sddmm.reorder.rows import (_batched_cluster, dispersion_scores,
                                    row_encodings)


def _prep(csr, col_block_size=16):
    block_ptr, block_idx, block_cnt, num_blocks = row_encodings(
        csr, col_block_size)
    disp = dispersion_scores(csr, block_ptr, block_cnt, col_block_size)
    nonempty = np.nonzero(disp > 0)[0]
    order = nonempty[np.argsort(disp[nonempty], kind="stable")]
    return order, block_ptr, block_idx, block_cnt, num_blocks


@pytest.mark.parametrize("gen", [
    lambda: generate.block_clustered(24, 24, block_prob=0.15,
                                     block_density=0.6,
                                     noise_density=1e-3, seed=51),
    lambda: generate.banded(512, 512, bandwidth=12, fill=0.6, seed=52),
    lambda: generate.powerlaw_graph(384, avg_degree=8, seed=53),
    lambda: generate.hypersparse_dense_mix(512, 512, density=2e-3,
                                           num_dense_rows=4,
                                           num_dense_cols=4, seed=54),
])
@pytest.mark.parametrize("alpha", [0.3, 0.5])
def test_device_matches_host_batched(gen, alpha):
    csr = gen()
    order, bp, bi, bc, nb = _prep(csr)
    host_cl, host_n = _batched_cluster(order, bp, bi, bc, nb, alpha,
                                       hat_dtype=np.float32)
    dev_cl, dev_n = batched_cluster_device(order, bp, bi, bc, nb, alpha,
                                           chunk=256)
    assert dev_n == host_n
    assert np.array_equal(dev_cl, host_cl)


def test_device_bail_matches_host():
    """The early-bail path (unclusterable rows become singletons) fires
    identically."""
    csr = generate.powerlaw_graph(2048, avg_degree=6, seed=55)
    order, bp, bi, bc, nb = _prep(csr)
    host_cl, host_n = _batched_cluster(order, bp, bi, bc, nb, 0.5,
                                       leaders_per_round=8, bail_after=3,
                                       bail_yield=4.0,
                                       hat_dtype=np.float32)
    dev_cl, dev_n = batched_cluster_device(order, bp, bi, bc, nb, 0.5,
                                           leaders_per_round=8,
                                           bail_after=3, bail_yield=4.0,
                                           chunk=512)
    assert dev_n == host_n
    assert np.array_equal(dev_cl, host_cl)


def test_device_empty_and_single():
    csr = generate.block_clustered(2, 2, block_prob=1.0, seed=56)
    order, bp, bi, bc, nb = _prep(csr)
    host_cl, host_n = _batched_cluster(order, bp, bi, bc, nb, 0.3,
                                       hat_dtype=np.float32)
    dev_cl, dev_n = batched_cluster_device(order, bp, bi, bc, nb, 0.3,
                                           chunk=64)
    assert dev_n == host_n
    assert np.array_equal(dev_cl, host_cl)
    dev_cl0, dev_n0 = batched_cluster_device(
        np.zeros(0, dtype=np.int64), bp, bi, bc, nb, 0.3)
    assert dev_n0 == 0 and np.all(dev_cl0 == -1)


def test_auto_routing_viability(monkeypatch):
    """method='auto' routes large matrices to the device path only when
    the backend is the GPU (or forced), within the dense-hat budget."""
    from bsmr_sddmm.reorder import rows

    # env kill-switch beats everything
    monkeypatch.setenv("BSMR_SDDMM_DEVICE_CLUSTER", "0")
    assert not rows._device_cluster_viable(200_000, 64)
    # forced on: only the memory budget gates
    monkeypatch.setenv("BSMR_SDDMM_DEVICE_CLUSTER", "1")
    assert rows._device_cluster_viable(200_000, 64)
    m_huge = (rows.DEVICE_CLUSTER_HAT_BUDGET // (4 * 64)) + 4096
    assert not rows._device_cluster_viable(m_huge, 64)
    # default: tests run on CPU, so auto stays host-side
    monkeypatch.delenv("BSMR_SDDMM_DEVICE_CLUSTER", raising=False)
    assert not rows._device_cluster_viable(200_000, 64)


def test_auto_routing_viability_names_the_gpu(monkeypatch):
    """Without the env switch, only a GPU backend — the device the
    route's cost was measured on — makes the device route viable."""
    import jax

    from bsmr_sddmm.reorder import rows

    monkeypatch.delenv("BSMR_SDDMM_DEVICE_CLUSTER", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert rows._device_cluster_viable(200_000, 64)
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    assert not rows._device_cluster_viable(200_000, 64)
