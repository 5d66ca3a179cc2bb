"""Model families: factorization training and graph attention."""

import jax
import numpy as np

from bsmr_sddmm.data import generate
from bsmr_sddmm.models.factorization import SparseFactorizationModel
from bsmr_sddmm.models.graph_attention import (GraphAttentionLayer,
                                              segment_softmax)


def test_factorization_training_reduces_loss():
    csr = generate.block_clustered(8, 8, block_prob=0.3, seed=21)
    model = SparseFactorizationModel.from_csr(csr, k=16, learning_rate=0.05)
    _, losses = model.fit(csr.values, steps=60)
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    assert np.isfinite(losses).all()


def test_segment_softmax_matches_dense():
    rows = np.array([0, 0, 0, 1, 1, 3], dtype=np.int32)
    scores = np.array([1.0, 2.0, 3.0, -1.0, 1.0, 0.5], dtype=np.float32)
    got = np.asarray(segment_softmax(
        jax.numpy.asarray(scores), jax.numpy.asarray(rows), 4))
    # per-row softmax
    for r in np.unique(rows):
        seg = scores[rows == r]
        want = np.exp(seg - seg.max())
        want /= want.sum()
        np.testing.assert_allclose(got[rows == r], want, rtol=1e-5)
    # rows sum to 1
    sums = np.zeros(4)
    np.add.at(sums, rows, got)
    np.testing.assert_allclose(sums[[0, 1, 3]], 1.0, rtol=1e-5)


def test_graph_attention_forward():
    adj = generate.powerlaw_graph(200, avg_degree=6, seed=8)
    layer = GraphAttentionLayer(adj, feature_dim=16, head_dim=8)
    params = layer.init(jax.random.PRNGKey(1))
    x = jax.numpy.asarray(generate.make_dense(adj.m, 16, seed=2))
    out = np.asarray(layer(params, x))
    assert out.shape == (adj.m, 8)
    assert np.isfinite(out).all()
    # attention output of a node is a convex combination of neighbor V rows:
    # rows with no out-edges aggregate to zero.
    empty = np.nonzero(adj.row_nnz() == 0)[0]
    if len(empty):
        np.testing.assert_allclose(out[empty], 0.0, atol=1e-6)


def test_graph_attention_matches_dense_attention():
    """On a fully-connected tiny graph the sparse attention must equal
    dense softmax attention."""
    from bsmr_sddmm.data.sparse import COO
    n = 12
    rows, cols = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    adj = COO((n, n), rows.ravel(), cols.ravel(),
              np.ones(n * n)).to_csr()
    layer = GraphAttentionLayer(adj, feature_dim=8, head_dim=4)
    params = layer.init(jax.random.PRNGKey(3))
    x = jax.numpy.asarray(generate.make_dense(n, 8, seed=5))
    got = np.asarray(layer(params, x))

    q = np.asarray(x @ params.w_q)
    k = np.asarray(x @ params.w_k)
    v = np.asarray(x @ params.w_v)
    scores = q @ k.T / np.sqrt(4)
    attn = np.exp(scores - scores.max(1, keepdims=True))
    attn /= attn.sum(1, keepdims=True)
    want = attn @ v
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_distributed_factorization_trains():
    from bsmr_sddmm.models.factorization import (
        DistributedSparseFactorizationModel)
    from bsmr_sddmm.parallel.mesh import make_mesh

    csr = generate.block_clustered(8, 8, block_prob=0.3, seed=13)
    mesh = make_mesh((4, 2), ("rows", "feat"))
    model = DistributedSparseFactorizationModel.from_csr(csr, mesh, k=16)
    params, losses = model.fit(csr.values, steps=25)
    assert losses[-1] < losses[0] * 0.9, losses[::8]
    assert np.isfinite(losses[-1])


def test_attention_mask_structure():
    from bsmr_sddmm.models import make_attention_mask
    mask = make_attention_mask(96, window=8, num_global=3)
    assert mask.m == mask.n == 96
    d = mask.to_dense() > 0
    assert d.diagonal().all()              # self-attention
    assert d[:, :3].all() and d[:3, :].all()  # global rows/cols
    assert not d[50, 20]                   # outside window, not global
    causal = make_attention_mask(64, window=8, num_global=2, causal=True)
    dc = causal.to_dense() > 0
    iu = np.triu_indices(64, k=1)
    assert not dc[iu].any()                # strictly causal


def test_block_sparse_attention_matches_dense():
    import jax
    from bsmr_sddmm.models import BlockSparseAttention, make_attention_mask
    from bsmr_sddmm.models.block_sparse_attention import (
        dense_reference_attention)
    mask = make_attention_mask(160, window=12, num_global=4)
    model = BlockSparseAttention(mask, feature_dim=24, num_heads=2,
                                 head_dim=16)
    params = model.init(jax.random.PRNGKey(0))
    x = np.random.default_rng(5).standard_normal((160, 24)).astype(
        np.float32)
    got = np.asarray(model(params, x))
    want = dense_reference_attention(params, x, mask)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_block_sparse_attention_grad_flows():
    import jax
    import jax.numpy as jnp
    from bsmr_sddmm.models import BlockSparseAttention, make_attention_mask
    mask = make_attention_mask(64, window=6, num_global=2, causal=True)
    model = BlockSparseAttention(mask, feature_dim=8, num_heads=1,
                                 head_dim=8)
    params = model.init(jax.random.PRNGKey(1))
    x = jnp.asarray(np.random.default_rng(7).standard_normal(
        (64, 8)).astype(np.float32))

    def loss(p):
        return jnp.sum(model(p, x) ** 2)

    grads = jax.grad(loss)(params)
    for g in grads:
        assert np.isfinite(np.asarray(g)).all()
        assert float(np.abs(np.asarray(g)).max()) > 0


def test_factorization_checkpoint_resume(tmp_path):
    from bsmr_sddmm.models import SparseFactorizationModel

    csr = generate.block_clustered(8, 8, block_prob=0.4, seed=5)
    tgt = np.random.default_rng(0).standard_normal(csr.nnz).astype(
        np.float32)
    d = str(tmp_path / "ck")
    m = SparseFactorizationModel.from_csr(csr, 8)
    m.fit(tgt, steps=20, checkpoint_dir=d, checkpoint_every=10)
    # a fresh process/instance resumes from the latest saved step
    m2 = SparseFactorizationModel.from_csr(csr, 8)
    p2, l2 = m2.fit(tgt, steps=30, checkpoint_dir=d, checkpoint_every=10)
    assert len(l2) == 10  # only steps 21..30 ran
    assert np.isfinite(np.asarray(m2.forward(p2))).all()
