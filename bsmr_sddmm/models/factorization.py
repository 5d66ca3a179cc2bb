"""Sparse matrix factorization — the canonical *training* use of SDDMM.

Learn low-rank factors A (M, K) and B^T (N, K) whose products reproduce the
observed entries of a sparse matrix S: minimize
``mean((SDDMM(A, B, pattern(S)) - S.values)^2)``.  The forward pass is the
framework's hybrid SDDMM, so gradients flow through the gather/matmul/
inverse-gather pipeline (scatter-adds in the backward are XLA segment ops).

The reference has no training capability (SURVEY.md: "It is NOT a training
framework"); this model family exercises the ops the way a production
recommender/GNN embedding trainer would, and is the flagship model for the
multi-chip training-step dry run.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from bsmr_sddmm import config
from bsmr_sddmm.data.sparse import CSR
from bsmr_sddmm.ops.hybrid import HybridSDDMM
from bsmr_sddmm.reorder.bsmr import BSMR
from bsmr_sddmm.reorder.pack import PackedMatrix, pack


class FactorizationParams(NamedTuple):
    a: jax.Array    # (M, K)
    bt: jax.Array   # (N, K)


class SparseFactorizationModel:
    """SDDMM-based low-rank factorization trainer."""

    def __init__(self, packed: PackedMatrix, k: int,
                 learning_rate: float = 1e-2,
                 compute_dtype: str = "float32",
                 optimizer: Optional[optax.GradientTransformation] = None):
        self.packed = packed
        self.k = k
        self.compute_dtype = compute_dtype
        self.runner = HybridSDDMM(packed, compute_dtype=compute_dtype)
        self.optimizer = optimizer or optax.adam(learning_rate)
        # Packed-order slot weights: 1.0 on real nnz, 0.0 on padding cells.
        w = np.zeros(packed.packed_size, dtype=np.float32)
        w[packed.inv_idx] = 1.0
        self._slot_weight = jnp.asarray(w)
        self._inv_idx = jnp.asarray(packed.inv_idx, dtype=jnp.int32)

    def init(self, rng_key) -> FactorizationParams:
        ka, kb = jax.random.split(rng_key)
        scale = 1.0 / np.sqrt(self.k)
        a = jax.random.normal(ka, (self.packed.m, self.k),
                              dtype=jnp.float32) * scale
        bt = jax.random.normal(kb, (self.packed.n, self.k),
                               dtype=jnp.float32) * scale
        return FactorizationParams(a, bt)

    def forward(self, params: FactorizationParams,
                order: str = "packed") -> jax.Array:
        """Predicted values at the nnz positions (packed order by default;
        pass order="csr" for CSR entry order)."""
        a_pad = jnp.concatenate(
            [params.a, jnp.zeros((1, self.k), params.a.dtype)])
        bt_pad = jnp.concatenate(
            [params.bt, jnp.zeros((1, self.k), params.bt.dtype)])
        return self.runner.run_padded(a_pad, bt_pad, order=order)

    def pack_targets(self, targets) -> jax.Array:
        """Scatter CSR-order target values into the packed layout (host
        numpy, done once — targets are constant across training steps)."""
        tp = np.zeros(self.packed.packed_size, dtype=np.float32)
        tp[self.packed.inv_idx] = np.asarray(targets, dtype=np.float32)
        return jnp.asarray(tp)

    def loss(self, params: FactorizationParams,
             targets_packed: jax.Array) -> jax.Array:
        """targets_packed: (F,) packed-order targets (see pack_targets).
        Padding slots carry zero weight."""
        pred = self.forward(params, order="packed")
        err = (pred - targets_packed) ** 2 * self._slot_weight
        return jnp.sum(err) / self.packed.nnz

    def make_train_step(self):
        opt = self.optimizer

        @jax.jit
        def train_step(params, opt_state, targets):
            loss, grads = jax.value_and_grad(self.loss)(params, targets)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        return train_step

    def fit(self, targets, rng_key=None, steps: int = 100,
            checkpoint_dir: str = None, checkpoint_every: int = 50):
        """targets: (nnz,) CSR-order observed values.

        With ``checkpoint_dir`` the params/optimizer/step state is
        persisted every ``checkpoint_every`` steps (utils/checkpoint.py)
        and a crashed fit resumes from the latest saved step."""
        rng_key = rng_key if rng_key is not None else jax.random.PRNGKey(0)
        params = self.init(rng_key)
        opt_state = self.optimizer.init(params)
        start = 0
        ck = None
        if checkpoint_dir:
            from bsmr_sddmm.utils.checkpoint import Checkpointer
            ck = Checkpointer(checkpoint_dir)
            saved = ck.restore(like={"params": params, "opt": opt_state})
            if saved is not None:
                params = FactorizationParams(*saved["params"])
                opt_state = saved["opt"]
                start = int(ck.latest_step)
        step = self.make_train_step()
        targets_packed = self.pack_targets(targets)
        losses = []
        for i in range(start, steps):
            params, opt_state, loss = step(params, opt_state, targets_packed)
            losses.append(float(loss))
            if ck is not None and ((i + 1) % checkpoint_every == 0
                                   or i + 1 == steps):
                ck.save(i + 1, {"params": params, "opt": opt_state})
        return params, losses

    @staticmethod
    def from_csr(csr: CSR, k: int, alpha: float = config.DEFAULT_ALPHA,
                 delta: float = config.DEFAULT_DELTA,
                 **kwargs) -> "SparseFactorizationModel":
        bsmr = BSMR(alpha, delta, csr)
        return SparseFactorizationModel(pack(csr, bsmr), k, **kwargs)


class DistributedSparseFactorizationModel:
    """Multi-chip variant: the same trainer over a ('rows', 'feat') mesh.

    Uses DistributedHybridSDDMM (the sharded fast path) with the
    packed-target loss pattern, so the training step is sharded end to
    end — parameters K-sharded on 'feat', activations/outputs sharded on
    'rows', no all-gather of the flat value vector (parallel/dist.py)."""

    def __init__(self, packed: PackedMatrix, mesh, k: int,
                 learning_rate: float = 1e-2,
                 compute_dtype: str = "float32",
                 optimizer: Optional[optax.GradientTransformation] = None):
        from jax.sharding import NamedSharding, PartitionSpec as P

        from bsmr_sddmm.parallel.dist import DistributedHybridSDDMM

        self.packed = packed
        self.k = k
        self.dist = DistributedHybridSDDMM(packed, mesh,
                                           compute_dtype=compute_dtype)
        self.optimizer = optimizer or optax.adam(learning_rate)
        self._param_sharding = NamedSharding(mesh, P(None, "feat"))

    def init(self, rng_key) -> FactorizationParams:
        ka, kb = jax.random.split(rng_key)
        scale = 1.0 / np.sqrt(self.k)
        a = jax.random.normal(ka, (self.packed.m, self.k),
                              dtype=jnp.float32) * scale
        bt = jax.random.normal(kb, (self.packed.n, self.k),
                               dtype=jnp.float32) * scale
        put = functools.partial(jax.device_put,
                                device=self._param_sharding)
        return FactorizationParams(put(a), put(bt))

    def pack_targets(self, targets):
        """(targets, mask) in the sharded (R, flat_local) layout."""
        return self.dist.make_packed_targets(targets)

    def loss(self, params: FactorizationParams, targets, mask):
        a_pad = jnp.concatenate(
            [params.a, jnp.zeros((1, self.k), params.a.dtype)])
        bt_pad = jnp.concatenate(
            [params.bt, jnp.zeros((1, self.k), params.bt.dtype)])
        a_sh, bt_sh = self.dist.device_prepare(a_pad, bt_pad)
        pred = self.dist.run_padded(a_sh, bt_sh, order="packed")
        err = jnp.where(mask, pred - targets, 0.0) ** 2
        return jnp.sum(err) / self.packed.nnz

    def make_train_step(self):
        opt = self.optimizer

        @jax.jit
        def train_step(params, opt_state, targets, mask):
            loss, grads = jax.value_and_grad(self.loss)(params, targets,
                                                        mask)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        return train_step

    def fit(self, targets, rng_key=None, steps: int = 50):
        rng_key = rng_key if rng_key is not None else jax.random.PRNGKey(0)
        params = self.init(rng_key)
        opt_state = self.optimizer.init(params)
        step = self.make_train_step()
        tp, mask = self.pack_targets(targets)
        losses = []
        for _ in range(steps):
            params, opt_state, loss = step(params, opt_state, tp, mask)
            losses.append(float(loss))
        return params, losses

    @staticmethod
    def from_csr(csr: CSR, mesh, k: int,
                 alpha: float = config.DEFAULT_ALPHA,
                 delta: float = config.DEFAULT_DELTA,
                 **kwargs) -> "DistributedSparseFactorizationModel":
        bsmr = BSMR(alpha, delta, csr)
        return DistributedSparseFactorizationModel(pack(csr, bsmr), mesh,
                                                   k, **kwargs)
