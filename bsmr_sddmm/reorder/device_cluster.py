"""Device-side batched multi-leader row clustering (jax.lax).

The device counterpart of the reference's on-GPU clustering
(src/rowReordering.cu:325-432 runs the greedy lock-chain on device;
:1027-1095 orchestrates) — algorithmically identical to the host
``rows._batched_cluster`` multi-leader approximation, executed as jitted
elementwise work on dense normalized encodings:

- per round, the first L unassigned rows in dispersion order become
  leader candidates (found with ``top_k`` over a live-priority vector —
  no dynamic shapes),
- leaders are deduplicated against each other sequentially
  (``fori_loop`` over the (L, L) pairwise similarity matrix),
- every remaining row joins the earliest accepting leader; similarity is
  the reference's normalized-weighted-Jaccard
  ``min_sum / (|x| + |y| - min_sum)`` on L1-normalized encodings,
  computed in fp32 as chunked min-contractions,
- the same early-bail rule as the host version (rounds that stop
  clustering degrade to singleton clusters).

The round loop lives on the host (one scalar fetch per round); each
round is one compiled program.  Matches ``rows._batched_cluster`` with
``hat_dtype=np.float32`` exactly (tests/test_device_cluster.py).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

_NEG = jnp.float32(-1.0)


def _dense_hats(block_ptr, block_idx, block_cnt, num_rows, num_blocks):
    """(m, B) fp32 normalized encodings + (m,) hat sums, host-built."""
    occ = np.diff(block_ptr)
    row_of = np.repeat(np.arange(num_rows), occ.astype(np.int64))
    cnt = block_cnt.astype(np.float32)
    norm_sq = np.zeros(num_rows, dtype=np.float32)
    np.add.at(norm_sq, row_of, cnt * cnt)
    norms = np.sqrt(np.maximum(norm_sq, 1e-30))
    hat = np.zeros((num_rows, num_blocks), dtype=np.float32)
    hat[row_of, block_idx.astype(np.int64)] = cnt / norms[row_of]
    return hat, hat.sum(axis=1)


@functools.partial(jax.jit, static_argnames=("L", "chunk"))
def _round_step(hat, hat_sum, order_pos, live, alpha,
                L=32, chunk=2048):
    """One multi-leader round.  Returns (cluster_delta, live', accepted_n)
    where cluster_delta[i] >= 0 assigns row i to cluster base + delta."""
    m = hat.shape[0]
    big = jnp.int32(np.iinfo(np.int32).max)
    # first L live rows in dispersion order
    pri = jnp.where(live, order_pos, big)
    neg_top, lead_rows = jax.lax.top_k(-pri, L)  # rows with smallest pos
    lead_valid = (-neg_top) < big

    lead_hat = hat[lead_rows]                       # (L, B)
    lead_sum = hat_sum[lead_rows]                   # (L,)

    # pairwise leader sims (L, L)
    min_ll = jnp.minimum(lead_hat[:, None, :],
                         lead_hat[None, :, :]).sum(-1)
    sim_ll = min_ll / jnp.maximum(lead_sum[:, None] + lead_sum[None, :]
                                  - min_ll, 1e-30)

    # sequential dedup: accepted[i], and for dropped leaders the index of
    # the first accepting accepted leader
    def dedup(i, carry):
        accepted, assign_to = carry
        hits = (sim_ll[i] > alpha) & accepted & lead_valid \
            & (jnp.arange(L) < i)
        any_hit = hits.any()
        first = jnp.argmax(hits)
        accepted = accepted.at[i].set(lead_valid[i] & ~any_hit)
        assign_to = assign_to.at[i].set(
            jnp.where(any_hit, first, jnp.int32(-1)))
        return accepted, assign_to

    accepted, lead_assign = jax.lax.fori_loop(
        0, L, dedup, (jnp.zeros(L, dtype=bool),
                      jnp.full(L, -1, dtype=jnp.int32)))
    # cluster index (creation order) of each accepted leader
    lead_cluster = jnp.cumsum(accepted.astype(jnp.int32)) - 1
    n_accepted = accepted.sum()

    # rows join the earliest accepting *accepted* leader
    def row_chunk(c0, delta):
        h = jax.lax.dynamic_slice_in_dim(hat, c0 * chunk, chunk, axis=0)
        s = jax.lax.dynamic_slice_in_dim(hat_sum, c0 * chunk, chunk,
                                         axis=0)
        # min-contraction via a fori over leaders keeps peak memory at
        # (chunk, B) instead of (chunk, L, B)
        def per_leader(l, acc):
            ms = jnp.minimum(h, lead_hat[l][None, :]).sum(-1)
            return acc.at[:, l].set(ms)

        min_rl = jax.lax.fori_loop(
            0, L, per_leader, jnp.zeros((chunk, L), jnp.float32))
        sim = min_rl / jnp.maximum(s[:, None] + lead_sum[None, :]
                                   - min_rl, 1e-30)
        hit = (sim > alpha) & accepted[None, :]
        any_hit = hit.any(axis=1)
        first = jnp.argmax(hit, axis=1)
        d = jnp.where(any_hit, lead_cluster[first], jnp.int32(-1))
        return jax.lax.dynamic_update_slice_in_dim(delta, d, c0 * chunk,
                                                   axis=0)

    n_chunks = m // chunk  # m pre-padded to a chunk multiple by caller
    delta = jax.lax.fori_loop(
        0, n_chunks, row_chunk, jnp.full(m, -1, dtype=jnp.int32))
    # rows already assigned (or not live) keep -1
    delta = jnp.where(live, delta, jnp.int32(-1))
    # leaders override the chunk pass: accepted -> own cluster, dropped
    # (but valid) -> their accepting leader's cluster
    lead_delta = jnp.where(
        accepted, lead_cluster,
        jnp.where(lead_assign >= 0, lead_cluster[lead_assign],
                  jnp.int32(-1)))
    delta = delta.at[lead_rows].set(
        jnp.where(lead_valid, lead_delta, delta[lead_rows]))
    live = live & (delta < 0)
    return delta, live, n_accepted


def batched_cluster_device(order, block_ptr, block_idx, block_cnt,
                           num_blocks, alpha: float,
                           leaders_per_round: int = 32,
                           max_rounds=None, bail_after: int = 48,
                           bail_yield: float = 1.5,
                           chunk: int = 2048):
    """Drop-in device counterpart of ``rows._batched_cluster`` (same
    signature semantics, same return).  Encodings are densified once and
    all similarity work runs on the accelerator."""
    num_rows_total = block_ptr.shape[0] - 1
    cluster_of = np.full(num_rows_total, -1, dtype=np.int64)
    if not len(order):
        return cluster_of, 0

    hat_np, hat_sum_np = _dense_hats(block_ptr, block_idx, block_cnt,
                                     num_rows_total, num_blocks)
    m_pad = -(-num_rows_total // chunk) * chunk
    if m_pad != num_rows_total:
        hat_np = np.concatenate(
            [hat_np, np.zeros((m_pad - num_rows_total, num_blocks),
                              dtype=np.float32)])
        hat_sum_np = np.concatenate(
            [hat_sum_np, np.zeros(m_pad - num_rows_total,
                                  dtype=np.float32)])
    hat = jnp.asarray(hat_np)
    hat_sum = jnp.asarray(hat_sum_np)
    # dispersion-order position per row; non-candidates never selected
    order_pos_np = np.full(m_pad, np.iinfo(np.int32).max, dtype=np.int32)
    order_pos_np[np.asarray(order)] = np.arange(len(order),
                                                dtype=np.int32)
    order_pos = jnp.asarray(order_pos_np)
    live = jnp.asarray(order_pos_np
                       < np.iinfo(np.int32).max)

    L = int(leaders_per_round)
    alpha_j = jnp.float32(alpha)
    num_clusters = 0
    rounds = 0
    total_rows = len(order)
    order_arr = np.asarray(order)
    while True:
        live_np = np.asarray(live[:num_rows_total])
        n_live = int(live_np.sum())
        if n_live == 0:
            break
        rounds += 1
        assigned_so_far = total_rows - n_live
        bail = (rounds > bail_after
                and assigned_so_far
                < bail_yield * leaders_per_round * rounds)
        if bail or (max_rounds is not None and rounds > max_rounds):
            rest = order_arr[live_np[order_arr]]
            cluster_of[rest] = num_clusters + np.arange(len(rest))
            num_clusters += len(rest)
            break
        delta, live, n_accepted = _round_step(
            hat, hat_sum, order_pos, live, alpha_j, L=L, chunk=chunk)
        d_np = np.asarray(delta[:num_rows_total])
        got = d_np >= 0
        cluster_of[got] = num_clusters + d_np[got]
        num_clusters += int(n_accepted)
    return cluster_of, num_clusters
