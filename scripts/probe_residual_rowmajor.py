#!/usr/bin/env python3
"""Decide the residual-path formulation for gather-bound regimes.

The residual kernel (ops/hybrid.py:275-293) issues TWO per-entry
descriptors: A row and B group row.  On uniform/hypersparse matrices
(the weakest suite regimes) the residual IS the kernel, so halving
descriptors is ~2x end-to-end.  Candidates, all producing (nnz,) dots
at K=128 fp32:

  entry-random   — per-entry A and B gathers, shuffled indices
                   (worst case; lower bound on engine behavior)
  entry-rowsort  — same but A indices row-sorted (CSR order: runs of
                   ~deg repeats).  If the gather engine coalesces
                   repeated descriptors this matches row-bucketed and
                   NO redesign is needed.
  row-bucketed   — degree-sorted rows in 4 width buckets: one A
                   descriptor per ROW + (R*W_b) B descriptors +
                   einsum('rk,rwk->rw').  Pays the bucket pad on B.

Run on the real chip; timing via measure_loop_ms (hoist-proof).
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--m", type=int, default=16384)
    p.add_argument("--n", type=int, default=16384)
    p.add_argument("--deg", type=int, default=20,
                   help="mean residual entries per row (uniform regime)")
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--iterations", type=int, default=30)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bsmr_sddmm.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    from bsmr_sddmm.utils.timing import gflops, measure_loop_ms

    rng = np.random.default_rng(11)
    m, n, k, deg = args.m, args.n, args.k, args.deg
    # Poisson-ish degrees, capped: the realistic ragged shape
    degs = np.clip(rng.poisson(deg, size=m), 0, 4 * deg)
    nnz = int(degs.sum())
    rows = np.repeat(np.arange(m, dtype=np.int32), degs)
    cols = rng.integers(0, n, size=nnz, dtype=np.int32)
    order = rng.permutation(nnz)

    a = jnp.asarray(rng.standard_normal((m + 1, k)), dtype=jnp.float32)
    bt = jnp.asarray(rng.standard_normal((n + 1, k)), dtype=jnp.float32)
    print(f"m={m} n={n} nnz={nnz} K={k} mean_deg={nnz/m:.1f}", flush=True)

    def entry_body(rows_d, cols_d):
        def body(c, a_d, bt_d, r_d, c_d):
            r2 = jnp.where(c > jnp.float32(-1e30), r_d, 0)
            ar = jnp.take(a_d, r2, axis=0)
            br = jnp.take(bt_d, c_d, axis=0)
            return jnp.sum(ar * br, axis=-1)
        return body, (a, bt, jnp.asarray(rows_d), jnp.asarray(cols_d))

    # row-bucketed layout: rows sorted by degree, 4 width buckets
    # (exact-first bucketing in the real pack; this approximates its
    # pad ratio).  One A descriptor per ROW, W_b B descriptors per row.
    off = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(degs, out=off[1:])
    wpos = np.arange(nnz, dtype=np.int64) - off[rows]
    rord = np.argsort(-degs, kind="stable")
    nb = 4
    buckets = []
    pad_cells = 0
    for i in range(nb):
        rs = rord[(i * m) // nb:((i + 1) * m) // nb]
        rs = rs[degs[rs] > 0]
        if not len(rs):
            continue
        Wb = int(degs[rs].max())
        local = np.full(m, -1, dtype=np.int64)
        local[rs] = np.arange(len(rs))
        gidsb = np.full((len(rs), Wb), n, dtype=np.int32)
        sel = local[rows] >= 0
        gidsb[local[rows[sel]], wpos[sel]] = cols[sel]
        buckets.append((jnp.asarray(rs.astype(np.int32)),
                        jnp.asarray(gidsb), Wb))
        pad_cells += len(rs) * Wb
    pad_ratio = pad_cells / max(nnz, 1)

    def bucket_body(c, a_d, bt_d, *ops):
        c0 = jnp.where(c > jnp.float32(-1e30), 0, 1).astype(jnp.int32)
        outs = []
        for j in range(0, len(ops), 2):
            rs_d, g_d = ops[j], ops[j + 1]
            Wb = g_d.shape[1]
            ar = jnp.take(a_d, rs_d + c0, axis=0)
            br = jnp.take(bt_d, g_d.reshape(-1),
                          axis=0).reshape(-1, Wb, k)
            outs.append(jnp.einsum("rk,rwk->rw", ar, br,
                                   preferred_element_type=jnp.float32
                                   ).reshape(-1))
        return jnp.concatenate(outs)

    flat_ops = [x for rs_d, g_d, _ in buckets for x in (rs_d, g_d)]
    cands = {
        "entry-random": entry_body(rows[order], cols[order]),
        "entry-rowsort": entry_body(rows, cols),
        "row-bucketed": (bucket_body, tuple([a, bt] + flat_ops)),
    }
    times = {t: [] for t in cands}
    for r in range(args.rounds):
        for tag, (body, ops) in cands.items():
            ms = measure_loop_ms(body, ops, iterations=args.iterations,
                                 repeats=3)
            times[tag].append(ms)
            print(f"  round {r} [{tag}]: {ms:.4f} ms "
                  f"({gflops(nnz, k, ms):.0f} GFLOPS)", flush=True)
    print(f"--- medians (row-bucketed pad_ratio={pad_ratio:.2f}) ---")
    for tag in cands:
        med = float(np.median(times[tag]))
        print(f"[{tag}]: {med:.4f} ms ({gflops(nnz, k, med):.0f} GFLOPS)"
              f" sessions={[round(x, 4) for x in times[tag]]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
