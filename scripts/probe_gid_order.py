#!/usr/bin/env python3
"""Does B-gather rate depend on the ADDRESS order of the grouped B^T
rows?  A source-footprint effect (small sources gathering several
times faster than large ones) could be an address-range
working-set effect — if so, renumbering the physical group rows into
*first-use order* (so consecutive tiles touch nearby addresses) should
speed the same gather without changing a single descriptor count.

Interleaved A/B of the identical packing with (a) the stock column-rank
group order and (b) first-kernel-use order, on one bench matrix.  If (b)
wins, a streaming-order B relayout is a real lever (round-4 candidate).

Usage:
    python scripts/probe_gid_order.py --matrix clustered16 --k 128
"""

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def first_use_remap(packed):
    """PackedMatrix with physical group rows renumbered into the order
    the kernel first touches them (hub-free packings only)."""
    assert packed.hub_cols == 0, "hub slab pins the leading ranks"
    NG = packed.num_col_groups
    G = packed.group_size
    issue = np.concatenate([
        packed.super_gids.reshape(-1), packed.quad_gids.reshape(-1),
        packed.pair_gids.reshape(-1), packed.group_gids.reshape(-1),
        packed.res_gids.reshape(-1)])
    issue = issue[issue < NG]
    first = np.full(NG, np.iinfo(np.int64).max, dtype=np.int64)
    pos = np.arange(len(issue), dtype=np.int64)
    # reversed so earlier positions overwrite later ones
    first[issue[::-1]] = pos[::-1]
    rank = np.empty(NG + 1, dtype=np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(NG)
    rank[NG] = NG  # sentinel stays sentinel

    inv = np.empty(NG, dtype=np.int64)
    inv[rank[:NG]] = np.arange(NG)
    col_order = packed.col_order.reshape(NG, G)[inv].reshape(-1)

    def remap(g):
        return rank[g.astype(np.int64)].astype(g.dtype)

    return dataclasses.replace(
        packed, col_order=col_order,
        super_gids=remap(packed.super_gids),
        quad_gids=remap(packed.quad_gids),
        pair_gids=remap(packed.pair_gids),
        group_gids=remap(packed.group_gids),
        res_gids=remap(packed.res_gids))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--matrix", default="clustered16")
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--alpha", type=float, default=0.3)
    p.add_argument("--delta", type=float, default=0.05)
    p.add_argument("--iterations", type=int, default=30)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--skip-check", action="store_true")
    args = p.parse_args(argv)

    import bench
    from bsmr_sddmm.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    from bsmr_sddmm.data import generate
    from bsmr_sddmm.ops.hybrid import HybridSDDMM
    from bsmr_sddmm.ops.reference import sddmm_reference
    from bsmr_sddmm.reorder.autotune import from_params
    from bsmr_sddmm.utils.check import check_values
    from bsmr_sddmm.utils.timing import gflops

    csr = bench.suite(False)[args.matrix]()
    tuned = from_params(csr, args.k, alpha=args.alpha, delta=args.delta)
    packs = {"stock": tuned.packed,
             "first-use": first_use_remap(tuned.packed)}
    a = generate.make_dense(csr.m, args.k, seed=1)
    b = generate.make_dense(args.k, csr.n, seed=2)
    golden = None if args.skip_check else sddmm_reference(a, b, csr)

    tagged = []
    for tag, pk in packs.items():
        runner = HybridSDDMM(pk, compute_dtype="tf32")
        ops = runner.prepare_operands(a, b=b)
        if golden is not None:
            res = check_values(golden, np.asarray(
                runner.run_padded(*ops, order="csr")))
            print(f"[{tag}] contract {'PASS' if res.passed else 'FAIL'} "
                  f"max_rel={res.max_rel_err:.2e}", flush=True)
        tagged.append((tag, runner, ops))

    times = {tag: [] for tag, _, _ in tagged}
    for r in range(args.rounds):
        for tag, runner, (ap, bp) in tagged:
            ms = runner.measure_kernel_ms(ap, bp,
                                          iterations=args.iterations,
                                          repeats=3, order="packed")
            times[tag].append(ms)
            print(f"  round {r} [{tag}]: {ms:.4f} ms "
                  f"({gflops(csr.nnz, args.k, ms):.0f} GFLOPS)",
                  flush=True)
    print("--- medians ---")
    for tag, _, _ in tagged:
        med = float(np.median(times[tag]))
        print(f"[{tag}]: {med:.4f} ms "
              f"({gflops(csr.nnz, args.k, med):.0f} GFLOPS)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
