#!/usr/bin/env python3
"""Interleaved on-device A/B of compute/storage dtypes on one fixed
packing config — answers "does halving the B gather width pay?"
without drift between runs faking the answer.  Also reports the
tolerance-contract status of each mode against the fp32 golden.

Usage:
    python scripts/probe_dtype.py --matrix clustered16 --k 128 \
        --alpha 0.3 --delta 0.05 --dtypes tf32,mixed
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--matrix", default="clustered16")
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--alpha", type=float, default=0.3)
    p.add_argument("--delta", type=float, default=0.05)
    p.add_argument("--g", type=int, default=1)
    p.add_argument("--c", type=int, default=1)
    p.add_argument("--hub", type=int, default=0)
    p.add_argument("--dtypes", default="tf32,mixed")
    p.add_argument("--iterations", type=int, default=30)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)

    from bsmr_sddmm.utils.cache import enable_persistent_cache
    enable_persistent_cache()

    import bench
    from bsmr_sddmm.data import generate
    from bsmr_sddmm.ops.hybrid import HybridSDDMM
    from bsmr_sddmm.ops.reference import sddmm_reference
    from bsmr_sddmm.reorder.autotune import from_params
    from bsmr_sddmm.utils.check import check_values
    from bsmr_sddmm.utils.timing import gflops

    csr = bench.suite(False)[args.matrix]()
    dtypes = args.dtypes.split(",")
    a = generate.make_dense(csr.m, args.k, seed=1)
    b = generate.make_dense(args.k, csr.n, seed=2)

    tuned = from_params(csr, args.k, alpha=args.alpha, delta=args.delta,
                        group_size=args.g, k_chunks=args.c,
                        hub_cols=args.hub)
    pk = tuned.packed
    print(f"{args.matrix}: tiles=({pk.num_super},{pk.num_quads},"
          f"{pk.num_pairs},{pk.num_groups}) res={pk.nnz_res} "
          f"hub={pk.nnz_hub}", flush=True)
    golden = sddmm_reference(a, b, csr)

    runners = {}
    for dt in dtypes:
        runner = HybridSDDMM(pk, compute_dtype=dt, k_chunks=args.c)
        ops = runner.prepare_operands(a, b=b)
        res = check_values(golden, np.asarray(
            runner.run_padded(*ops, order="csr")))
        print(f"{dt}: contract "
              f"{'PASS' if res.passed else 'FAIL'} max_rel="
              f"{res.max_rel_err:.2e}", flush=True)
        runners[dt] = (runner, ops)

    times = {dt: [] for dt in dtypes}
    for r in range(args.rounds):
        for dt in dtypes:
            runner, (a_pad, bt_phys) = runners[dt]
            ms = runner.measure_kernel_ms(
                a_pad, bt_phys, iterations=args.iterations, repeats=3,
                order="packed")
            times[dt].append(ms)
            print(f"  round {r} {dt}: {ms:.4f} ms "
                  f"({gflops(csr.nnz, args.k, ms):.0f} GFLOPS)",
                  flush=True)
    print("--- medians ---")
    for dt in dtypes:
        med = float(np.median(times[dt]))
        print(f"{dt}: {med:.4f} ms ({gflops(csr.nnz, args.k, med):.0f} "
              f"GFLOPS) sessions={[round(x, 4) for x in times[dt]]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
