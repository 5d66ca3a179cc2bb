#!/usr/bin/env python3
"""On-device A/B of the dense hub-column slab (pack.py "Dense hub slab")
on a bench-suite matrix: same (alpha, delta), H swept, interleaved
within one process so drift between runs cannot fake a winner.

Usage:
    python scripts/probe_hub.py --matrix powerlaw --k 128 \
        --alpha 0.1 --delta 0.05 --hubs 0,640,1024,1280
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--matrix", default="powerlaw")
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--compute-dtype", default="tf32")
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--delta", type=float, default=0.05)
    p.add_argument("--g", type=int, default=1)
    p.add_argument("--c", type=int, default=1)
    p.add_argument("--hubs", default="0,640,1024")
    p.add_argument("--iterations", type=int, default=30)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)

    from bsmr_sddmm.utils.cache import enable_persistent_cache
    enable_persistent_cache()

    import bench
    from bsmr_sddmm.data import generate
    from bsmr_sddmm.ops.hybrid import HybridSDDMM
    from bsmr_sddmm.reorder.autotune import from_params
    from bsmr_sddmm.utils.timing import gflops

    csr = bench.suite(False)[args.matrix]()
    hubs = [int(x) for x in args.hubs.split(",")]
    a = generate.make_dense(csr.m, args.k, seed=1)
    b = generate.make_dense(args.k, csr.n, seed=2)

    runners = {}
    for h in hubs:
        t0 = time.perf_counter()
        tuned = from_params(csr, args.k, alpha=args.alpha,
                            delta=args.delta, group_size=args.g,
                            k_chunks=args.c, hub_cols=h,
                            compute_dtype=args.compute_dtype)
        runner = HybridSDDMM(tuned.packed,
                             compute_dtype=args.compute_dtype,
                             k_chunks=args.c)
        ops = runner.prepare_operands(a, b=b)
        pk = tuned.packed
        print(f"H={h}: tiles=({pk.num_super},{pk.num_quads},"
              f"{pk.num_pairs},{pk.num_groups}) res={pk.nnz_res} "
              f"hub={pk.nnz_hub} packed={pk.packed_size} "
              f"est={tuned.est_ms:.3f}ms  [{time.perf_counter()-t0:.0f}s "
              f"prep]", flush=True)
        runners[h] = (runner, ops)

    times = {h: [] for h in hubs}
    for r in range(args.rounds):
        for h in hubs:  # interleaved: drift hits all H equally
            runner, (a_pad, bt_phys) = runners[h]
            ms = runner.measure_kernel_ms(
                a_pad, bt_phys, iterations=args.iterations, repeats=3,
                order="packed")
            times[h].append(ms)
            print(f"  round {r} H={h}: {ms:.4f} ms "
                  f"({gflops(csr.nnz, args.k, ms):.0f} GFLOPS)",
                  flush=True)
    print("--- medians ---")
    for h in hubs:
        med = float(np.median(times[h]))
        print(f"H={h}: {med:.4f} ms  ({gflops(csr.nnz, args.k, med):.0f} "
              f"GFLOPS)  sessions={[round(x, 4) for x in times[h]]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
