#!/usr/bin/env python3
"""Interleaved on-device A/B across *packing configs* on one bench
matrix — the round-robin twin of probe_dtype.py (which varies only the
compute dtype on a single packing).  Each config is packed once, then
all configs are measured in rotation within one process so drift
between runs cannot fake a ranking.

Config spec grammar (comma-separated key=val, semicolon-separated
specs):  a=0.1,d=0.05,g=2,c=1,hub=2048,apanels=1,dtype=tf32

Usage:
    python scripts/probe_configs.py --matrix powerlaw --k 128 \
        --configs "a=0.1,d=0.05,g=1,hub=2048;a=0.1,d=0.05,g=2,hub=2048"
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def parse_spec(spec: str) -> dict:
    out = {"a": 0.3, "d": 0.05, "g": 1, "c": 1, "hub": 0,
           "dtype": "tf32", "merge": 1, "apanels": 0, "windowdp": 1,
           "sort": "cid", "sortres": "csr", "bscale": 1.0, "rowslab": 0,
           "rowslabpre": 0}
    for kv in spec.split(","):
        k, v = kv.split("=")
        k = k.strip()
        if k in ("a", "d", "bscale"):
            out[k] = float(v)
        elif k in ("dtype", "sort", "sortres"):
            out[k] = v.strip()
        else:
            out[k] = int(v)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--matrix", default="powerlaw")
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--configs", required=True,
                   help="semicolon-separated config specs")
    p.add_argument("--iterations", type=int, default=30)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--skip-check", action="store_true",
                   help="skip the golden tolerance check (saves host "
                        "time on huge matrices)")
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
    specs = [parse_spec(s) for s in args.configs.split(";") if s.strip()]
    a = generate.make_dense(csr.m, args.k, seed=1)
    b = generate.make_dense(args.k, csr.n, seed=2)
    golden = None if args.skip_check else sddmm_reference(a, b, csr)

    tagged = []
    for sp in specs:
        t0 = time.perf_counter()
        tuned = from_params(csr, args.k, alpha=sp["a"], delta=sp["d"],
                            group_size=sp["g"], k_chunks=sp["c"],
                            merge_superpanels=bool(sp["merge"]),
                            hub_cols=sp["hub"],
                            compute_dtype=sp["dtype"],
                            window_dp=bool(sp["windowdp"]),
                            sort_runs=sp["sort"], sort_res=sp["sortres"],
                            b_cost_scale=sp["bscale"],
                            hot_rows=sp["rowslabpre"] or sp["rowslab"],
                            hot_rows_pre=bool(sp["rowslabpre"]))
        pk = tuned.packed
        tag = (f"a={sp['a']} d={sp['d']} G={sp['g']} C={sp['c']} "
               f"H={sp['hub']}"
               + (" apanels" if sp["apanels"] else "")
               + ("" if sp["merge"] else " nomerge")
               + ("" if sp["windowdp"] else " legacy-carve")
               + (f" sort={sp['sort']}" if sp["sort"] != "cid" else "")
               + (f" sortres={sp['sortres']}"
                  if sp["sortres"] != "csr" else "")
               + (f" rowslab={sp['rowslab']}" if sp["rowslab"] else "")
               + (f" rowslabpre={sp['rowslabpre']}"
                  if sp["rowslabpre"] else "")
               + (f" bscale={sp['bscale']}" if sp["bscale"] != 1.0 else "")
               + (f" {sp['dtype']}" if sp["dtype"] != "tf32" else ""))
        runner = HybridSDDMM(pk, compute_dtype=sp["dtype"],
                             k_chunks=sp["c"],
                             a_layout="panels" if sp["apanels"] else "rows")
        ops = runner.prepare_operands(a, b=b)
        print(f"[{tag}] tiles=({pk.num_super},{pk.num_quads},"
              f"{pk.num_pairs},{pk.num_groups}) res={pk.nnz_res} "
              f"hub={pk.nnz_hub} cells={pk.packed_size} "
              f"[{time.perf_counter()-t0:.0f}s prep]", flush=True)
        if golden is not None:
            res = check_values(golden, np.asarray(
                runner.run_padded(*ops, order="csr")))
            print(f"[{tag}] contract "
                  f"{'PASS' if res.passed else 'FAIL'} "
                  f"max_rel={res.max_rel_err:.2e}", flush=True)
        tagged.append((tag, runner, ops))

    times = {tag: [] for tag, _, _ in tagged}
    for r in range(args.rounds):
        for tag, runner, (a_pad, bt_phys) in tagged:
            ms = runner.measure_kernel_ms(
                a_pad, bt_phys, iterations=args.iterations, repeats=3,
                order="packed")
            times[tag].append(ms)
            print(f"  round {r} [{tag}]: {ms:.4f} ms "
                  f"({gflops(csr.nnz, args.k, ms):.0f} GFLOPS)",
                  flush=True)
    print("--- medians ---")
    best = None
    for tag, _, _ in tagged:
        med = float(np.median(times[tag]))
        g = gflops(csr.nnz, args.k, med)
        print(f"[{tag}]: {med:.4f} ms ({g:.0f} GFLOPS) "
              f"sessions={[round(x, 4) for x in times[tag]]}")
        if best is None or med < best[1]:
            best = (tag, med)
    print(f"winner: [{best[0]}] {best[1]:.4f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
