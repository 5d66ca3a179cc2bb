#!/usr/bin/env python
"""Multi-chip scaling harness for the sharded hybrid SDDMM.

On real multi-chip hardware this measures nnz/s at 1..N chips (the
north-star metric: >=80% scaling efficiency).  On a single-chip or
CPU-only environment it still *validates* the sharded path end-to-end on
a virtual device mesh (--virtual N): numerical agreement with the
single-device result, per-device tile balance, and a compiled-HLO
collective audit (asserting the flat value vector is never
all-gathered in the step) — wall-clock numbers on a virtual mesh are
NOT performance (all "devices" share one physical core) and are
labeled as such.

Usage:
    python scripts/scaling_bench.py --virtual 8            # CPU validation
    python scripts/scaling_bench.py --devices 1 2 4 8      # real chips
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--virtual", type=int, default=0,
                   help="force a virtual CPU mesh of this many devices")
    p.add_argument("--devices", type=int, nargs="+", default=None,
                   help="device counts to measure (real hardware)")
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--iterations", type=int, default=10)
    args = p.parse_args(argv)

    if args.virtual:
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.virtual)
    import jax
    import numpy as np

    from bsmr_sddmm.data import generate
    from bsmr_sddmm.ops.hybrid import HybridSDDMM
    from bsmr_sddmm.parallel.dist import DistributedHybridSDDMM
    from bsmr_sddmm.parallel.mesh import make_mesh
    from bsmr_sddmm.reorder.bsmr import BSMR
    from bsmr_sddmm.reorder.pack import pack

    n_avail = len(jax.devices())
    counts = args.devices or sorted(
        {c for c in (1, 2, 4, 8) if c <= n_avail})
    virtual = args.virtual > 0 or jax.devices()[0].platform == "cpu"

    csr = generate.block_clustered(
        64 if virtual else 1024, 64 if virtual else 1024,
        block_prob=0.08 if virtual else 0.008,
        block_density=0.65, noise_density=1e-5, seed=42)
    k = args.k
    bsmr = BSMR(0.3, 0.05, csr)
    packed = pack(csr, bsmr)
    a = generate.make_dense(csr.m, k, seed=1)
    b = generate.make_dense(k, csr.n, seed=2)

    # Single-device reference values for correctness.
    ref_runner = HybridSDDMM(packed, compute_dtype="float32")
    ref_vals = np.asarray(ref_runner(a, b, order="csr"))

    from bsmr_sddmm.parallel.dist import count_collectives

    results = []
    for c in counts:
        feat = 2 if c >= 4 and c % 2 == 0 else 1
        mesh = make_mesh((c // feat, feat), ("rows", "feat"),
                         devices=jax.devices()[:c])
        dist = DistributedHybridSDDMM(packed, mesh,
                                      compute_dtype="float32")
        a_pad, bt_pad = dist.prepare_operands(a, b=b)
        vals = np.asarray(dist.run_padded(a_pad, bt_pad, order="csr"))
        err = float(np.max(np.abs(vals - ref_vals))
                    / (np.abs(ref_vals).max() + 1e-12))
        # Compiled-HLO collective audit of the packed-order step: the
        # flat value vector must stay sharded (no all-gather); the only
        # hot-path collective is the psum over 'feat' (an all-reduce,
        # absent when feat == 1 and XLA elides the trivial psum).
        coll = count_collectives(dist.compiled_hlo(a_pad, bt_pad))
        assert coll["all-gather"] == 0, (
            f"devices={c}: unexpected all-gather in the sharded step "
            f"({coll})")
        balance = dist.tile_balance()
        bal_ratio = float(balance.max() / max(balance.mean(), 1.0))
        t0 = time.perf_counter()
        for _ in range(args.iterations):
            out = dist.run_padded(a_pad, bt_pad, order="packed")
        float(np.asarray(out).ravel()[0])
        dt = (time.perf_counter() - t0) / args.iterations
        nnz_s = csr.nnz / dt
        results.append({"devices": c, "mesh": [c // feat, feat],
                        "max_rel_err": err,
                        "nnz_per_s": round(nnz_s / 1e6, 1),
                        "collectives": coll,
                        "tile_balance_max_over_mean": round(bal_ratio, 3)})
        print(f"devices={c}: max_rel_err={err:.2e} "
              f"nnz/s={nnz_s/1e6:.1f}M collectives={coll} "
              f"balance={bal_ratio:.2f}"
              + ("  [virtual mesh: not a performance number]"
                 if virtual else ""))

    if len(results) > 1 and not virtual:
        base = results[0]["nnz_per_s"]
        for r in results[1:]:
            r["scaling_efficiency"] = round(
                r["nnz_per_s"] / (base * r["devices"]), 3)
    print(json.dumps({"virtual": virtual, "k": k, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
