#!/usr/bin/env python
"""Cross-implementation comparison runner — the reference's
run_baseline.sh analogue.  Where the reference benchmarks 8 vendored CUDA
baselines (cuSPARSE, cuSDDMM, ASpT, RoDe, Sputnik, TCGNN, FlashSparse,
BSA), this framework ships three independent SDDMM implementations:

- ``csr``    — pure-JAX per-nnz gather-dot (the cuSPARSE-equivalent
               correctness baseline, ops/csr_sddmm.py)
- ``dense``  — full matmul product + nnz gather (ops/dense.py)
- ``bsmr``   — the autotuned hybrid (ops/hybrid.py)

Each run appends ``<tool>_gflops`` fields into one ``[key : value]`` log
per matrix, the same schema analyze_results.py / plot_results.py consume,
and cross-checks every tool against the CPU golden model (the reference's
checkData contract).

Usage:
    python scripts/run_baselines.py MATRIX_DIR LOG_DIR [--ks 32 128]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("matrix_dir", type=Path)
    p.add_argument("log_dir", type=Path)
    p.add_argument("--ks", type=int, nargs="+", default=[32, 128])
    p.add_argument("--compute-dtype", default="tf32")
    p.add_argument("--tools", nargs="+",
                   default=["csr", "dense", "bsmr"],
                   help="subset of: csr dense bsmr bsmr_dense_only "
                   "bsmr_residual_only")
    p.add_argument("--validate", action="store_true")
    p.add_argument("--alphas", type=float, nargs="+",
                   default=[0.1, 0.3, 0.5])
    p.add_argument("--deltas", type=float, nargs="+",
                   default=[0.0, 0.05, 0.3])
    p.add_argument("--merged-only", action="store_true",
                   help="only consider merge_superpanels=True packings "
                   "(halves host-side tuning cost)")
    p.add_argument("--measure", action="store_true",
                   help="on-device shootout between the cost model's top "
                   "candidates per K (slower; bench.py methodology)")
    p.add_argument("--resume", action="store_true",
                   help="skip (matrix, K) cells whose log already has "
                   "every requested tool (crash recovery)")
    args = p.parse_args(argv)

    from bsmr_sddmm.utils.cache import enable_persistent_cache
    enable_persistent_cache()

    import numpy as np

    import jax
    import jax.numpy as jnp

    from bsmr_sddmm.utils.timing import measure_loop_ms

    from bsmr_sddmm.data import generate, io
    from bsmr_sddmm.ops.csr_sddmm import csr_sddmm_jax
    from bsmr_sddmm.ops.dense import dense_masked_sddmm
    from bsmr_sddmm.ops.hybrid import HybridSDDMM
    from bsmr_sddmm.ops.reference import sddmm_reference
    from bsmr_sddmm.utils.check import check_values
    from bsmr_sddmm.utils.logger import RunLog

    args.log_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(q for suf in ("*.mtx", "*.smtx") for q in
                   args.matrix_dir.glob(suf))
    if not files:
        print(f"no matrices under {args.matrix_dir}", file=sys.stderr)
        return 1

    from bsmr_sddmm.reorder.autotune import autotune_multi

    def cell_done(path, k):
        out = args.log_dir / f"{path.stem}_k{k}.log"
        if not out.exists():
            return False
        text = out.read_text()
        return all(f"[{t}_gflops : " in text or f"[{t}_check" in text
                   or (t == "bsmr" and "[bsmr_sddmm : " in text
                       and "[bsmr_sddmm : 0.0]" not in text)
                   for t in args.tools)

    written: set = set()  # logs first-written by this invocation
    for path in files:
        if args.resume and all(cell_done(path, k) for k in args.ks):
            print(f"{path.stem}: all Ks done, skipping")
            continue
        csr = io.load(path)
        tuned_by_k = (autotune_multi(
            csr, args.ks, alphas=tuple(args.alphas),
            deltas=tuple(args.deltas),
            merges=(True,) if args.merged_only else (False, True),
            compute_dtype=args.compute_dtype,
            measure=args.measure, measure_top=1,
            measure_iterations=20)
                      if "bsmr" in args.tools else {})
        for k in args.ks:
            if args.resume and cell_done(path, k):
                print(f"{path.stem} K={k}: done, skipping")
                continue
            a = generate.make_dense(csr.m, k, seed=1)
            b = generate.make_dense(k, csr.n, seed=2)
            log = RunLog(input_file=str(path), k=k, tile_k=k)
            log.set_matrix(csr)
            golden = sddmm_reference(a, b, csr) if args.validate else None
            extra = {}

            a_d = jnp.asarray(a)
            bt_d = jnp.asarray(np.ascontiguousarray(b.T))

            if "csr" in args.tools:
                rows_d = jnp.asarray(csr.row_indices(), dtype=jnp.int32)
                cols_d = jnp.asarray(csr.col_idx, dtype=jnp.int32)

                def body_csr(c, a_d, bt_d, rows_d, cols_d):
                    r2 = jnp.where(c > jnp.float32(-1e30), rows_d, 0)
                    return csr_sddmm_jax(a_d, bt_d, r2, cols_d)

                dt = measure_loop_ms(body_csr, (a_d, bt_d, rows_d, cols_d)) / 1e3
                extra["csr_gflops"] = 2 * csr.nnz * k / dt / 1e9
                if golden is not None:
                    res = check_values(golden, np.asarray(
                        csr_sddmm_jax(a_d, bt_d, rows_d, cols_d)))
                    extra["csr_check"] = "PASS" if res.passed else "FAIL"

            if "dense" in args.tools:
                from bsmr_sddmm.ops.dense import _dense_masked_jit
                rows_i = jnp.asarray(csr.row_indices(), dtype=jnp.int32)
                cols_i = jnp.asarray(csr.col_idx, dtype=jnp.int32)
                b_d = jnp.asarray(b)

                def body_dense(c, a_d, b_d, rows_i, cols_i):
                    a2 = jnp.where(c > jnp.float32(-1e30), a_d,
                                   jnp.zeros_like(a_d))
                    return _dense_masked_jit(
                        a2, b_d, rows_i, cols_i,
                        compute_dtype=args.compute_dtype)

                dt = measure_loop_ms(body_dense, (a_d, b_d, rows_i, cols_i)) / 1e3
                extra["dense_gflops"] = 2 * csr.nnz * k / dt / 1e9
                if golden is not None:
                    res = check_values(golden, dense_masked_sddmm(
                        a, b, csr, compute_dtype=args.compute_dtype))
                    extra["dense_check"] = "PASS" if res.passed else "FAIL"

            # Single-path ablations: the reference's hybrid comparison
            # (results_hybrid CSV, analyze_results.cpp:1127-1134).
            # delta=0.0 packs every occupied block dense (tensor-path
            # only); delta=1.1 routes everything to the residual
            # (vector-path only).
            for tool, dlt in (("bsmr_dense_only", 0.0),
                              ("bsmr_residual_only", 1.1)):
                if tool not in args.tools:
                    continue
                from bsmr_sddmm.reorder.bsmr import BSMR
                from bsmr_sddmm.reorder.pack import pack
                bs = BSMR(0.3, dlt, csr)
                pk = pack(csr, bs, compute_dtype=args.compute_dtype)
                rn = HybridSDDMM(pk, compute_dtype=args.compute_dtype)
                ap, bp = rn.prepare_operands(a, b=b)
                ms = rn.measure_kernel_ms(ap, bp, iterations=20)
                extra[f"{tool}_gflops"] = 2 * csr.nnz * k / ms / 1e6
                if golden is not None:
                    res = check_values(golden,
                                       np.asarray(rn(a, b, order="csr")))
                    extra[f"{tool}_check"] = ("PASS" if res.passed
                                              else "FAIL")

            if "bsmr" in args.tools:
                tuned = tuned_by_k[k]
                if getattr(tuned, "dense", False):
                    # autotuner picked the dense-tiling strategy (the
                    # DLMC density class; ops/dense.DenseSDDMM)
                    from bsmr_sddmm.ops.dense import DenseSDDMM
                    runner = DenseSDDMM.from_csr(
                        csr, compute_dtype=args.compute_dtype)
                    extra["bsmr_strategy"] = "dense"
                else:
                    runner = HybridSDDMM(tuned.packed,
                                         compute_dtype=args.compute_dtype,
                                         k_chunks=tuned.k_chunks,
                                         a_layout=tuned.a_layout)
                a_pad, bt_phys = runner.prepare_operands(a, b=b)
                ms = runner.measure_kernel_ms(a_pad, bt_phys,
                                              iterations=20)
                # timing jitter can produce a degenerate (too small)
                # loop difference; anything implying > 10 TFLOPS on the
                # HBM-bound hybrid op is implausible — re-measure with a
                # much longer loop (the difference then dwarfs the
                # jitter) and keep the conservative (slower) reading.
                # The matmul-bound dense strategy legitimately exceeds
                # 10 nnz-TFLOPS at DLMC density, so it is exempt.
                if (extra.get("bsmr_strategy") != "dense"
                        and 2 * csr.nnz * k / ms / 1e6 > 10000):
                    ms = max(ms, runner.measure_kernel_ms(
                        a_pad, bt_phys, iterations=200, repeats=5))
                log.sddmm_time_ms = ms
                # apples-to-apples with the reference's output
                # convention (kernels write matrixP[csrIdx] directly):
                # time including the packed->CSR-order delivery
                ms_csr = runner.measure_kernel_ms(
                    a_pad, bt_phys, iterations=10, order="csr")
                extra["bsmr_csr_order_gflops"] = \
                    2 * csr.nnz * k / ms_csr / 1e6
                if tuned.bsmr is not None:
                    log.num_clusters = tuned.bsmr.num_clusters
                    log.row_reordering_ms = tuned.bsmr.row_reordering_ms
                    log.col_reordering_ms = tuned.bsmr.col_reordering_ms
                if tuned.packed is not None:
                    log.num_dense_block = tuned.packed.num_blocks
                    log.average_density = \
                        tuned.packed.average_block_density
                if golden is not None:
                    res = check_values(
                        golden, np.asarray(runner(a, b, order="csr")))
                    extra["bsmr_check"] = "PASS" if res.passed else "FAIL"

            out = args.log_dir / f"{path.stem}_k{k}.log"
            text = log.print_log()
            for key, val in extra.items():
                text += f"[{key} : {val}]\n"
            # Append so separate tool passes over the same matrix/K merge
            # (analyze_results.collect); without --resume, the first
            # write of this invocation truncates any stale log so
            # re-runs don't grow files unboundedly.
            mode = "a" if (args.resume or out in written) else "w"
            written.add(out)
            with open(out, mode) as fh:
                fh.write(text)
            summary = " ".join(f"{t}={extra.get(t + '_gflops', 0):.0f}"
                               for t in ("csr", "dense")
                               if t in args.tools)
            print(f"{path.stem} K={k}: bsmr={log.gflops:.0f} {summary} "
                  f"GFLOPS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
