"""Command-line driver — the equivalent of the reference's BSMR-sddmm
executable (src/main.cu + src/sddmm.cu).

Flags mirror the reference's (include/Options.hpp:52-69): ``-f`` matrix
file, ``-k`` K, ``-a`` alpha, ``-d`` delta, ``-t`` test mode, ``-l`` log
directory, plus long-form options of this implementation.  Test mode sweeps
alpha x delta x K reusing one row reordering per alpha (reference
src/sddmm.cu:62-118) and writes ``BSMR_k_{K}_a_{alpha}_d_{delta}.log``
files that scripts/analyze_results.py can aggregate.

Usage:
    python -m bsmr_sddmm.cli -f matrix.mtx -k 128
    python -m bsmr_sddmm.cli -f matrix.mtx -t 1 -l results/
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

from bsmr_sddmm import config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bsmr_sddmm",
        description="BSMR SDDMM (hybrid dense-block + residual) in JAX")
    p.add_argument("file_pos", nargs="?", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("k_pos", nargs="?", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("-f", "--file", default=None, help="matrix file "
                   "(.mtx/.smtx/.txt)")
    p.add_argument("-k", type=int, default=config.DEFAULT_K,
                   help="dense feature dim K")
    p.add_argument("-a", "--alpha", type=float, default=config.DEFAULT_ALPHA,
                   help="row-similarity threshold")
    p.add_argument("-d", "--delta", type=float, default=config.DEFAULT_DELTA,
                   help="block density threshold")
    p.add_argument("-t", "--test-mode", type=int, default=0,
                   help="1 = alpha/delta/K sweep")
    p.add_argument("-l", "--log-dir", default=None,
                   help="directory for log files")
    p.add_argument("-i", "--iterations", type=int,
                   default=config.DEFAULT_NUM_ITERATIONS)
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "tf32", "mixed", "float16", "bfloat16"])
    p.add_argument("--method", default="auto",
                   choices=["auto", "greedy", "batched", "none"],
                   help="row clustering algorithm")
    p.add_argument("--order", default="packed", choices=["packed", "csr"],
                   help="output layout timed/produced")
    p.add_argument("--validate", action="store_true",
                   help="check against the CPU golden model")
    p.add_argument("--tune", action="store_true",
                   help="autotune the configuration — strategy (hybrid "
                        "packed vs dense tiling), alpha, delta, G, C — "
                        "instead of the fixed -a/-d; measures candidates "
                        "on the device when an accelerator is present")
    return p


def run_once(csr, k, alpha, delta, args, input_file):
    """One full pipeline run; returns the RunLog."""
    from bsmr_sddmm.data import generate
    from bsmr_sddmm.ops.hybrid import HybridSDDMM
    from bsmr_sddmm.reorder.bsmr import BSMR, original_matrix_block_stats
    from bsmr_sddmm.reorder.pack import pack
    from bsmr_sddmm.utils.logger import RunLog
    from bsmr_sddmm.utils.timing import Timer

    bsmr = BSMR(alpha, delta, csr, method=args.method)
    with Timer() as t_pack:
        packed = pack(csr, bsmr)
    runner = HybridSDDMM(packed, compute_dtype=args.compute_dtype)

    a = generate.make_dense(csr.m, k, seed=1)
    b = generate.make_dense(k, csr.n, seed=2)
    a_pad, bt_pad = runner.prepare_operands(a, b=b)
    ms = runner.measure_kernel_ms(a_pad, bt_pad,
                                  iterations=max(args.iterations, 10),
                                  order=args.order)

    log = RunLog(input_file=str(input_file), k=k, alpha=alpha, delta=delta,
                 num_iterations=args.iterations,
                 matrix_a_type=args.compute_dtype,
                 matrix_b_type=args.compute_dtype,
                 num_row_panels=bsmr.num_row_panels,
                 num_clusters=bsmr.num_clusters,
                 num_dense_block=packed.num_blocks,
                 average_density=packed.average_block_density,
                 row_reordering_ms=bsmr.row_reordering_ms,
                 col_reordering_ms=bsmr.col_reordering_ms,
                 packing_ms=t_pack.ms,
                 dense_grid=(packed.num_super, packed.num_quads,
                             packed.num_pairs, packed.num_groups),
                 sparse_grid=(packed.nnz_res, 0, 0),
                 num_dense_data=packed.nnz_dense,
                 num_sparse_data=packed.nnz_res,
                 sddmm_time_ms=ms)
    log.tile_k = k
    log.set_matrix(csr)
    ob, od = original_matrix_block_stats(csr, delta)
    log.original_num_dense_block = ob
    log.original_average_density = od

    if args.validate:
        from bsmr_sddmm.ops.reference import sddmm_reference
        from bsmr_sddmm.utils.check import check_values
        got = np.asarray(runner(a, b, order="csr"))
        res = check_values(sddmm_reference(a, b, csr), got)
        log.error_rate = res.error_rate
        log.check_passed = res.passed
        print(str(res), file=sys.stderr)
    return log


def run_tuned(csr, k, args, input_file):
    """Autotuned pipeline run: the cost model + optional on-device
    shootout pick the strategy and configuration (reorder/autotune.py);
    the dense-tiling class (ops/dense.py) competes at DLMC densities."""
    import jax

    from bsmr_sddmm.data import generate
    from bsmr_sddmm.reorder.autotune import autotune
    from bsmr_sddmm.utils.logger import RunLog
    from bsmr_sddmm.utils.timing import Timer

    on_device = jax.devices()[0].platform == "gpu"
    with Timer() as t_tune:
        tuned = autotune(csr, k=k, compute_dtype=args.compute_dtype,
                         method=args.method, measure=on_device)
    a = generate.make_dense(csr.m, k, seed=1)
    b = generate.make_dense(k, csr.n, seed=2)
    if tuned.dense:
        from bsmr_sddmm.ops.dense import DenseSDDMM
        runner = DenseSDDMM.from_csr(csr,
                                     compute_dtype=args.compute_dtype)
    else:
        from bsmr_sddmm.ops.hybrid import HybridSDDMM
        runner = HybridSDDMM(tuned.packed,
                             compute_dtype=args.compute_dtype,
                             k_chunks=tuned.k_chunks,
                             a_layout=tuned.a_layout)
    a_pad, bt_pad = runner.prepare_operands(a, b=b)
    ms = runner.measure_kernel_ms(a_pad, bt_pad,
                                  iterations=max(args.iterations, 10),
                                  order=args.order)
    log = RunLog(input_file=str(input_file), k=k,
                 alpha=tuned.alpha, delta=tuned.delta,
                 num_iterations=args.iterations,
                 matrix_a_type=args.compute_dtype,
                 matrix_b_type=args.compute_dtype,
                 packing_ms=t_tune.ms,
                 sddmm_time_ms=ms)
    log.tile_k = k
    log.set_matrix(csr)
    if tuned.bsmr is not None:
        log.num_row_panels = tuned.bsmr.num_row_panels
        log.num_clusters = tuned.bsmr.num_clusters
        log.row_reordering_ms = tuned.bsmr.row_reordering_ms
        log.col_reordering_ms = tuned.bsmr.col_reordering_ms
    if tuned.packed is not None:
        log.num_dense_block = tuned.packed.num_blocks
        log.average_density = tuned.packed.average_block_density
        log.dense_grid = (tuned.packed.num_super, tuned.packed.num_quads,
                          tuned.packed.num_pairs, tuned.packed.num_groups)
        log.sparse_grid = (tuned.packed.nnz_res, 0, 0)
        log.num_dense_data = tuned.packed.nnz_dense
        log.num_sparse_data = tuned.packed.nnz_res
    print(f"[tuned strategy : {'dense' if tuned.dense else 'hybrid'}] "
          f"[a={tuned.alpha} d={tuned.delta} G={tuned.group_size} "
          f"C={tuned.k_chunks} H={tuned.hub_cols} "
          f"aL={tuned.a_layout}]",
          file=sys.stderr)
    if args.validate:
        from bsmr_sddmm.ops.reference import sddmm_reference
        from bsmr_sddmm.utils.check import check_values
        got = np.asarray(runner(a, b, order="csr"))
        res = check_values(sddmm_reference(a, b, csr), got)
        log.error_rate = res.error_rate
        log.check_passed = res.passed
        print(str(res), file=sys.stderr)
    return log


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # Positional fallback: argv[1]=file [argv[2]=K] (reference
    # include/Options.hpp:120-123).
    parser = build_parser()
    if args.file is None:
        if args.file_pos is None:
            parser.error("matrix file required (-f or positional)")
        args.file = args.file_pos
        if args.k_pos is not None:
            try:
                args.k = int(args.k_pos)
            except ValueError:
                parser.error(f"positional K must be an integer, got "
                             f"{args.k_pos!r}")
    elif args.file_pos is not None:
        parser.error("cannot mix -f with positional arguments")
    from bsmr_sddmm.data import io
    from bsmr_sddmm.utils.util import to_trimmed_string

    csr = io.load(args.file)
    log_dir = Path(args.log_dir) if args.log_dir else None
    if log_dir:
        log_dir.mkdir(parents=True, exist_ok=True)

    if not args.test_mode:
        if args.tune:
            log = run_tuned(csr, args.k, args, args.file)
        else:
            log = run_once(csr, args.k, args.alpha, args.delta, args,
                           args.file)
        text = log.print_log(sys.stdout)
        if log_dir:
            (log_dir / f"BSMR_k_{args.k}.log").write_text(text)
        return 0

    # Test mode: alpha x delta x K sweep, reusing the row reordering per
    # alpha (reference src/sddmm.cu:64-89 reuses bsmr.rowReordering).
    from bsmr_sddmm.reorder.bsmr import BSMR
    alphas = [0.1, 0.3, 0.5, 0.7, 0.9]
    deltas = [0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.1]
    ks = [32, 64, 128, 256]
    for alpha in alphas:
        shared = BSMR(alpha, 0.0, csr, method=args.method, compute=False)
        shared.run_row_reordering(csr)
        for delta in deltas:
            for k in ks:
                log = _run_sweep_cell(csr, shared, k, alpha, delta, args)
                name = (f"BSMR_k_{k}_a_{to_trimmed_string(alpha)}"
                        f"_d_{to_trimmed_string(delta)}.log")
                text = log.print_log()
                if log_dir:
                    with open(log_dir / name, "a") as f:
                        f.write(text)
                else:
                    sys.stdout.write(f"=== {name} ===\n{text}")
    return 0


def _run_sweep_cell(csr, shared_bsmr, k, alpha, delta, args):
    """One sweep cell reusing the shared row reordering."""
    import copy

    from bsmr_sddmm.data import generate
    from bsmr_sddmm.ops.hybrid import HybridSDDMM
    from bsmr_sddmm.reorder.pack import pack
    from bsmr_sddmm.utils.logger import RunLog
    from bsmr_sddmm.utils.timing import Timer

    bsmr = copy.copy(shared_bsmr)
    bsmr.run_col_reordering(csr, delta=delta)
    with Timer() as t_pack:
        packed = pack(csr, bsmr)
    runner = HybridSDDMM(packed, compute_dtype=args.compute_dtype)
    a = generate.make_dense(csr.m, k, seed=1)
    b = generate.make_dense(k, csr.n, seed=2)
    a_pad, bt_pad = runner.prepare_operands(a, b=b)
    ms = runner.measure_kernel_ms(a_pad, bt_pad,
                                  iterations=max(args.iterations, 10),
                                  order=args.order)
    log = RunLog(input_file=str(args.file), k=k, alpha=alpha, delta=delta,
                 num_iterations=args.iterations,
                 num_row_panels=bsmr.num_row_panels,
                 num_clusters=bsmr.num_clusters,
                 num_dense_block=packed.num_blocks,
                 average_density=packed.average_block_density,
                 row_reordering_ms=bsmr.row_reordering_ms,
                 col_reordering_ms=bsmr.col_reordering_ms,
                 packing_ms=t_pack.ms,
                 dense_grid=(packed.num_super, packed.num_quads,
                             packed.num_pairs, packed.num_groups),
                 sparse_grid=(packed.nnz_res, 0, 0),
                 num_dense_data=packed.nnz_dense,
                 num_sparse_data=packed.nnz_res,
                 sddmm_time_ms=ms)
    log.tile_k = k
    log.set_matrix(csr)
    return log


if __name__ == "__main__":
    sys.exit(main())
