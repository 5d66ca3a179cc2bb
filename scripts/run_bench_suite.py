#!/usr/bin/env python
"""Run the full benchmark harness over a directory of matrix files.

Python re-design of the reference's scripts/test_script.sh + run_BSMR.sh:
loops every matrix file under a directory, runs the CLI pipeline at each
K, and writes the per-run logs that analyze_results.py aggregates.

Usage:
    python scripts/run_bench_suite.py MATRIX_DIR LOG_DIR [--ks 32 128] \
        [--sweep]   # --sweep = the full alpha/delta test mode
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
    p.add_argument("--ks", type=int, nargs="+", default=[32, 64, 128, 256])
    p.add_argument("--sweep", action="store_true",
                   help="full alpha x delta x K test mode per matrix")
    p.add_argument("--compute-dtype", default="float32")
    p.add_argument("--validate", action="store_true")
    args = p.parse_args(argv)

    from bsmr_sddmm import cli

    files = sorted(
        f for suffix in ("*.mtx", "*.smtx", "*.txt")
        for f in args.matrix_dir.rglob(suffix))
    if not files:
        print(f"no matrix files under {args.matrix_dir}", file=sys.stderr)
        return 1
    args.log_dir.mkdir(parents=True, exist_ok=True)

    for i, f in enumerate(files):
        print(f"[{i + 1}/{len(files)}] {f.name}", file=sys.stderr)
        t0 = time.perf_counter()
        sub = args.log_dir / f.stem
        if args.sweep:
            cli_args = ["-f", str(f), "-t", "1", "-l", str(sub)]
        else:
            cli_args = ["-f", str(f), "-l", str(sub)]
            for k in args.ks:
                cli.main(cli_args + ["-k", str(k),
                                     "--compute-dtype", args.compute_dtype]
                         + (["--validate"] if args.validate else []))
            print(f"   done in {time.perf_counter() - t0:.1f}s",
                  file=sys.stderr)
            continue
        cli.main(cli_args + ["--compute-dtype", args.compute_dtype])
        print(f"   done in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
