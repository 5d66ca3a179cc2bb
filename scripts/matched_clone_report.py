#!/usr/bin/env python
"""Per-matrix reference-vs-framework table for the matched clones.

Joins the clone manifest (make_matched_clones.py — carries each named
SuiteSparse matrix's reference BSMR GFLOPS from
/root/reference/scripts/results_suiteSparse_dataset/k128/results_128.csv)
with the run_baselines.py logs measured on this framework, and writes
results/matched_clones_r5.csv:

  name, class, m, n, nnz_ref, nnz_clone, ref_bsmr_gflops_4090,
  bsmr_gflops, csr_gflops, ratio_vs_ref

Usage:
    python scripts/matched_clone_report.py /tmp/matched_clones \
        results/matched_clone_logs --k 128 -o results/matched_clones_r5.csv
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse_log(path: Path) -> dict:
    from bsmr_sddmm.utils.logger import parse_log as _parse
    return _parse(path.read_text(),
                  prefer_nonzero=("bsmr_gflops", "csr_gflops"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("clone_dir", type=Path)
    p.add_argument("log_dir", type=Path)
    p.add_argument("--k", type=int, default=128)
    p.add_argument("-o", "--output", type=Path,
                   default=Path("results/matched_clones_r5.csv"))
    args = p.parse_args(argv)

    manifest = json.loads(
        (args.clone_dir / "manifest.json").read_text())
    rows = []
    import numpy as np
    for clone, rec in sorted(manifest.items()):
        log = args.log_dir / f"{clone}_k{args.k}.log"
        if not log.exists():
            print(f"{clone}: no log yet, skipping")
            continue
        fields = parse_log(log)
        bsmr = float(fields.get("bsmr_gflops", 0.0))
        csrg = float(fields.get("csr_gflops", 0.0))
        rows.append({
            "name": clone.replace("clone_", ""),
            "class": rec["clone_class"], "m": rec["m"], "n": rec["n"],
            "nnz_ref": rec["nnz"], "nnz_clone": rec["clone_nnz"],
            "ref_bsmr_gflops_4090": rec["ref_bsmr_gflops"],
            "bsmr_gflops": round(bsmr, 1),
            "csr_gflops": round(csrg, 1),
            "ratio_vs_ref": round(bsmr / rec["ref_bsmr_gflops"], 3)
            if rec["ref_bsmr_gflops"] else None,
        })
    if not rows:
        print("no completed clone logs")
        return 1
    args.output.parent.mkdir(parents=True, exist_ok=True)
    cols = list(rows[0])
    with args.output.open("w") as f:
        f.write(",".join(cols) + "\n")
        for r in rows:
            f.write(",".join(str(r[c]) for c in cols) + "\n")
    gm = float(np.exp(np.mean(np.log(
        [max(r["bsmr_gflops"], 1e-9) for r in rows]))))
    gmr = float(np.exp(np.mean(np.log(
        [max(r["ratio_vs_ref"], 1e-9) for r in rows
         if r["ratio_vs_ref"]]))))
    print(f"wrote {args.output} ({len(rows)} clones); "
          f"geomean bsmr={gm:.0f} GFLOPS, "
          f"geomean ratio vs named-reference cells={gmr:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
