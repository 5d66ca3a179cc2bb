#!/usr/bin/env python3
"""Fold probe winners (``results/probe_*.log``) into tuned_configs.json,
so a measure -> fold -> validate chain needs no hand edits.

Steps:
 1. For each (probe log, matrix, K) in FOLDS: parse the ``winner:`` line
    (grammar from scripts/update_tuned_configs.py) and stage the new
    committed config.  Logs that are missing or have no winner line are
    skipped with a note — a failed probe must never lose the committed
    config.
 2. Dense-vs-hybrid arbitration for the true-DLMC bench matrix at every
    K: compare ``plain dot`` (the DenseSDDMM timing class — bench's
    (M,N)-native layout, see ops/dense.py) against the best hybrid
    candidate (the ``hybrid:`` line of probe_dense_dlmc_* plus the
    probe_dlmc_k* winner when present).  Dense must win by >5% to
    displace the hybrid entry.
 3. --validate: every staged hybrid change is re-run through
    probe_configs WITHOUT --skip-check (1 round, few iterations) and
    reverted if the tolerance contract fails; a staged dense entry is
    checked directly against ops/reference.sddmm_reference.

Usage (from the queue): python scripts/r3_autofold.py --validate
Dry run:                python scripts/r3_autofold.py --dry-run
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import update_tuned_configs as utc  # winner_of / parse_tag / CONFIGS

R = ROOT / "results"

# (log, matrix, K, mode) — mode "full" replaces the committed config
# with the parsed winner tag (every probe's candidate set includes the
# exact committed config, so a no-better outcome folds to a no-op);
# mode "apanels-only" merely toggles a_layout on the existing committed
# config (safety valve for probes whose candidates don't include it).
FOLDS = [
    ("probe_apanels_clustered16_r3.log", "clustered16", 128, "full"),
    ("probe_apanels_banded_r3.log", "banded", 128, "full"),
    ("probe_apanels_clustered128_r3.log", "clustered128", 128, "full"),
    ("probe_apanels_powerlaw_r3.log", "powerlaw", 128, "full"),
    ("probe_k256_clustered16_r3.log", "clustered16", 256, "full"),
    ("probe_k256_clustered128_r3.log", "clustered128", 256, "full"),
    ("probe_k256_banded_r3.log", "banded", 256, "full"),
    ("probe_k256_powerlaw_r3.log", "powerlaw", 256, "full"),
    ("probe_k64_clustered16_r3.log", "clustered16", 64, "full"),
    ("probe_k64_banded_r3.log", "banded", 64, "full"),
    ("probe_k64_clustered128_r3.log", "clustered128", 64, "full"),
    ("probe_k64_powerlaw_r3.log", "powerlaw", 64, "full"),
    ("probe_dlmc_k128_r3.log", "dlmc", 128, "full"),
    ("probe_dlmc_k256_r3.log", "dlmc", 256, "full"),
    ("probe_k32_apanels_r3.log", "clustered16", 32, "full"),
]

DENSE_LOGS = {
    32: "probe_dense_dlmc_k32_r3.log",
    64: "probe_dense_dlmc_k64_r3.log",
    128: "probe_dense_dlmc_r3.log",
    256: "probe_dense_dlmc_k256_r3.log",
}


def cfg_to_spec(cfg: dict) -> str:
    """Committed-config dict -> probe_configs spec string."""
    parts = [f"a={cfg['alpha']}", f"d={cfg['delta']}",
             f"g={cfg.get('g', 1)}", f"c={cfg.get('c', 1)}"]
    if cfg.get("hub"):
        parts.append(f"hub={cfg['hub']}")
    if cfg.get("a_layout") == "panels":
        parts.append("apanels=1")
    if cfg.get("window_dp") is False:
        parts.append("windowdp=0")
    if cfg.get("merge") is False:
        parts.append("merge=0")
    return ",".join(parts)


def try_winner(log: Path):
    if not log.exists():
        print(f"  skip {log.name}: missing")
        return None
    try:
        return utc.winner_of(log)
    except ValueError as e:
        print(f"  skip {log.name}: {e}")
        return None


_MS = r"([\d.]+) ms"


def dense_decision(k: int, data: dict) -> bool:
    """True if the dense-tiling strategy should own (dlmc, K)."""
    log = R / DENSE_LOGS[k]
    if not log.exists():
        print(f"  dense k{k}: no log, keep hybrid")
        return False
    text = log.read_text()
    m_d = re.search(r"plain dot: " + _MS, text)
    m_h = re.search(r"hybrid: nS=\d+ res=\d+ " + _MS, text)
    if not (m_d and m_h):
        print(f"  dense k{k}: unparseable log, keep hybrid")
        return False
    dense_ms, hybrid_ms = float(m_d.group(1)), float(m_h.group(1))
    # the interleaved dlmc shootout (if it ran) may have found a faster
    # hybrid than the a=0.3/d=0.05 one probe_dense_dlmc measures
    for fold_log, mat, kk, _ in FOLDS:
        if mat == "dlmc" and kk == k and (R / fold_log).exists():
            mw = None
            for line in (R / fold_log).read_text().splitlines():
                m = re.match(r"winner: \[.+\] " + _MS, line)
                if m:
                    mw = float(m.group(1))
            if mw is not None:
                hybrid_ms = min(hybrid_ms, mw)
    win = dense_ms < 0.95 * hybrid_ms
    print(f"  dense k{k}: dense {dense_ms:.4f} ms vs hybrid "
          f"{hybrid_ms:.4f} ms -> {'DENSE' if win else 'hybrid'}")
    return win


def validate_hybrid(matrix: str, k: int, cfg: dict) -> bool:
    """Run the staged config once with the golden check on."""
    spec = cfg_to_spec(cfg)
    print(f"  validate {matrix} k{k}: {spec}")
    try:
        out = subprocess.run(
            [sys.executable, str(ROOT / "scripts/probe_configs.py"),
             "--matrix", matrix, "--k", str(k), "--rounds", "1",
             "--iterations", "5", "--configs", spec],
            capture_output=True, text=True, timeout=1800)
    except subprocess.TimeoutExpired:
        print("    TIMEOUT -> revert")
        return False
    ok = "contract PASS" in out.stdout
    if not ok:
        tail = "\n".join(out.stdout.splitlines()[-5:])
        print(f"    contract FAIL/absent -> revert\n{tail}\n{out.stderr[-400:]}")
    else:
        print("    contract PASS")
    return ok


def validate_dense(k: int) -> bool:
    """Direct numeric check of DenseSDDMM on the bench dlmc matrix."""
    print(f"  validate dense dlmc k{k}")
    import numpy as np
    import bench
    from bsmr_sddmm.data import generate
    from bsmr_sddmm.ops.dense import DenseSDDMM
    from bsmr_sddmm.ops.reference import sddmm_reference
    from bsmr_sddmm.utils.check import check_values
    csr = bench.suite(False)["dlmc"]()
    a = generate.make_dense(csr.m, k, seed=1)
    b = generate.make_dense(k, csr.n, seed=2)
    runner = DenseSDDMM.from_csr(csr)
    res = check_values(sddmm_reference(a, b, csr),
                       np.asarray(runner(a, b=b, order="csr")))
    print(f"    contract {'PASS' if res.passed else 'FAIL'} "
          f"max_rel={res.max_rel_err:.2e}")
    return bool(res.passed)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--validate", action="store_true",
                   help="re-check staged changes on device; revert FAILs")
    args = p.parse_args(argv)

    data = json.loads(utc.CONFIGS.read_text())
    staged = []  # (key, matrix, old, new, kind)

    # Dense arbitration FIRST: its verdict must gate the hybrid folds.
    # (Round-4 bug: the hybrid probes can't represent a committed
    # {"dense": true} entry, so folding their winner silently displaced
    # the already-validated dense strategy at k128/k256 — and the dense
    # stage, comparing old != new against the pre-fold file, staged
    # nothing to restore it.)
    print("== dense-vs-hybrid arbitration (dlmc) ==")
    dense_owner = {k: dense_decision(k, data) for k in (32, 64, 128, 256)}

    print("== folding probe winners ==")
    for log_name, matrix, k, mode in FOLDS:
        if matrix == "dlmc" and dense_owner.get(k):
            print(f"  k{k}/dlmc: dense strategy owns this cell, "
                  "skipping hybrid fold")
            continue
        tag = try_winner(R / log_name)
        if tag is None:
            continue
        key = f"k{k}"
        old = data.get(key, {}).get(matrix)
        if mode == "apanels-only":
            if old is None:
                continue
            new = dict(old)
            if " apanels" in tag:
                new["a_layout"] = "panels"
            else:
                new.pop("a_layout", None)
        else:
            new = utc.parse_tag(tag)
        if new == old:
            print(f"  {key}/{matrix}: winner == committed, no change")
            continue
        print(f"  {key}/{matrix}: {old} -> {new}")
        staged.append((key, matrix, old, new, "hybrid"))

    for k in (32, 64, 128, 256):
        key = f"k{k}"
        old = data.get(key, {}).get("dlmc")
        if dense_owner.get(k):
            new = {"dense": True}
            if old != new:
                staged.append((key, "dlmc", old, new, "dense"))

    if args.dry_run:
        print(f"(dry run: {len(staged)} changes, not writing)")
        return 0

    # Validate-then-apply, writing after EVERY accepted entry: a kill
    # mid-run leaves only already-validated configs on disk (never an
    # unvalidated one), and a rerun re-derives the rest from the same
    # logs (folds are idempotent).
    if staged and args.validate:
        print("== validating staged changes on device ==")
    applied = 0
    dense_ok = {}
    for key, matrix, old, new, kind in staged:
        k = int(key[1:])
        ok = True
        if args.validate:
            if kind == "dense":
                if k not in dense_ok:
                    dense_ok[k] = validate_dense(k)
                ok = dense_ok[k]
            else:
                ok = validate_hybrid(matrix, k, new)
        if not ok:
            print(f"  SKIP {key}/{matrix} (validation failed), "
                  f"keeping {old}")
            continue
        data.setdefault(key, {})[matrix] = new
        utc.CONFIGS.write_text(json.dumps(data, indent=4) + "\n")
        applied += 1

    print(f"wrote {utc.CONFIGS} ({applied}/{len(staged)} staged "
          "changes applied)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
