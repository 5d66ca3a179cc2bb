#!/usr/bin/env python3
"""Fold probe_configs winners back into results/tuned_configs.json.

Parses the ``winner: [tag]`` line of one or more probe_configs logs and
updates the committed per-(matrix, K) config that bench.py executes.
The tag grammar is what probe_configs prints:
``a=0.3 d=0.05 G=1 C=1 H=0 [apanels] [legacy-carve] [dtype]``.

Usage:
    python scripts/update_tuned_configs.py --matrix clustered16 --k 128 \
        results/probe_apanels_clustered16_r3.log
"""

import argparse
import json
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CONFIGS = Path(__file__).resolve().parent.parent / "results" / \
    "tuned_configs.json"


def parse_tag(tag: str) -> dict:
    m = re.match(r"a=([\d.]+) d=([\d.]+) G=(\d+) C=(\d+) H=(\d+)", tag)
    if not m:
        raise ValueError(f"unparseable winner tag: {tag!r}")
    cfg = {"alpha": float(m.group(1)), "delta": float(m.group(2)),
           "g": int(m.group(3)), "c": int(m.group(4)),
           "merge": True}
    hub = int(m.group(5))
    if hub:
        cfg["hub"] = hub
    if " apanels" in tag:
        cfg["a_layout"] = "panels"
    if " nomerge" in tag:
        cfg["merge"] = False
    if " legacy-carve" in tag:
        cfg["window_dp"] = False
    m = re.search(r" sort=(\w+)", tag)
    if m and m.group(1) != "cid":
        cfg["sort_runs"] = m.group(1)
    m = re.search(r" sortres=(\w+)", tag)
    if m and m.group(1) != "csr":
        cfg["sort_res"] = m.group(1)
    m = re.search(r" bscale=([\d.]+)", tag)
    if m and float(m.group(1)) != 1.0:
        cfg["b_cost_scale"] = float(m.group(1))
    m = re.search(r" rowslab=(\d+)", tag)
    if m and int(m.group(1)):
        cfg["rowslab"] = int(m.group(1))
    m = re.search(r" rowslabpre=(\d+)", tag)
    if m and int(m.group(1)):
        cfg["rowslab_pre"] = int(m.group(1))
    m = re.search(r" (float32|mixed|float16|bfloat16)$", tag)
    if m:
        cfg["dtype"] = m.group(1)
    return cfg


def winner_of(log_path: Path) -> str:
    tag = None
    for line in log_path.read_text().splitlines():
        m = re.match(r"winner: \[(.+)\] [\d.]+ ms", line)
        if m:
            tag = m.group(1)
    if tag is None:
        raise ValueError(f"no winner line in {log_path}")
    return tag


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("log", type=Path)
    p.add_argument("--matrix", required=True)
    p.add_argument("--k", type=int, required=True)
    p.add_argument("--dry-run", action="store_true")
    args = p.parse_args(argv)

    tag = winner_of(args.log)
    cfg = parse_tag(tag)
    data = json.loads(CONFIGS.read_text())
    key = f"k{args.k}"
    data.setdefault(key, {})
    old = data[key].get(args.matrix)
    data[key][args.matrix] = cfg
    print(f"{key}/{args.matrix}: {old} -> {cfg}")
    if not args.dry_run:
        CONFIGS.write_text(json.dumps(data, indent=4) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
