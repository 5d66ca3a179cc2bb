#!/usr/bin/env python
"""Dataset fetch + filter — Python re-design of the reference's
scripts/download_suiteSparse_dataset.sh (477 lines of hard-coded ssget
URLs), download_matrix_from_suiteSparse.py, download_dlmc_dataset.sh and
exclude_invalid_dataset.py.

Subcommands:
    suitesparse NAMES... --out DIR     # fetch by Group/Name from sparse.tamu.edu
    dlmc --out DIR                     # fetch the DLMC pruned-transformer set
    filter DIR [--min-dim 10000] [--min-nnz 100000] [--move-to EXCLUDED]
    synth --out DIR                    # offline: regime-spanning synthetic suite

The filter mirrors exclude_invalid_dataset.py:46-49 (keep m,n >= 10000 and
nnz >= 100000); unlike the reference it moves rather than rewrites, and
``synth`` exists because zero-egress environments (like this project's CI)
cannot reach the archives — it writes the same four-regime suite bench.py
measures (fine blocks / coarse blocks / power-law / banded).
"""

from __future__ import annotations

import argparse
import sys
import tarfile
import urllib.request
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

def _extract(tgz: Path, out: Path):
    with tarfile.open(tgz) as tf:
        try:
            tf.extractall(out, filter="data")
        except TypeError:  # Python < 3.12 without the filter kwarg
            tf.extractall(out)


SUITESPARSE_URL = "https://sparse.tamu.edu/MM/{group}/{name}.tar.gz"
DLMC_URL = "https://storage.googleapis.com/sgk-sc2020/dlmc.tar.gz"


def fetch_suitesparse(names, out: Path):
    out.mkdir(parents=True, exist_ok=True)
    for full in names:
        group, _, name = full.partition("/")
        if not name:
            print(f"skip {full!r}: expected Group/Name", file=sys.stderr)
            continue
        url = SUITESPARSE_URL.format(group=group, name=name)
        tgz = out / f"{name}.tar.gz"
        print(f"fetching {url}")
        try:
            urllib.request.urlretrieve(url, tgz)
        except Exception as e:
            print(f"  FAILED ({e}); offline? use `synth` for a local "
                  f"suite", file=sys.stderr)
            continue
        _extract(tgz, out)
        tgz.unlink()


def fetch_dlmc(out: Path):
    out.mkdir(parents=True, exist_ok=True)
    tgz = out / "dlmc.tar.gz"
    print(f"fetching {DLMC_URL}")
    try:
        urllib.request.urlretrieve(DLMC_URL, tgz)
    except Exception as e:
        print(f"  FAILED ({e}); offline? use `synth`", file=sys.stderr)
        return
    _extract(tgz, out)
    tgz.unlink()


def filter_dir(root: Path, min_dim: int, min_nnz: int, move_to):
    """Keep matrices with m,n >= min_dim and nnz >= min_nnz (reference
    exclude_invalid_dataset.py:46-49)."""
    from bsmr_sddmm.data import io

    excluded = []
    for path in sorted(root.rglob("*")):
        if path.suffix not in (".mtx", ".smtx", ".txt"):
            continue
        try:
            csr = io.load(path)
            ok = csr.m >= min_dim and csr.n >= min_dim and \
                csr.nnz >= min_nnz
        except Exception as e:
            print(f"{path}: unreadable ({e}) -> excluded")
            ok = False
        if not ok:
            excluded.append(path)
    if move_to:
        dest = root / move_to
        dest.mkdir(exist_ok=True)
        for p in excluded:
            p.rename(dest / p.name)
        print(f"moved {len(excluded)} matrices to {dest}")
    else:
        for p in excluded:
            print(f"would exclude {p}")
    return excluded


def synth(out: Path):
    from bsmr_sddmm.data import generate, io

    out.mkdir(parents=True, exist_ok=True)
    suite = {
        "clustered16": generate.block_clustered(
            1024, 1024, block_prob=0.008, block_density=0.65,
            noise_density=0.00001, seed=42),
        "clustered128": generate.block_clustered(
            128, 128, group_rows=128, group_cols=128, block_prob=0.025,
            block_density=0.3, noise_density=0.00001, seed=43),
        "powerlaw": generate.powerlaw_graph(32768, avg_degree=40, seed=44),
        "banded": generate.banded(24576, 24576, bandwidth=45, fill=0.55,
                                  seed=45),
    }
    for name, csr in suite.items():
        io.save_mtx(out / f"{name}.mtx", csr)
        print(f"wrote {out / (name + '.mtx')} "
              f"({csr.m}x{csr.n}, nnz={csr.nnz})")


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("suitesparse")
    s.add_argument("names", nargs="+", help="Group/Name entries")
    s.add_argument("--out", type=Path, default=Path("dataset"))
    d = sub.add_parser("dlmc")
    d.add_argument("--out", type=Path, default=Path("dataset/dlmc"))
    f = sub.add_parser("filter")
    f.add_argument("dir", type=Path)
    f.add_argument("--min-dim", type=int, default=10000)
    f.add_argument("--min-nnz", type=int, default=100000)
    f.add_argument("--move-to", default=None)
    y = sub.add_parser("synth")
    y.add_argument("--out", type=Path, default=Path("dataset/synth"))
    args = p.parse_args(argv)
    if args.cmd == "suitesparse":
        fetch_suitesparse(args.names, args.out)
    elif args.cmd == "dlmc":
        fetch_dlmc(args.out)
    elif args.cmd == "filter":
        filter_dir(args.dir, args.min_dim, args.min_nnz, args.move_to)
    elif args.cmd == "synth":
        synth(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
