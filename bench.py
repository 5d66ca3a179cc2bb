"""Benchmark entry point: one JSON line with the headline metric.

Headline: geometric-mean hybrid BSMR SDDMM throughput (GFLOPS =
2*NNZ*K/time) at one K over a 5-matrix suite spanning the regimes the
reference's 503-matrix SuiteSparse suite covers (fine block structure,
coarse block structure, power-law graph, banded, DLMC density).

Runs on the GPU and fails when JAX finds none; ``--quick`` is an
explicit CPU smoke run at tiny sizes and says ``"platform": "cpu"``.
Every JSON line names the device it ran on.

Per-matrix configs come from the committed ``results/tuned_configs.json``
(the analogue of the reference's fixed Options defaults), so two runs of
``python bench.py`` execute the identical program; the kernel is timed
in ``--sessions`` independent loop-differenced sessions and the
**median** session is reported, with every session in the JSON and a
warning when their spread exceeds 15%.  ``--retune`` re-runs the
on-device autotune shootout instead (src/sddmm.cu:62-118 analogue).

``vs_baseline`` compares against the reference's published mean GFLOPS
over its SuiteSparse suite (RTX 4090, reference; BASELINE.md).
``per_matrix_csr_order`` reports the apples-to-apples number whose
kernel time *includes* delivering values in CSR entry order (the
reference's kernels write matrixP[csrIdx] directly,
src/sddmmKernel.cu:213-355); the headline stays packed-order — the
framework's native layout — with both visible.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

# RTX 4090, reference: the reference's means over its 503-matrix suite
# (BASELINE.md) — another card's numbers, kept for comparison
REFERENCE_MEAN_GFLOPS = {32: 2158.0, 64: 2966.0, 128: 3452.0, 256: 3460.0}

TUNED_CONFIGS = Path(__file__).resolve().parent / "results" / \
    "tuned_configs.json"


def suite(quick: bool):
    from bsmr_sddmm.data import generate
    if quick:
        return {
            "clustered16": lambda: generate.block_clustered(
                64, 64, block_prob=0.08, block_density=0.7,
                noise_density=0.0005, seed=42),
            "powerlaw": lambda: generate.powerlaw_graph(
                2048, avg_degree=16, seed=44),
        }
    return {
        "clustered16": lambda: generate.block_clustered(
            1024, 1024, block_prob=0.008, block_density=0.65,
            noise_density=0.00001, seed=42),
        "clustered128": lambda: generate.block_clustered(
            128, 128, group_rows=128, group_cols=128, block_prob=0.025,
            block_density=0.3, noise_density=0.00001, seed=43),
        "powerlaw": lambda: generate.powerlaw_graph(
            32768, avg_degree=40, seed=44),
        "banded": lambda: generate.banded(
            24576, 24576, bandwidth=45, fill=0.55, seed=45),
        # true DLMC density class (pruned-ML weights are 50-90% sparse,
        # density 0.1-0.5 — the reference's DLMC corpus); the suite's
        # older dlmc_like_* synthetics are hypersparse and mislabeled
        "dlmc": lambda: generate.random_sparse(
            4096, 4096, density=0.2, seed=46),
    }


def load_tuned_config(name: str, k: int):
    try:
        data = json.loads(TUNED_CONFIGS.read_text())
    except (OSError, json.JSONDecodeError):
        return None
    return data.get(f"k{k}", {}).get(name)


# committed-config schema: key -> required type(s).  "dense" entries
# carry only {"dense": true}.
_CFG_KEYS = {"alpha": float, "delta": float, "g": int, "c": int,
             "merge": bool, "hub": int,
             "a_layout": str, "window_dp": bool, "dense": bool,
             "dtype": str, "sort_runs": str, "sort_res": str,
             "b_cost_scale": float, "rowslab": int, "rowslab_pre": int}
_CFG_DTYPES = ("float32", "tf32", "mixed", "float16", "bfloat16")


def validate_tuned_configs() -> list:
    """Parse + schema-check every committed config.  Runs on EVERY bench
    invocation including ``--quick`` so the CPU smoke run catches a
    malformed entry (typo'd key, wrong type, unknown a_layout) before it
    crashes a long GPU run."""
    errors = []
    try:
        data = json.loads(TUNED_CONFIGS.read_text())
    except OSError:
        return errors  # no committed configs is a valid state
    except json.JSONDecodeError as e:
        return [f"tuned_configs.json: invalid JSON: {e}"]
    for kkey, per_matrix in data.items():
        if kkey.startswith("_"):
            continue
        if not (kkey.startswith("k") and kkey[1:].isdigit()):
            errors.append(f"tuned_configs.json: bad K key {kkey!r}")
            continue
        for name, cfg in per_matrix.items():
            where = f"tuned_configs.json[{kkey}][{name}]"
            if not isinstance(cfg, dict):
                errors.append(f"{where}: not an object")
                continue
            for key, val in cfg.items():
                want = _CFG_KEYS.get(key)
                if want is None:
                    errors.append(f"{where}: unknown key {key!r}")
                elif want is float:
                    if not isinstance(val, (int, float)):
                        errors.append(f"{where}.{key}: not a number")
                elif want is int:
                    if not isinstance(val, int) or isinstance(val, bool):
                        errors.append(f"{where}.{key}: not an int")
                elif not isinstance(val, want):
                    errors.append(f"{where}.{key}: expected "
                                  f"{want.__name__}")
            if cfg.get("dense"):
                extra = set(cfg) - {"dense"}
                if extra:
                    errors.append(f"{where}: dense entry with extra "
                                  f"keys {sorted(extra)}")
            else:
                for req in ("alpha", "delta"):
                    if req not in cfg:
                        errors.append(f"{where}: missing {req!r}")
                if cfg.get("a_layout", "rows") not in ("rows", "panels"):
                    errors.append(f"{where}.a_layout: "
                                  f"{cfg['a_layout']!r} not in "
                                  "('rows', 'panels')")
                if cfg.get("dtype", "tf32") not in _CFG_DTYPES:
                    errors.append(f"{where}.dtype: {cfg['dtype']!r} "
                                  f"not in {_CFG_DTYPES}")
                if cfg.get("sort_runs", "cid") not in ("cid", "gid"):
                    errors.append(f"{where}.sort_runs: "
                                  f"{cfg['sort_runs']!r} not in "
                                  "('cid', 'gid')")
                if cfg.get("sort_res", "csr") not in ("csr", "gid"):
                    errors.append(f"{where}.sort_res: "
                                  f"{cfg['sort_res']!r} not in "
                                  "('csr', 'gid')")
    return errors


def runner_of(csr, tuned, compute_dtype: str):
    """The runner for an autotune/from_params result: ``DenseSDDMM`` for
    the dense class, else a ``HybridSDDMM`` on the tuned packing."""
    from bsmr_sddmm.ops.dense import DenseSDDMM
    from bsmr_sddmm.ops.hybrid import HybridSDDMM
    if tuned.dense:
        return DenseSDDMM.from_csr(csr, compute_dtype=compute_dtype)
    return HybridSDDMM(tuned.packed, compute_dtype=compute_dtype,
                       k_chunks=tuned.k_chunks, a_layout=tuned.a_layout)


def build_runner(csr, k: int, cfg, compute_dtype: str = "tf32"):
    """The runner the bench measures for one (matrix, K) cell, from its
    committed config ``cfg`` (``None``: the est-only autotune pick).

    Returns ``(runner, tuned, cdt)``: ``tuned`` is the TunedConfig
    (None for ``{"dense": true}`` entries) and ``cdt`` the compute mode
    the cell runs in (a committed ``dtype`` key overrides
    ``compute_dtype``)."""
    from bsmr_sddmm.ops.dense import DenseSDDMM
    from bsmr_sddmm.reorder.autotune import autotune, from_params

    cdt = (cfg or {}).get("dtype", compute_dtype)
    if cfg is None:
        tuned = autotune(csr, k=k, compute_dtype=cdt)
    elif cfg.get("dense"):
        return DenseSDDMM.from_csr(csr, compute_dtype=cdt), None, cdt
    else:
        tuned = from_params(
            csr, k, alpha=cfg["alpha"], delta=cfg["delta"],
            group_size=cfg.get("g", 1), k_chunks=cfg.get("c", 1),
            merge_superpanels=cfg.get("merge", True),
            hub_cols=cfg.get("hub", 0),
            compute_dtype=cdt,
            window_dp=cfg.get("window_dp", True),
            sort_runs=cfg.get("sort_runs", "cid"),
            sort_res=cfg.get("sort_res", "csr"),
            b_cost_scale=cfg.get("b_cost_scale", 1.0),
            hot_rows=cfg.get("rowslab_pre", 0) or cfg.get("rowslab", 0),
            hot_rows_pre=bool(cfg.get("rowslab_pre", 0)))
        tuned.a_layout = cfg.get("a_layout", "rows")
    return (runner_of(csr, tuned, cdt), None if tuned.dense else tuned,
            cdt)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true",
                        help="CPU smoke run at tiny sizes")
    parser.add_argument("--k", type=int, default=128)
    parser.add_argument("--iterations", type=int, default=40)
    parser.add_argument("--sessions", type=int, default=3,
                        help="independent timing sessions; median wins")
    parser.add_argument("--retune", action="store_true",
                        help="re-run the on-device autotune shootout "
                             "instead of the committed tuned configs")
    parser.add_argument("--save-tuned", action="store_true",
                        help="with --retune: write each winner back to "
                             "results/tuned_configs.json")
    parser.add_argument("--compute-dtype", default="tf32",
                        choices=["float32", "tf32", "mixed", "float16",
                                 "bfloat16"])
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args()

    import jax

    if args.quick:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bsmr_sddmm.utils.device import device_record
    device = device_record()
    if not args.quick and device["platform"] != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU, but JAX's first device is "
            f"{device['platform']!r}; --quick is the CPU smoke run")

    from bsmr_sddmm.utils.cache import enable_persistent_cache
    enable_persistent_cache()

    from bsmr_sddmm.data import generate
    from bsmr_sddmm.ops.csr_sddmm import csr_sddmm_jax
    from bsmr_sddmm.reorder.autotune import autotune
    from bsmr_sddmm.utils.timing import gflops, measure_loop_ms

    def log(msg):
        if args.verbose:
            print(msg, file=sys.stderr)

    cfg_errors = validate_tuned_configs()
    if cfg_errors:
        # malformed committed configs must fail LOUDLY in --quick (CI)
        # rather than minutes into a GPU run
        for e in cfg_errors:
            print(f"ERROR: {e}", file=sys.stderr)
        raise SystemExit(f"{len(cfg_errors)} malformed entries in "
                         f"{TUNED_CONFIGS}")

    on_device = device["platform"] == "gpu"
    warnings = []
    results = {}
    results_csr_order = {}
    csr_ratio = {}
    sessions_ms = {}
    tuning_s = {}
    for name, gen in suite(args.quick).items():
        t0 = time.perf_counter()
        csr = gen()
        # --quick uses different (tiny) matrices, so the committed
        # full-suite configs don't apply there
        cfg = (None if (args.retune or args.quick)
               else load_tuned_config(name, args.k))
        if args.retune:
            tuned = autotune(csr, k=args.k,
                             compute_dtype=args.compute_dtype,
                             measure=on_device)
            runner = runner_of(csr, tuned, args.compute_dtype)
            if args.save_tuned:
                if tuned.dense:
                    new_cfg = {"dense": True}
                else:
                    new_cfg = {"alpha": tuned.alpha, "delta": tuned.delta,
                               "g": tuned.group_size, "c": tuned.k_chunks,
                               "merge": tuned.merge_superpanels}
                    if tuned.hub_cols:
                        new_cfg["hub"] = tuned.hub_cols
                    if tuned.hot_rows:
                        new_cfg["rowslab_pre"] = tuned.hot_rows
                    if tuned.a_layout != "rows":
                        new_cfg["a_layout"] = tuned.a_layout
                try:
                    data = json.loads(TUNED_CONFIGS.read_text())
                except (OSError, json.JSONDecodeError):
                    data = {}
                data.setdefault(f"k{args.k}", {})[name] = new_cfg
                TUNED_CONFIGS.write_text(json.dumps(data, indent=4)
                                         + "\n")
                log(f"{name}: saved tuned config {new_cfg}")
            if tuned.dense:
                tuned = None
        else:
            runner, tuned, _ = build_runner(csr, args.k, cfg,
                                            args.compute_dtype)
        packed = None if tuned is None else tuned.packed
        tuning_s[name] = time.perf_counter() - t0
        a = generate.make_dense(csr.m, args.k, seed=1)
        b = generate.make_dense(args.k, csr.n, seed=2)
        a_pad, bt_pad = runner.prepare_operands(a, b=b)

        # Independent timing sessions; each is a loop-differenced min,
        # the median across sessions is reported.
        n_sessions = 1 if args.quick else max(args.sessions, 1)
        sess = [runner.measure_kernel_ms(a_pad, bt_pad,
                                         iterations=args.iterations,
                                         repeats=4, order="packed")
                for _ in range(n_sessions)]
        ms = float(np.median(sess))
        spread = (max(sess) - min(sess)) / ms if ms > 0 else 0.0
        if spread > 0.15:
            warnings.append(
                f"{name}: timing spread {spread:.0%} across "
                f"{n_sessions} sessions ({sess})")
        sessions_ms[name] = sess
        g = gflops(csr.nnz, args.k, ms)
        results[name] = g

        # CSR-entry-order delivery (includes the packed->CSR conversion,
        # matching the reference's output convention)
        ms_csr = runner.measure_kernel_ms(
            a_pad, bt_pad, iterations=max(args.iterations // 2, 10),
            repeats=3, order="csr")
        results_csr_order[name] = gflops(csr.nnz, args.k, ms_csr)

        # Same-device csr gather-dot baseline (the cuSPARSE-equivalent):
        # measures algorithmic speedup independent of hardware.
        a_d = jnp.asarray(a)
        bt_d = jnp.asarray(b.T.copy())
        rows_d = jnp.asarray(csr.row_indices(), dtype=jnp.int32)
        cols_d = jnp.asarray(csr.col_idx, dtype=jnp.int32)

        def _csr_body(c, a_d, bt_d, rows_d, cols_d):
            r2 = jnp.where(c > jnp.float32(-1e30), rows_d, 0)
            return csr_sddmm_jax(a_d, bt_d, r2, cols_d)

        csr_ms = measure_loop_ms(_csr_body, (a_d, bt_d, rows_d, cols_d),
                                 iterations=15)
        csr_ratio[name] = csr_ms / ms

        if packed is None:
            cfg_str = "dense"
            pack_str = ""
        else:
            cfg_str = (
                f"a={tuned.alpha} d={tuned.delta} "
                f"G={tuned.group_size} C={tuned.k_chunks} "
                f"H={tuned.hub_cols} aL={tuned.a_layout} "
                f"merge={tuned.merge_superpanels}")
            pack_str = (f"nS={packed.num_super} nQ={packed.num_quads} "
                        f"nP={packed.num_pairs} nG={packed.num_groups} "
                        f"res={packed.nnz_res} ")
        log(f"{name}: nnz={csr.nnz} cfg=({cfg_str} "
            f"{'[committed]' if cfg is not None else '[autotuned]'}) "
            f"{pack_str}sessions={sess} median={ms}ms gflops={g} "
            f"csr_order={results_csr_order[name]} "
            f"({time.perf_counter() - t0:.0f}s total)")

    def gm(vals):
        return float(np.exp(np.mean(np.log(np.maximum(vals, 1e-9)))))

    geomean = gm(list(results.values()))
    out = {
        "metric": f"hybrid_sddmm_geomean_gflops_k{args.k}",
        "value": geomean,
        "unit": "GFLOPS",
        "device": device,
        "compute_dtype": args.compute_dtype,
        "vs_baseline": geomean / REFERENCE_MEAN_GFLOPS.get(args.k, 3452.0),
        "per_matrix": results,
        "per_matrix_csr_order": results_csr_order,
        "geomean_csr_order": gm(list(results_csr_order.values())),
        "speedup_vs_csr_same_device": csr_ratio,
        "geomean_vs_csr": gm(list(csr_ratio.values())),
        "timing_sessions_ms": sessions_ms,
        "tuning_s": tuning_s,
    }
    if warnings:
        out["warnings"] = warnings
        for w in warnings:
            print(f"WARNING: {w}", file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
