#!/usr/bin/env python3
"""Smoke run of the BSMR SDDMM main path on the GPU, in one process.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded path only

Phases (one card):

1. Device: JAX's first device must be a GPU, or the script exits
   non-zero before any work; prints the device kind and count, the
   card's name and power limit (``nvidia-smi``) and the compile-cache
   directory in use.
2. Correctness: for every committed (matrix, K) config of
   ``results/tuned_configs.json`` (the five bench matrices at K = 32, 64,
   128, 256), build the runner exactly as ``bench.py`` does, run packed
   and CSR order, and hold both against the float64 reference
   (``ops/reference.sddmm_reference``) to the reference's contract
   (abs 1e-5 / rel 1e-3, ``utils/check.check_values``).
3. Consumers: one forward and one gradient step of
   ``models/factorization.py`` on the powerlaw bench pattern at K=128,
   each against a numpy reference, and one forward of the
   ``__graft_entry__.entry()`` graph-attention layer against a numpy
   reference.
4. Memory: the device's peak bytes in use.

``--four-cards`` runs only the sharded ``DistributedHybridSDDMM`` on a
(2, 2) rows x feat mesh at the clustered16 bench pattern, K=128, float32,
and compares it with the one-card ``HybridSDDMM``.

The last line of standard output is one JSON object naming the device;
it is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

KS = (32, 64, 128, 256)


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(Exception):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def precision_label(compute_dtype: str) -> str:
    from bsmr_sddmm.ops.hybrid import _PRECISION
    if compute_dtype in ("float16", "mixed"):
        return "split-bf16"
    return str(_PRECISION[compute_dtype]).split(".")[-1]


def phase_device() -> dict:
    from bsmr_sddmm.utils.cache import enable_persistent_cache
    from bsmr_sddmm.utils.device import device_record
    dev = device_record()
    log(f"device: platform={dev['platform']} kind={dev['kind']} "
        f"count={dev['count']}")
    log(f"nvidia-smi: {dev['gpu']}")
    log(f"compile cache: {enable_persistent_cache()}")
    return dev


def phase_correctness() -> None:
    import bench
    from bsmr_sddmm.data import generate
    from bsmr_sddmm.ops.reference import sddmm_reference
    from bsmr_sddmm.utils.check import check_values

    failures = []
    for name, gen in bench.suite(quick=False).items():
        csr = gen()
        for k in KS:
            t0 = time.perf_counter()
            cfg = bench.load_tuned_config(name, k)
            require(cfg is not None, f"no committed config for {name} k{k}")
            runner, tuned, cdt = bench.build_runner(csr, k, cfg)
            a = generate.make_dense(csr.m, k, seed=1)
            b = generate.make_dense(k, csr.n, seed=2)
            ops = runner.prepare_operands(a, b=b)
            packed_out = runner.run_padded(*ops, order="packed")
            csr_out = np.asarray(runner.to_csr_order(packed_out))
            packed_out = np.asarray(packed_out)
            want = sddmm_reference(a, b, csr)
            if tuned is None:   # dense class: (M, N) product is native
                from_packed = packed_out[csr.row_indices(), csr.col_idx]
            else:
                from_packed = packed_out[tuned.packed.inv_idx]
            res_csr = check_values(want, csr_out)
            res_packed = check_values(want, from_packed)
            ok = res_csr.passed and res_packed.passed
            log(f"check {name:12s} k={k:3d} mode={cdt} "
                f"dot={precision_label(cdt)} class="
                f"{'dense' if tuned is None else 'hybrid'} "
                f"nnz={csr.nnz} "
                f"max_rel={res_csr.max_rel_err:.3e} "
                f"errors={res_csr.num_errors} "
                f"packed_max_rel={res_packed.max_rel_err:.3e} "
                f"packed_errors={res_packed.num_errors} "
                f"{'PASS' if ok else 'FAIL'} "
                f"({time.perf_counter() - t0:.1f}s)")
            if not ok:
                failures.append(f"{name} k{k}")
            del runner, ops, packed_out
    require(not failures, f"contract failed: {failures}")


def phase_factorization() -> None:
    import jax
    import scipy.sparse as sp

    import bench
    from bsmr_sddmm.models.factorization import SparseFactorizationModel
    from bsmr_sddmm.utils.check import check_values

    k = 128
    csr = bench.suite(quick=False)["powerlaw"]()
    model = SparseFactorizationModel.from_csr(csr, k)
    params = model.init(jax.random.PRNGKey(0))
    a = np.asarray(params.a, np.float64)
    bt = np.asarray(params.bt, np.float64)
    rows = csr.row_indices()
    pred_ref = np.einsum("ij,ij->i", a[rows], bt[csr.col_idx])

    pred = np.asarray(model.forward(params, order="csr"))
    res = check_values(pred_ref, pred)
    log(f"factorization forward: nnz={csr.nnz} {res}")
    require(res.passed, "factorization forward outside the contract")

    targets = model.pack_targets(csr.values)
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, targets)
    err = pred_ref - csr.values
    loss_ref = float(np.mean(err ** 2))
    e = sp.csr_matrix((2.0 * err / csr.nnz, csr.col_idx, csr.row_ptr),
                      shape=csr.shape)
    ga_ref, gbt_ref = e @ bt, e.T @ a
    ga, gbt = np.asarray(grads.a), np.asarray(grads.bt)
    g_err = max(float(np.abs(ga - ga_ref).max() / np.abs(ga_ref).max()),
                float(np.abs(gbt - gbt_ref).max() / np.abs(gbt_ref).max()))
    log(f"factorization grad: loss={float(loss):.6f} ref={loss_ref:.6f} "
        f"grad max_abs/max={g_err:.3e}")
    require(abs(float(loss) - loss_ref) <= 1e-4 * loss_ref,
            "factorization loss")
    require(g_err < 1e-4, f"factorization grad error {g_err}")

    step = model.make_train_step()
    opt_state = model.optimizer.init(params)
    params2, _, loss0 = step(params, opt_state, targets)
    loss1 = float(model.loss(params2, targets))
    log(f"factorization step: loss {float(loss0):.6f} -> {loss1:.6f}")
    require(np.isfinite(loss1) and loss1 < float(loss0),
            "factorization step did not lower the loss")


def phase_graph_attention() -> None:
    import jax

    import __graft_entry__ as graft

    # the layer's projections x @ W run at full fp32 here so the float64
    # reference below holds it to 1e-4 (the card's default matmul class
    # is TF32)
    with jax.default_matmul_precision("highest"):
        fn, (params, x) = graft.entry()
        out = np.asarray(jax.jit(fn)(params, x), np.float64)
    adj = graft.entry_adjacency()
    xs = np.asarray(x, np.float64)
    q, kk, v = (xs @ np.asarray(w, np.float64) for w in params)
    rows, cols = adj.row_indices(), adj.col_idx
    s = np.einsum("ij,ij->i", q[rows], kk[cols]) / np.sqrt(q.shape[1])
    smax = np.full(adj.m, -np.inf)
    np.maximum.at(smax, rows, s)
    ex = np.exp(s - smax[rows])
    den = np.bincount(rows, ex, minlength=adj.m)
    attn = ex / den[rows]
    want = np.zeros((adj.m, v.shape[1]))
    np.add.at(want, rows, attn[:, None] * v[cols])
    err = float(np.abs(out - want).max() / np.abs(want).max())
    log(f"graph attention: out={out.shape} max_abs/max={err:.3e}")
    require(out.shape == want.shape and np.isfinite(out).all(),
            "graph attention output")
    require(err < 1e-4, f"graph attention error {err}")


def four_card_check(csr, k: int, cfg: dict, devices) -> dict:
    """The sharded path on a (2, 2) rows x feat mesh of ``devices``
    against the one-card ``HybridSDDMM`` and the float64 reference, all
    in float32 and held to the reference's contract."""
    import bench
    from bsmr_sddmm.data import generate
    from bsmr_sddmm.ops.hybrid import HybridSDDMM
    from bsmr_sddmm.ops.reference import sddmm_reference
    from bsmr_sddmm.parallel.dist import DistributedHybridSDDMM
    from bsmr_sddmm.parallel.mesh import make_mesh
    from bsmr_sddmm.utils.check import check_values

    _, tuned, _ = bench.build_runner(csr, k, dict(cfg, dtype="float32"))
    mesh = make_mesh((2, 2), ("rows", "feat"), devices=devices[:4])
    dist = DistributedHybridSDDMM(tuned.packed, mesh,
                                  compute_dtype="float32",
                                  a_layout=tuned.a_layout)
    single = HybridSDDMM(tuned.packed, compute_dtype="float32",
                         k_chunks=dist.k_chunks, a_layout=tuned.a_layout)
    a = generate.make_dense(csr.m, k, seed=1)
    b = generate.make_dense(k, csr.n, seed=2)
    got4 = np.asarray(dist(a, b=b, order="csr"))
    got1 = np.asarray(single(a, b=b, order="csr"))
    want = sddmm_reference(a, b, csr)
    return {"mesh": dict(mesh.shape),
            "balance": dist.tile_balance().tolist(),
            "four_vs_ref": check_values(want, got4),
            "one_vs_ref": check_values(want, got1),
            "four_vs_one": check_values(got1, got4),
            "max_abs_diff": float(np.abs(got4.astype(np.float64)
                                         - got1).max())}


def phase_four_cards() -> None:
    import jax

    import bench

    require(len(jax.devices()) >= 4,
            f"--four-cards needs 4 devices, have {len(jax.devices())}")
    k = 128
    csr = bench.suite(quick=False)["clustered16"]()
    r = four_card_check(csr, k, bench.load_tuned_config("clustered16", k),
                        jax.devices())
    log(f"four cards: mesh={r['mesh']} nnz={csr.nnz} "
        f"balance={r['balance']}")
    log(f"four cards vs reference: {r['four_vs_ref']}")
    log(f"one card vs reference: {r['one_vs_ref']}")
    log(f"four cards vs one card: max_abs_diff={r['max_abs_diff']:.3e} "
        f"(tolerance: abs 1e-5 / rel 1e-3, the reference's contract) "
        f"{r['four_vs_one']}")
    require(r["four_vs_ref"].passed and r["one_vs_ref"].passed
            and r["four_vs_one"].passed,
            "four-card result outside the contract")


def result_line(dev: dict) -> str:
    """The last line of a passing run: the device as JAX reports it."""
    return json.dumps({"ok": True,
                       "device": {"platform": dev["platform"],
                                  "kind": dev["kind"],
                                  "count": dev["count"]}})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded path on four cards")
    args = parser.parse_args(argv)

    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"chip_smoke: JAX's first device is {platform!r}, not a "
              "GPU", file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    dev = phase_device()
    try:
        if args.four_cards:
            phase_four_cards()
        else:
            phases = (("correctness", phase_correctness),
                      ("factorization", phase_factorization),
                      ("graph attention", phase_graph_attention))
            for name, fn in phases:
                t = time.perf_counter()
                fn()
                log(f"phase {name}: ok ({time.perf_counter() - t:.1f}s)")
            stats = jax.devices()[0].memory_stats() or {}
            log(f"memory: peak_bytes_in_use="
                f"{stats.get('peak_bytes_in_use')}")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t0:.1f}s")
    print(result_line(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
