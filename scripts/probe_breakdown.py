#!/usr/bin/env python3
"""Component-level time breakdown of the hybrid SDDMM on the real device.

Times each constituent of the hybrid program in isolation (B gathers, A
gathers, batched tile dots on pre-gathered operands, residual path, full
dense path, full hybrid) with the loop-differencing methodology
(utils/timing.diff_time_ms), so perf work targets the measured bottleneck
instead of the modeled one.

Usage:
    python scripts/probe_breakdown.py --matrix powerlaw --k 128
    python scripts/probe_breakdown.py --matrix clustered16 --k 32 --g 4
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--matrix", default="powerlaw")
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--compute-dtype", default="tf32")
    p.add_argument("--iterations", type=int, default=30)
    p.add_argument("--g", type=int, default=None, help="override G")
    p.add_argument("--c", type=int, default=None, help="override k_chunks")
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--delta", type=float, default=None)
    p.add_argument("--committed", action="store_true",
                   help="dissect the COMMITTED tuned config for this "
                        "(matrix, K) — hub/a_layout/merge/dtype "
                        "included — instead of a fresh model-only "
                        "autotune")
    p.add_argument("--file", default=None, help="matrix file instead of "
                   "a bench-suite name")
    args = p.parse_args(argv)

    from bsmr_sddmm.utils.cache import enable_persistent_cache
    enable_persistent_cache()

    import jax
    import jax.numpy as jnp

    import bench
    from bsmr_sddmm.data import generate, io
    from bsmr_sddmm.ops.hybrid import (GROUP_LANES, HybridSDDMM, _PRECISION,
                                      _storage_dtype)
    from bsmr_sddmm.reorder.autotune import autotune, from_params
    from bsmr_sddmm.utils.timing import gflops, measure_loop_ms

    if args.file:
        csr = io.load(args.file)
    else:
        csr = bench.suite(False)[args.matrix]()
    # this probe dissects the hybrid kernel's stages — never the dense
    # strategy (which has no stages to attribute)
    a_layout = "rows"
    if args.committed:
        cfg = bench.load_tuned_config(args.matrix, args.k)
        if not cfg or cfg.get("dense"):
            print(f"no committed hybrid config for {args.matrix} "
                  f"K={args.k}; nothing to dissect")
            return 1
        args.compute_dtype = cfg.get("dtype", args.compute_dtype)
        tuned = from_params(
            csr, args.k, alpha=cfg["alpha"], delta=cfg["delta"],
            group_size=cfg.get("g", 1), k_chunks=cfg.get("c", 1),
            merge_superpanels=cfg.get("merge", True),
            hub_cols=cfg.get("hub", 0), compute_dtype=args.compute_dtype,
            window_dp=cfg.get("window_dp", True),
            sort_runs=cfg.get("sort_runs", "cid"),
            sort_res=cfg.get("sort_res", "csr"),
            b_cost_scale=cfg.get("b_cost_scale", 1.0),
            hot_rows=cfg.get("rowslab_pre", 0) or cfg.get("rowslab", 0),
            hot_rows_pre=bool(cfg.get("rowslab_pre", 0)))
        a_layout = cfg.get("a_layout", "rows")
    else:
        tuned = autotune(
            csr, k=args.k, compute_dtype=args.compute_dtype, measure=False,
            alphas=(args.alpha,) if args.alpha is not None else (0.3,),
            deltas=(args.delta,) if args.delta is not None
            else (0.0, 0.05, 0.3),
            allow_dense=False)
    g = args.g if args.g is not None else tuned.group_size
    c = args.c if args.c is not None else tuned.k_chunks
    if g != tuned.group_size:
        # re-derive the packing at the requested G
        from bsmr_sddmm.reorder.bsmr import BSMR
        from bsmr_sddmm.reorder.cols import cluster_columns
        from bsmr_sddmm.reorder.pack import pack
        rank = None
        if g > 1:
            order = cluster_columns(csr, tuned.alpha)
            rank = np.empty(csr.n, dtype=np.int64)
            rank[order] = np.arange(csr.n)
        bsmr = BSMR(tuned.alpha, tuned.delta, csr, group_size=g,
                    col_rank=rank)
        packed = pack(csr, bsmr, k_hint=args.k,
                      compute_dtype=args.compute_dtype)
    else:
        packed = tuned.packed

    runner = HybridSDDMM(packed, compute_dtype=args.compute_dtype,
                         k_chunks=c, a_layout=a_layout)
    a = generate.make_dense(csr.m, args.k, seed=1)
    b = generate.make_dense(args.k, csr.n, seed=2)
    a_ops, bt_phys = runner.prepare_operands(a, b=b)
    # panels-layout operands are an (a_pad, a_panels) pair; the
    # per-component bodies want the plain padded-rows view
    a_pad = a_ops[0] if isinstance(a_ops, tuple) else a_ops
    kc = args.k // bt_phys.shape[0]
    C = bt_phys.shape[0]
    LG = GROUP_LANES // packed.group_size
    cdtype = _storage_dtype(args.compute_dtype)
    precision = _PRECISION[args.compute_dtype]

    print(f"matrix={args.matrix} m={csr.m} n={csr.n} nnz={csr.nnz} "
          f"k={args.k} cfg=(a={tuned.alpha} d={tuned.delta} G="
          f"{packed.group_size} C={c} H={packed.hub_cols} "
          f"aL={a_layout} "
          f"dt={args.compute_dtype} merge={tuned.merge_superpanels})")
    print(f"tiles: nS={packed.num_super} nQ={packed.num_quads} "
          f"nP={packed.num_pairs} nG={packed.num_groups} "
          f"res={packed.nnz_res} hub={packed.nnz_hub} "
          f"packed={packed.packed_size}")
    # gather accounting: the rows the B and A gathers fetch
    from bsmr_sddmm.reorder.autotune import (_ELEM_BYTES,
                                            descriptor_floor_ms, dot_ms)
    LGd = GROUP_LANES // packed.group_size
    n_tiles = (packed.num_super + packed.num_quads + packed.num_pairs
               + packed.num_groups)
    all_gids = np.concatenate([
        packed.super_gids.reshape(-1), packed.quad_gids.reshape(-1),
        packed.pair_gids.reshape(-1), packed.group_gids.reshape(-1)])
    b_el = _ELEM_BYTES[args.compute_dtype][1]
    b_bytes = packed.group_size * (args.k // c) * b_el
    print(f"descriptors: B_tile={n_tiles * LGd} (uniq "
          f"{len(np.unique(all_gids))}) B_res={packed.nnz_res} "
          f"width={b_bytes}B src="
          f"{(packed.num_col_groups + 1) * b_bytes * c / 1e6:.1f}MB; "
          f"floor(desc)={descriptor_floor_ms(packed, args.k, args.compute_dtype, c, a_layout):.4f}ms "
          f"dot_est={dot_ms(packed, args.k, args.compute_dtype):.4f}ms")

    segs = []  # (rows_arr, gids_arr, b, start, n_runs)
    for rows_arr, gids_arr, buckets in (
            (runner._super_rows, runner._super_gids, packed.super_buckets),
            (runner._quad_rows, runner._quad_gids, packed.quad_buckets),
            (runner._pair_rows, runner._pair_gids, packed.pair_buckets),
            (runner._group_rows, runner._group_gids, packed.group_buckets)):
        for (bk, start, n_runs) in buckets:
            segs.append((rows_arr, gids_arr, bk, start, n_runs))

    def live_mask(cr, ix):
        return jnp.where(cr > jnp.float32(-1e30), ix, jnp.zeros_like(ix))

    # --- component bodies (body(carry, *args) for measure_loop_ms) ---
    def body_b_gather(cr, a_pad, bt_phys):
        tot = jnp.float32(0)
        for rows_arr, gids_arr, bk, start, n_runs in segs:
            gids = jax.lax.slice_in_dim(live_mask(cr, gids_arr), start,
                                        start + n_runs * bk, axis=0)
            gids = gids.reshape(n_runs, bk * LG)
            for cc in range(C):
                bg = jnp.take(bt_phys[cc], gids, axis=0)
                tot = tot + jnp.sum(bg.astype(jnp.float32))
        return tot

    def body_a_gather(cr, a_pad, bt_phys):
        tot = jnp.float32(0)
        for rows_arr, gids_arr, bk, start, n_runs in segs:
            run_rows = jax.lax.slice_in_dim(live_mask(cr, rows_arr), start,
                                            start + n_runs * bk, stride=bk,
                                            axis=0)
            a_run = jnp.take(a_pad, run_rows, axis=0)
            tot = tot + jnp.sum(a_run.astype(jnp.float32))
        return tot

    # panel-major A gather (a_layout="panels"): same rows via one 16-row
    # descriptor per panel
    from bsmr_sddmm.ops.hybrid import PANEL_ROWS
    first_panel = packed.cont_panel_ids[packed.cont_panel_off[:-1]]
    fam_runoff = {}
    pst_segs = []
    for fname in ("super", "quad", "pair", "group"):
        run_cont = getattr(packed, f"{fname}_run_cont")
        pst_all = (jnp.asarray(first_panel[run_cont], dtype=jnp.int32)
                   if len(run_cont) else jnp.zeros(0, jnp.int32))
        fam_runoff[fname] = [pst_all, 0]
    for fname, rows_h in (("super", 128), ("quad", 64), ("pair", 32),
                          ("group", 16)):
        off = 0
        for (bk, start, n_runs) in getattr(packed, f"{fname}_buckets"):
            pst_segs.append((fam_runoff[fname][0], off, n_runs,
                             rows_h // PANEL_ROWS))
            off += n_runs
    ap_np = np.asarray(a_pad)[np.asarray(packed.a_row_gather)]
    ap_np = np.concatenate([ap_np.reshape(-1, PANEL_ROWS, args.k),
                            np.zeros((1, PANEL_ROWS, args.k),
                                     ap_np.dtype)])
    a_panels = jnp.asarray(ap_np)

    def body_a_gather_panels(cr, a_panels):
        tot = jnp.float32(0)
        for pst_all, off, n_runs, npan in pst_segs:
            pst = jax.lax.slice_in_dim(live_mask(cr, pst_all), off,
                                       off + n_runs)
            pids = pst[:, None] + jnp.arange(npan, dtype=jnp.int32)
            pids = jnp.minimum(pids, jnp.int32(a_panels.shape[0] - 1))
            a_run = jnp.take(a_panels, pids, axis=0)
            tot = tot + jnp.sum(a_run.astype(jnp.float32))
        return tot

    # dots with pre-gathered operands
    pre = []
    for rows_arr, gids_arr, bk, start, n_runs in segs:
        run_rows = jax.lax.slice_in_dim(rows_arr, start,
                                        start + n_runs * bk, stride=bk,
                                        axis=0)
        gids = jax.lax.slice_in_dim(gids_arr, start, start + n_runs * bk,
                                    axis=0).reshape(n_runs, bk * LG)
        a_run = jnp.take(a_pad, run_rows, axis=0).astype(cdtype)
        bgs = []
        for cc in range(C):
            bg = jnp.take(bt_phys[cc], gids, axis=0)
            bg = bg.reshape(n_runs, bk * LG, packed.group_size, kc)
            bgs.append(bg.reshape(n_runs, bk * GROUP_LANES, kc)
                       .astype(cdtype))
        pre.append((a_run, bgs))
    pre_flat = []
    for a_run, bgs in pre:
        pre_flat.append(a_run)
        pre_flat.extend(bgs)

    def body_dots(cr, *ops):
        tot = jnp.float32(0)
        i = 0
        for rows_arr, gids_arr, bk, start, n_runs in segs:
            a_run = live_mask(cr, ops[i]); i += 1
            for cc in range(C):
                bg = ops[i]; i += 1
                a_c = jax.lax.slice_in_dim(a_run, cc * kc, (cc + 1) * kc,
                                           axis=2)
                acc = jax.lax.dot_general(
                    a_c, bg, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                    preferred_element_type=jnp.float32, precision=precision)
                tot = tot + jnp.sum(acc)
        return tot

    def body_dense(cr, a_pad, bt_phys):
        tot = jnp.float32(0)
        for rows_arr, gids_arr, bk, start, n_runs in segs:
            run_rows = jax.lax.slice_in_dim(live_mask(cr, rows_arr), start,
                                            start + n_runs * bk, stride=bk,
                                            axis=0)
            gids = jax.lax.slice_in_dim(gids_arr, start,
                                        start + n_runs * bk, axis=0)
            gids = gids.reshape(n_runs, bk * LG)
            a_run = jnp.take(a_pad, run_rows, axis=0).astype(cdtype)
            for cc in range(C):
                bg = jnp.take(bt_phys[cc], gids, axis=0)
                bg = bg.reshape(n_runs, bk * LG, packed.group_size, kc)
                bg = bg.reshape(n_runs, bk * GROUP_LANES, kc).astype(cdtype)
                a_c = jax.lax.slice_in_dim(a_run, cc * kc, (cc + 1) * kc,
                                           axis=2)
                acc = jax.lax.dot_general(
                    a_c, bg, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                    preferred_element_type=jnp.float32, precision=precision)
                tot = tot + jnp.sum(acc)
        return tot

    def body_residual(cr, a_pad, bt_phys):
        res_rows = live_mask(cr, runner._res_rows)
        res_gids = live_mask(cr, runner._res_gids)
        nR = res_rows.shape[0]
        a_res = jnp.take(a_pad, res_rows, axis=0)
        res = jnp.zeros((nR,), jnp.float32)
        for cc in range(C):
            br = jnp.take(bt_phys[cc], res_gids, axis=0).reshape(
                nR, packed.group_size, kc)
            br = jnp.take_along_axis(
                br, runner._res_member[:, None, None].astype(jnp.int32),
                axis=1)[:, 0, :]
            a_r = jax.lax.slice_in_dim(a_res, cc * kc, (cc + 1) * kc, axis=1)
            res = res + jnp.sum(a_r.astype(jnp.float32)
                                * br.astype(jnp.float32), axis=-1)
        return res

    def body_res_a_gather(cr, a_pad, bt_phys):
        return jnp.take(a_pad, live_mask(cr, runner._res_rows), axis=0)

    def body_res_b_gather(cr, a_pad, bt_phys):
        res_gids = live_mask(cr, runner._res_gids)
        tot = jnp.float32(0)
        for cc in range(C):
            tot = tot + jnp.sum(jnp.take(bt_phys[cc], res_gids,
                                         axis=0).astype(jnp.float32))
        return tot

    H = packed.hub_cols
    G_ = packed.group_size

    def body_hub(cr, a_pad, bt_phys):
        # the dense hub slab: contiguous B^T slice x A, zero descriptors
        hg = H // G_
        m_rows = a_pad.shape[0] - 1
        a_real = jax.lax.slice_in_dim(a_pad, 0, m_rows,
                                      axis=0).astype(cdtype)
        start = jnp.where(cr > jnp.float32(-1e30), 0, 1).astype(jnp.int32)
        tot = jnp.float32(0)
        for cc in range(C):
            bhub = jax.lax.dynamic_slice_in_dim(bt_phys[cc], start, hg,
                                                axis=0)
            a_c = jax.lax.slice_in_dim(a_real, cc * kc, (cc + 1) * kc,
                                       axis=1)
            if G_ > 1:
                bh = bhub.reshape(hg, G_, kc).astype(cdtype)
                acc = jax.lax.dot_general(
                    a_c, bh, dimension_numbers=(((1,), (2,)), ((), ())),
                    preferred_element_type=jnp.float32,
                    precision=precision)
            else:
                acc = jax.lax.dot_general(
                    a_c, bhub.astype(cdtype),
                    dimension_numbers=(((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32,
                    precision=precision)
            tot = tot + jnp.sum(acc)
        return tot

    def report(name, ms):
        print(f"  {name:18s} {ms:8.3f} ms   "
              f"({gflops(csr.nnz, args.k, ms):7.1f} GFLOPS-equiv)",
              flush=True)

    it = args.iterations
    report("full_hybrid",
           runner.measure_kernel_ms(a_ops, bt_phys, iterations=it,
                                    repeats=5))
    bodies = [("dense_path", body_dense),
              ("b_gather", body_b_gather),
              ("a_gather", body_a_gather),
              ("a_gather_panels", body_a_gather_panels),
              ("dots_pregathered", body_dots),
              ("residual_path", body_residual),
              ("res_a_gather", body_res_a_gather),
              ("res_b_gather", body_res_b_gather)]
    if H:
        bodies.append(("hub_slab", body_hub))
    for name, body in bodies:
        if name == "dots_pregathered":
            ms = measure_loop_ms(body, tuple(pre_flat), iterations=it,
                                 repeats=4)
        elif name == "a_gather_panels":
            ms = measure_loop_ms(body, (a_panels,), iterations=it,
                                 repeats=4)
        else:
            ms = measure_loop_ms(body, (a_pad, bt_phys), iterations=it,
                                 repeats=4)
        report(name, ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
