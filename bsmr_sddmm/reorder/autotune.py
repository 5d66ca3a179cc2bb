"""Cost-model-driven configuration search for the hybrid SDDMM.

The reference ships fixed defaults (alpha=0.3, delta=0.3,
include/Options.hpp:38-41) tuned for an RTX 4090's tensor-core/CUDA-core
balance, and explores the rest of the space empirically with its -t sweep
mode (src/sddmm.cu:62-118).  This module does both: a measurement-backed
*static* cost model ranks the configuration space (alpha, delta,
superpanel merging, gather-group width G, K-chunking C, residual
absorption), and an optional *measured* mode times the top candidates on
the real device, exactly like the reference's sweep but guided.

The model's device constants below are ``scripts/calibrate.py``'s
measurements on one NVIDIA H100 80GB HBM3 at its 700 W power limit
(PERF.md, "Cost-model constants"); re-run it on other hardware and load
the result with ``load_calibration``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from bsmr_sddmm.data.sparse import CSR
from bsmr_sddmm.reorder.bsmr import BSMR
from bsmr_sddmm.reorder.pack import (GROUP_CELLS, GROUP_LANES, SUPER_CELLS,
                                    PackedMatrix, pack)

# -- measured constants: scripts/calibrate.py on an NVIDIA H100 80GB HBM3,
# power limit 700 W --
STREAM_GBPS = 3096.0     # fused read-reduce of a 512 MB fp32 array
# gather row rate (M rows/s) at ~8 MB source (L2-resident on the card),
# by gathered-row bytes
_ROW_RATE_8MB = {128: 33114.4, 256: 22478.3, 512: 13420.0, 1024: 6901.8,
                 2048: 3487.2}
# source-footprint scaling of the 512 B row rate.  Every rate probe draws
# 2M uniform-random indices from the source, so each row is fetched many
# times (~120x for 512 B rows at 8 MB): the tables already price the
# repeated fetches a packing makes, and no separate repeat discount is
# applied.
_SRC_MB = np.array([0.0, 2.0, 4.0, 8.0, 16.0, 32.0, 1e9])
_SRC_F = np.array([1.054, 1.054, 1.042, 1.0, 0.986, 0.936, 0.936])

# batched tile-dot rates (M 16-row groups/s) by (compute mode, tile
# height): (n, R, 128) x (n, 128, 128) dots at each mode's precision
# (same card and run as the constants above).  "mixed" and "float16"
# are the 2- and 3-pass bf16 split dots (ops/hybrid.tile_dot), priced
# from the bf16 rate.
_DOT_G16_MS = {
    ("float32", 16): 17.8e6, ("float32", 32): 27.1e6,
    ("float32", 64): 35.1e6, ("float32", 128): 38.9e6,
    ("tf32", 16): 23.3e6, ("tf32", 32): 32.5e6, ("tf32", 64): 43.6e6,
    ("tf32", 128): 53.6e6,
    ("bfloat16", 16): 42.6e6, ("bfloat16", 32): 55.2e6,
    ("bfloat16", 64): 66.5e6, ("bfloat16", 128): 75.8e6,
    ("mixed", 16): 21.3e6, ("mixed", 32): 27.6e6, ("mixed", 64): 33.25e6,
    ("mixed", 128): 37.9e6,
    ("float16", 16): 14.2e6, ("float16", 32): 18.4e6,
    ("float16", 64): 22.17e6, ("float16", 128): 25.27e6,
}

# (A bytes, B bytes) per element by compute/storage mode.
_ELEM_BYTES = {"float32": (4, 4), "tf32": (4, 4), "mixed": (4, 2),
               "float16": (2, 2), "bfloat16": (2, 2)}


def load_calibration(path_or_dict) -> None:
    """Replace the measured model constants with a calibration produced
    by scripts/calibrate.py (JSON path or parsed dict).  Set the
    ``BSMR_SDDMM_CALIBRATION`` environment variable to auto-load at
    import time.  The shipped constants hold for the card they were
    measured on; re-run the probes on other hardware."""
    global STREAM_GBPS, _SRC_F
    import json
    from pathlib import Path

    cal = (path_or_dict if isinstance(path_or_dict, dict)
           else json.loads(Path(path_or_dict).read_text()))
    if "stream_gbps" in cal:
        STREAM_GBPS = float(cal["stream_gbps"])
    for rb, rate in cal.get("row_rate_8mb", {}).items():
        _ROW_RATE_8MB[int(rb)] = float(rate)
    if cal.get("src_factor"):
        # factors are measured relative to the 8 MB base rate, so the
        # grid must carry the 8 MB = 1.0 anchor explicitly
        fac = {float(mb): float(f) for mb, f in cal["src_factor"].items()}
        fac.setdefault(8.0, 1.0)
        pts = sorted(fac.items())
        _SRC_MB_local = [0.0] + [mb for mb, _ in pts] + [1e9]
        _SRC_F_local = ([pts[0][1]] + [f for _, f in pts]
                        + [pts[-1][1]])
        _SRC_F = np.array(_SRC_F_local)
        globals()["_SRC_MB"] = np.array(_SRC_MB_local)
    # explicit keys first, then derived rates (mixed = 2-pass bf16,
    # float16 = 3-pass bf16) only where not explicitly measured
    explicit = {}
    for key, rate in cal.get("dot_g16_ms", {}).items():
        dt, m = key.split(",")
        explicit[(dt, int(m))] = float(rate) * 1e6
    _DOT_G16_MS.update(explicit)
    for (dt, m), rate in explicit.items():
        if dt == "bfloat16" and ("mixed", m) not in explicit:
            _DOT_G16_MS[("mixed", m)] = rate / 2.0
        if dt == "bfloat16" and ("float16", m) not in explicit:
            _DOT_G16_MS[("float16", m)] = rate / 3.0


def _maybe_autoload():
    import os
    path = os.environ.get("BSMR_SDDMM_CALIBRATION")
    if path:
        load_calibration(path)


_maybe_autoload()


def _row_rate(row_bytes: float, src_mb: float) -> float:
    """Gather descriptors/second for XLA take."""
    keys = sorted(_ROW_RATE_8MB)
    rb = min(keys, key=lambda k: abs(np.log(max(row_bytes, 1) / k)))
    base = _ROW_RATE_8MB[rb] * 1e6
    f = float(np.interp(src_mb, _SRC_MB, _SRC_F))
    return base * f


def _take_ms(rows: float, row_bytes: float, src_bytes: float) -> float:
    if rows <= 0:
        return 0.0
    payload = rows * row_bytes
    t_rows = rows / _row_rate(row_bytes, src_bytes / 1e6)
    t_write = payload / (STREAM_GBPS * 1e9)
    return max(t_rows, t_write) * 1e3


@dataclasses.dataclass
class TunedConfig:
    alpha: float
    delta: float
    merge_superpanels: bool
    group_size: int
    k_chunks: int
    est_ms: float
    packed: Optional[PackedMatrix]   # None for the dense class
    bsmr: Optional[BSMR]
    measured_ms: Optional[float] = None
    hub_cols: int = 0
    # hot-row dense slab rows (pre-tiling selection, reorder/pack.py);
    # the packed matrix embeds the slab, this records the knob
    hot_rows: int = 0
    # "panels": A pre-relayouted to reordered panel-major order; one
    # 16-row gather per panel instead of 16 row gathers
    # (ops/hybrid.py).  Shootout-arbitrated.
    a_layout: str = "rows"
    # Dense-tiling strategy (ops/dense.DenseSDDMM): one full (M, N)
    # dot, zero index gathers — the true-DLMC density class.
    # ``packed``/``bsmr`` are None for this class.  Shootout-arbitrated.
    dense: bool = False


def estimate_ms(packed: PackedMatrix, k: int,
                compute_dtype: str = "tf32", k_chunks: int = 1) -> float:
    """Predicted single-chip kernel time (ms) for one hybrid SDDMM call."""
    a_el, b_el = _ELEM_BYTES[compute_dtype]
    G, NG, C = packed.group_size, packed.num_col_groups, int(k_chunks)
    kc = k // C
    LG = GROUP_LANES // G
    n_tiles = (packed.num_super + packed.num_quads
               + packed.num_pairs + packed.num_groups)

    # B gathers: LG group rows per tile per chunk.
    b_src = (NG + 1) * G * kc * b_el
    b_rows = n_tiles * LG
    t_b = C * _take_ms(b_rows, G * kc * b_el, b_src)
    # A gathers: full-K rows, once per container (run-major layout).
    a_rows = (sum(n * 128 for _, _, n in packed.super_buckets)
              + sum(n * 64 for _, _, n in packed.quad_buckets)
              + sum(n * 32 for _, _, n in packed.pair_buckets)
              + sum(n * 16 for _, _, n in packed.group_buckets))
    a_src = (packed.m + 1) * k * a_el
    t_a = _take_ms(a_rows, k * a_el, a_src)
    # Residual gathers: A row once, B group row per chunk.
    nR = packed.nnz_res
    t_r = _take_ms(nR, k * a_el, a_src) \
        + C * _take_ms(nR, G * kc * b_el, b_src)

    # Streaming: the dot re-reads the gathered operands and writes tiles;
    # residual elementwise + reduce.
    from bsmr_sddmm.reorder.pack import PAIR_CELLS, QUAD_CELLS
    H = packed.hub_cols
    cells = (packed.num_super * SUPER_CELLS
             + packed.num_quads * QUAD_CELLS
             + packed.num_pairs * PAIR_CELLS
             + packed.num_groups * GROUP_CELLS)
    gathered = (n_tiles * GROUP_LANES * k * b_el + a_rows * k * a_el) \
        + nR * (k * a_el + G * k * b_el)
    # Hub slab: contiguous B-slice + A re-read + slab write, all at
    # stream bandwidth (no descriptors).
    slab_bytes = (H * k * b_el + packed.m * k * a_el * min(C, 1)
                  + packed.m * H * 4) if H else 0
    if packed.rowslab_nrows:
        # hot-row slab: B cold-slice read + hot-A read + slab write
        slab_bytes += (packed.rowslab_width * k * b_el
                       + packed.rowslab_nrows * k * a_el
                       + packed.rowslab_nrows * packed.rowslab_width * 4)
    stream_bytes = gathered + cells * 4 * (2 * C - 1) + nR * 4 + slab_bytes
    t_stream = stream_bytes / (STREAM_GBPS * 1e6)

    t_dot = dot_ms(packed, k, compute_dtype)

    t_gather = t_b + t_a + t_r
    # Gathers and streaming barely overlap; the dots overlap with gathers.
    return t_gather + t_stream + max(t_dot - t_gather, 0.0)


def dot_ms(packed: PackedMatrix, k: int,
           compute_dtype: str = "tf32") -> float:
    """Modeled matmul time (ms) of a packing's batched dots + hub slab, at
    the measured per-height batched-dot rates (_DOT_G16_MS).  Used by
    estimate_ms and scripts/probe_breakdown.py."""
    H = packed.hub_cols
    rate128 = _DOT_G16_MS[(compute_dtype, 128)]
    t_dot = (packed.num_groups / _DOT_G16_MS[(compute_dtype, 16)]
             + packed.num_pairs * 2 / _DOT_G16_MS[(compute_dtype, 32)]
             + packed.num_quads * 4 / _DOT_G16_MS[(compute_dtype, 64)]
             + packed.num_super * 8 / rate128) \
        * 1e3 * (k / 128.0)
    if H:
        # slab = (m, K) x (K, H) matmul: (m/16)*(H/128) 16-row groups
        t_dot += (packed.m / 16.0) * (H / 128.0) / rate128 \
            * 1e3 * (k / 128.0)
    if packed.rowslab_nrows:
        # hot-row slab = (R, K) x (K, S) matmul
        t_dot += (packed.rowslab_nrows / 16.0) \
            * (packed.rowslab_width / 128.0) / rate128 \
            * 1e3 * (k / 128.0)
    return t_dot


def estimate_dense_ms(m: int, n: int, k: int,
                      compute_dtype: str = "tf32") -> float:
    """Modeled time (ms) for the dense-tiling strategy: one
    (M, K) x (K, N) dot with the full (M, N) fp32 output as the
    native layout.  Streaming is the A + B read plus the (M, N) write;
    the matmul term uses the measured 128-tall batched-dot rate.  A single
    large dot overlaps its operand streaming, so the estimate is the
    max of the two, not the sum (unlike the gather-fed hybrid model)."""
    a_el, b_el = _ELEM_BYTES[compute_dtype]
    stream = m * k * a_el + n * k * b_el + m * n * 4
    t_stream = stream / (STREAM_GBPS * 1e6)
    rate128 = _DOT_G16_MS[(compute_dtype, 128)]
    t_dot = (m / 16.0) * (n / 128.0) / rate128 * 1e3 * (k / 128.0)
    return max(t_stream, t_dot)


def descriptor_floor_ms(packed: PackedMatrix, k: int,
                        compute_dtype: str = "tf32", k_chunks: int = 1,
                        a_layout: str = "rows") -> float:
    """Gather-rate floor for this packing: the time XLA's take needs to
    fetch the configuration's gathered rows at the measured rate for
    the config's ACTUAL row widths and gather-source footprints (the
    same (width, footprint) tables estimate_ms prices with, from
    scripts/calibrate.py)."""
    a_el, b_el = _ELEM_BYTES[compute_dtype]
    G, C = packed.group_size, int(k_chunks)
    kc = k // C
    LG = GROUP_LANES // G
    n_tiles = (packed.num_super + packed.num_quads
               + packed.num_pairs + packed.num_groups)
    # B stream: LG group descriptors per tile per chunk + one per
    # residual entry per chunk, at the grouped-B^T width and footprint.
    b_bytes = G * kc * b_el
    b_src_mb = (packed.num_col_groups + 1) * b_bytes / 1e6
    b_rows = n_tiles * LG + packed.nnz_res
    t_b = C * b_rows / _row_rate(b_bytes, b_src_mb)
    # A stream: per-row (or per-panel) full-K descriptors + residual.
    a_src_mb = (packed.m + 1) * k * a_el / 1e6
    if a_layout == "panels":
        # containers fetch one 16-row panel descriptor per panel
        # (super=8 panels, quad=4, pair=2, group=1)
        a_rows = (sum(n * 8 for _, _, n in packed.super_buckets)
                  + sum(n * 4 for _, _, n in packed.quad_buckets)
                  + sum(n * 2 for _, _, n in packed.pair_buckets)
                  + sum(n * 1 for _, _, n in packed.group_buckets))
        t_a = a_rows / _row_rate(16 * k * a_el, a_src_mb)
    else:
        a_rows = (sum(n * 128 for _, _, n in packed.super_buckets)
                  + sum(n * 64 for _, _, n in packed.quad_buckets)
                  + sum(n * 32 for _, _, n in packed.pair_buckets)
                  + sum(n * 16 for _, _, n in packed.group_buckets))
        t_a = a_rows / _row_rate(k * a_el, a_src_mb)
    # residual A-row descriptors (full-K rows from the padded A source)
    t_ra = packed.nnz_res / _row_rate(k * a_el, a_src_mb)
    return (t_b + t_a + t_ra) * 1e3


def _candidate_layouts(n: int, k: int, compute_dtype: str):
    """(G, C) candidates: descriptor width near the 256-512 B sweet spot,
    source footprint near/below the fast-gather window."""
    el = _ELEM_BYTES[compute_dtype][1]  # B-side storage drives the layout
    gs = {1}
    for target in (256, 512):
        g = max(1, target // (k * el))
        if g > 1:
            gs.add(1 << int(np.floor(np.log2(g))))
    cs = {1}
    src_mb = n * k * el / 1e6
    if src_mb > 12.0:
        # chunk counts bracketing the ~8 MB fast-gather window
        for c in (1 << int(np.floor(np.log2(src_mb / 8.0))),
                  1 << int(np.ceil(np.log2(src_mb / 8.0)))):
            while c > 1 and k % c:
                c //= 2
            if 1 < c <= 8:
                cs.add(c)
    return sorted(gs), sorted(cs)


def hub_candidates(csr: CSR, k: int, compute_dtype: str = "tf32",
                   cell_cap: int = 32_000_000) -> list:
    """Hub-slab widths worth trying for this matrix: the largest H
    (multiple of 128) such that even the H-th-degree column still saves
    more gather-descriptor time than its slab column costs (one m-row
    matmul lane strip + the slab write), capped so the slab stays a
    bounded fraction of the packed output.  Returns [] when no column
    clears the bar (block-structured matrices)."""
    a_el, b_el = _ELEM_BYTES[compute_dtype]
    deg = np.sort(np.bincount(csr.col_idx, minlength=csr.n))[::-1]
    m_eff = int(np.count_nonzero(csr.row_nnz())) or 1
    num_panels = max(-(-m_eff // 16), 1)
    rate128 = _DOT_G16_MS[(compute_dtype, 128)]
    # ns per slab column: write m cells + the (m x K) x (K x 1) strip
    slab_ns = (m_eff * 4 / (STREAM_GBPS)
               + (m_eff / 16.0) * (k / 128.0) / 128.0 / rate128 * 1e9)
    # ns saved per hub column: one descriptor per panel it appears in
    desc_ns = 1e9 / _row_rate(max(k * b_el, 1), 8.0)
    save_ns = np.minimum(deg, num_panels) * desc_ns
    profitable = save_ns > slab_ns
    h_star = int(np.count_nonzero(profitable))
    if h_star <= 0:
        return []
    # round UP to the 128-lane tile granularity (a few very dense columns
    # still deserve a minimum-width slab; the ride-along lanes are cheap)
    h_star = min(-(-h_star // 128) * 128, cell_cap // max(csr.m, 1),
                 csr.n // 128 * 128)
    if h_star <= 0:
        return []
    # the per-column model undercounts second-order wins (smaller dense
    # lists shrink tiles below chunk boundaries), so 2*h_star is also
    # worth a try; the est ranking / shootout arbitrates
    out = [h_star]
    if h_star >= 512:
        out.append(h_star // 2 // 128 * 128)
    twice = min(2 * h_star, cell_cap // max(csr.m, 1), csr.n) // 128 * 128
    if twice > h_star:
        out.append(twice)
    return out


def autotune_multi(csr: CSR, ks: Sequence[int],
                   alphas: Sequence[float] = (0.1, 0.3, 0.5),
                   deltas: Sequence[float] = (0.0, 0.05, 0.3),
                   merges: Sequence[bool] = (False, True),
                   compute_dtype: str = "tf32",
                   method: str = "auto",
                   measure: bool = False,
                   measure_top: int = 3,
                   measure_iterations: int = 30,
                   allow_dense: bool = True,
                   verbose: bool = False) -> dict:
    """Pick (alpha, delta, merge, G, C) minimizing modeled kernel time,
    for every K in ``ks`` at once; with ``measure=True`` the top
    ``measure_top`` candidates per K are timed on the device and the
    fastest wins (the reference's empirical sweep, src/sddmm.cu:62-118,
    guided by the model).

    Packing is K-independent, so candidate packs are built once per
    (alpha, G, delta, merge) and shared across Ks; row reordering is
    computed once per alpha and reused across deltas (the same reuse
    trick as the reference's test mode).  Returns {k: TunedConfig}."""
    import copy

    layouts = {k: _candidate_layouts(csr.n, k, compute_dtype) for k in ks}
    all_gs = sorted({g for k in ks for g in layouts[k][0]})
    col_order_cache: dict[float, np.ndarray] = {}  # keyed by alpha
    packs: list[tuple] = []  # (alpha, g, delta, merge, hub, packed, bsmr)
    hubs_all = sorted({h for k in ks
                       for h in hub_candidates(csr, k, compute_dtype)})

    from bsmr_sddmm.reorder.cols import cluster_columns, hub_first_rank
    for alpha in alphas:
        base = BSMR(alpha, 0.0, csr, method=method, compute=False)
        base.run_row_reordering(csr)
        for g in all_gs:
            if g > 1 and alpha not in col_order_cache:
                col_order_cache[alpha] = cluster_columns(csr, alpha,
                                                         method=method)
            base_order = col_order_cache.get(alpha) if g > 1 else None
            for hc in [0] + [h for h in hubs_all if h % g == 0]:
                if hc > 0:
                    rank = hub_first_rank(csr, hc, base_order=base_order)
                elif base_order is not None:
                    rank = np.empty(csr.n, dtype=np.int64)
                    rank[base_order] = np.arange(csr.n)
                else:
                    rank = None
                bsmr = BSMR(alpha, 0.0, csr, method=method, compute=False,
                            group_size=g, col_rank=rank, hub_cols=hc)
                bsmr.reordered_rows = base.reordered_rows
                bsmr.cluster_ids = base.cluster_ids
                bsmr.num_clusters = base.num_clusters
                bsmr.row_reordering_ms = base.row_reordering_ms
                # hub slab + superpanel merging interact weakly; halve
                # the hub pack count by fixing merge=True there
                merges_hc = merges if hc == 0 else (True,)
                for delta in deltas:
                    bsmr.run_col_reordering(csr, delta=delta)
                    for merge in merges_hc:
                        # light pack: candidates only need the layout /
                        # est_ms / packed-order kernel inputs; the
                        # winner is re-packed with full metadata below
                        packed = pack(csr, bsmr, merge_superpanels=merge,
                                      compute_dtype=compute_dtype,
                                      full_metadata=False)
                        packs.append((alpha, g, delta, merge, hc, packed,
                                      copy.copy(bsmr)))

    # Hot-row slab candidate: on matrices with skewed row
    # degrees the carve otherwise covers the hot rows' scattered tail
    # with nearly-empty tiles (measured 0.9% fill on the power-law
    # bench matrix); one pre-tiling slab pack enters the shootout and
    # measurement arbitrates.  Built once (K-independent).
    rowslab_pack = None
    deg = np.diff(csr.row_ptr)
    R_slab = 1024
    if csr.m > 2 * R_slab and csr.nnz:
        share = float(np.sort(deg)[::-1][:R_slab].sum()) / csr.nnz
        if share >= 0.3:
            hc0 = max([h for h in hubs_all] or [0])
            try:
                t0 = from_params(
                    csr, ks[0], alpha=alphas[0], delta=0.05,
                    hub_cols=hc0, compute_dtype=compute_dtype,
                    method=method, hot_rows=R_slab, hot_rows_pre=True)
                rowslab_pack = (alphas[0], hc0, t0.packed, t0.bsmr)
            except Exception as e:  # noqa: BLE001 — candidate only
                import warnings as _w
                _w.warn(f"rowslab candidate skipped: {e}")

    out = {}
    for k in ks:
        gs_k, cs_k = layouts[k]
        candidates: list[TunedConfig] = []
        if rowslab_pack is not None:
            a0, hc0, pk0, bs0 = rowslab_pack
            candidates.append(TunedConfig(
                a0, 0.05, True, 1, 1,
                estimate_ms(pk0, k, compute_dtype, 1), pk0, bs0,
                hub_cols=hc0, hot_rows=R_slab))
        for (alpha, g, delta, merge, hc, packed, bsmr) in packs:
            if g not in gs_k:
                continue
            for c in cs_k:
                est = estimate_ms(packed, k, compute_dtype, c)
                if verbose:
                    print(f"  k={k} a={alpha} d={delta} G={g} C={c} "
                          f"merge={merge} H={hc}: nS={packed.num_super} "
                          f"nG={packed.num_groups} "
                          f"res={packed.nnz_res} est={est:.3f}ms")
                candidates.append(TunedConfig(
                    alpha, delta, merge, g, c, est, packed, bsmr,
                    hub_cols=hc))
        candidates.sort(key=lambda t: t.est_ms)
        # Dense-tiling candidate: enters only in the DLMC density class
        # (the strategy's target regime; below it the m*n cells dwarf
        # the nnz-proportional work at any realistic scale) and when the
        # model puts it within 2x of the best packed candidate; est-only
        # mode picks by model, measured mode arbitrates on the device.
        density = csr.nnz / float(max(csr.m * csr.n, 1))
        d_est = estimate_dense_ms(csr.m, csr.n, k, compute_dtype)
        if allow_dense and density >= 0.05 and candidates \
                and d_est < 2.0 * candidates[0].est_ms:
            candidates.append(TunedConfig(0.0, 0.0, False, 1, 1, d_est,
                                          None, None, dense=True))
            candidates.sort(key=lambda t: t.est_ms)
        if not measure:
            out[k] = candidates[0]
        else:
            out[k] = _shootout(csr, k, candidates, compute_dtype,
                               measure_top, measure_iterations, verbose)
        win = out[k]
        if win.packed is not None and win.packed.packed_rows is None:
            # re-pack the winner with full (CSR-order/consumer) metadata
            win.packed = pack(csr, win.bsmr,
                              merge_superpanels=win.merge_superpanels,
                              compute_dtype=compute_dtype)
    return out


def from_params(csr: CSR, k: int, alpha: float, delta: float,
                group_size: int = 1, k_chunks: int = 1,
                merge_superpanels: bool = True,
                compute_dtype: str = "tf32",
                method: str = "auto",
                hub_cols: int = 0,
                window_dp: bool = True,
                sort_runs: str = "cid",
                sort_res: str = "csr",
                b_cost_scale: float = 1.0,
                hot_rows: int = 0,
                hot_rows_pre: bool = False) -> TunedConfig:
    """Build a TunedConfig for an explicit (alpha, delta, G, C, merge)
    choice — the deterministic path bench.py uses with the committed
    per-matrix configs (results/tuned_configs.json), mirroring the
    reference's fixed Options defaults (include/Options.hpp:38-41)."""
    rank = None
    base_order = None
    if group_size > 1:
        from bsmr_sddmm.reorder.cols import cluster_columns
        base_order = cluster_columns(csr, alpha, method=method)
    if hub_cols > 0:
        from bsmr_sddmm.reorder.cols import hub_first_rank
        rank = hub_first_rank(csr, hub_cols, base_order=base_order)
    elif base_order is not None:
        rank = np.empty(csr.n, dtype=np.int64)
        rank[base_order] = np.arange(csr.n)
    hot_ids = None
    cluster_csr = csr
    if hot_rows > 0 and hot_rows_pre:
        # Pre-tiling hot-row selection: the R rows with the largest
        # NON-hub degree go to the dense hot-row slab, and their
        # entries are removed from the clustering/carve input so no
        # (mostly-empty) tiles get built around them — the power-law
        # failure mode where the carve covers 650k scattered entries
        # with 70M tile cells and 440k gathered rows).
        from bsmr_sddmm.data.sparse import COO
        rows_all = csr.row_indices().astype(np.int64)
        nonhub = (rank[csr.col_idx] >= hub_cols
                  if (hub_cols > 0 and rank is not None)
                  else np.ones(csr.nnz, dtype=bool))
        deg = np.bincount(rows_all[nonhub], minlength=csr.m)
        hot_ids = np.argsort(-deg, kind="stable")[:hot_rows]
        hot_ids = np.sort(hot_ids[deg[hot_ids] > 0])
        hot_mask = np.zeros(csr.m, dtype=bool)
        hot_mask[hot_ids] = True
        keep = ~hot_mask[rows_all]
        cluster_csr = COO(csr.shape, rows_all[keep],
                          csr.col_idx[keep].astype(np.int64),
                          csr.values[keep]).to_csr()
    bsmr = BSMR(alpha, delta, cluster_csr, method=method,
                group_size=group_size, col_rank=rank, hub_cols=hub_cols)
    packed = pack(csr, bsmr, k_hint=k, merge_superpanels=merge_superpanels,
                  compute_dtype=compute_dtype, window_dp=window_dp,
                  sort_runs=sort_runs, sort_res=sort_res,
                  b_cost_scale=b_cost_scale,
                  hot_rows=0 if hot_ids is not None else hot_rows,
                  hot_row_ids=hot_ids)
    return TunedConfig(alpha, delta, merge_superpanels, group_size,
                       k_chunks, estimate_ms(packed, k, compute_dtype,
                                             k_chunks), packed, bsmr,
                       hub_cols=hub_cols)


def autotune(csr: CSR, k: int = 128,
             alphas: Sequence[float] = (0.1, 0.3, 0.5),
             deltas: Sequence[float] = (0.0, 0.05, 0.3),
             merges: Sequence[bool] = (False, True),
             compute_dtype: str = "tf32",
             method: str = "auto",
             measure: bool = False,
             measure_top: int = 3,
             measure_iterations: int = 30,
             allow_dense: bool = True,
             verbose: bool = False) -> TunedConfig:
    """Single-K convenience wrapper over autotune_multi."""
    return autotune_multi(
        csr, (k,), alphas=alphas, deltas=deltas, merges=merges,
        compute_dtype=compute_dtype, method=method, measure=measure,
        measure_top=measure_top, measure_iterations=measure_iterations,
        allow_dense=allow_dense, verbose=verbose)[k]


def _shootout(csr, k, candidates, compute_dtype, measure_top,
              measure_iterations, verbose):
    """On-device shoot-out: the model's overall top picks PLUS the best
    candidate of every distinct (merge, G, C) shape class, delta, and
    alpha — gather cost is index-distribution-dependent (hot rows
    cache), so the model's ranking across classes is approximate and
    measurement arbitrates."""
    import copy

    finalists: list[TunedConfig] = []
    seen_cls: set = set()
    seen_delta: set = set()
    seen_alpha: set = set()
    for cand in candidates:
        cls = (cand.merge_superpanels, cand.group_size, cand.k_chunks,
               cand.hub_cols, cand.hot_rows, cand.dense)
        take_it = (len(finalists) < measure_top or cls not in seen_cls
                   or cand.delta not in seen_delta
                   or cand.alpha not in seen_alpha)
        if take_it and cand not in finalists:
            finalists.append(cand)
            seen_cls.add(cls)
            seen_delta.add(cand.delta)
            seen_alpha.add(cand.alpha)
        if len(finalists) >= measure_top + 6:
            break

    # Panel-major A relayout on trial: twin the top packed candidate
    # with a_layout="panels" (one gather per 16-row panel on
    # consecutive-panel containers).  The dense class has no variant.
    for cand in [f for f in finalists if not f.dense][:1]:
        if cand.a_layout == "rows" and \
                cand.packed.cont_panel_off is not None:
            twin = copy.copy(cand)
            twin.a_layout = "panels"
            finalists.append(twin)

    from bsmr_sddmm.data import generate
    from bsmr_sddmm.ops.hybrid import HybridSDDMM
    a = generate.make_dense(csr.m, k, seed=1)
    b = generate.make_dense(k, csr.n, seed=2)
    out = []
    for cand in finalists:
        if cand.dense:
            from bsmr_sddmm.ops.dense import DenseSDDMM
            runner = DenseSDDMM.from_csr(csr, compute_dtype=compute_dtype)
        else:
            runner = HybridSDDMM(cand.packed, compute_dtype=compute_dtype,
                                 k_chunks=cand.k_chunks,
                                 a_layout=cand.a_layout)
        a_pad, bt_phys = runner.prepare_operands(a, b=b)
        cand = copy.copy(cand)
        cand.measured_ms = runner.measure_kernel_ms(
            a_pad, bt_phys, iterations=measure_iterations, repeats=6)
        out.append(cand)
        if verbose:
            print(f"  measured a={cand.alpha} d={cand.delta} "
                  f"G={cand.group_size} C={cand.k_chunks} "
                  f"H={cand.hub_cols} "
                  f"aL={cand.a_layout} dense={cand.dense} "
                  f"merge={cand.merge_superpanels}: "
                  f"{cand.measured_ms:.3f}ms (est {cand.est_ms:.3f})")
    out.sort(key=lambda t: t.measured_ms)
    return out[0]
