"""Hybrid dense-block + sparse-residual SDDMM — the flagship path.

Reference counterpart: the two concurrently-streamed CUDA kernels
(src/sddmmKernel.cu:2540-2663 — WMMA dense blocks at :213/:355 and the
2-thread-per-nnz residual at :1994/:2109).  This implementation is plain
XLA:

- The dense path is batched matmuls over gathered operands:
  ``tiles[b] = A[rows(panel(b))] @ B[:, cols(b)]`` expressed as a
  ``dot_general`` ``bik,bjk->bij`` on gathers of A and the *grouped* B^T
  layout; XLA hands the batched dots to its GEMM emitters.
- B^T is stored grouped: one physical row holds the G similarity-clustered
  columns of a gather group (pack.py docstring), so one gathered row
  carries G columns.  Optionally the K dimension is split into C chunks.
- The residual path is a per-nnz gather-dot, fetching each entry's
  column group and selecting the member lane.
- Both live in one jitted program, which XLA schedules as one unit —
  the reference runs them on two streams.
- Results land in CSR order via a static permutation (``inv_idx``,
  reorder/pack.py): one per-entry gather — no scatter, no atomics.

Precision (``compute_dtype``) against the reference's abs 1e-5 / rel
1e-3 check (include/checkData.hpp:14-29) on U[0,2) data; the dot each
mode runs is in ``_PRECISION`` / ``tile_dot``, and the max_rel each mode
reached on the 20 bench configs is in PERF.md:

- ``"float32"``: fp32 storage, full-fp32 dot (``Precision.HIGHEST``).
- ``"tf32"`` (default): fp32 storage, the tensor cores' TF32 class
  (``Precision.HIGH``, 10 mantissa bits) — the reference's own
  fp32->tf32 demotion (src/sddmmKernel.cu:317-325).  Holds the contract
  on every bench config, with about 3x margin at K=32.
- ``"mixed"``: fp32 A, bfloat16 B storage, 2-pass split dot.
- ``"float16"``: fp16 storage, manual 3-pass bf16 dot.
- ``"bfloat16"``: native bf16 inputs, fp32 accumulation.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from bsmr_sddmm import config
from bsmr_sddmm.data.sparse import CSR
from bsmr_sddmm.reorder.bsmr import BSMR
from bsmr_sddmm.reorder.pack import GROUP_LANES, PackedMatrix, pack

PANEL_ROWS = config.ROW_PANEL_SIZE  # 16-row panels (pack.py carve unit)

#: dot precision per mode ("float16" and "mixed" run the manual split
#: dots of ``tile_dot`` and do not read it)
_PRECISION = {
    "float32": jax.lax.Precision.HIGHEST,
    "tf32": jax.lax.Precision.HIGH,
    "mixed": jax.lax.Precision.DEFAULT,
    "float16": jax.lax.Precision.DEFAULT,
    "bfloat16": jax.lax.Precision.DEFAULT,
}

# (A storage, B^T storage) per mode.  "mixed" keeps A exact and stores
# only the gather-dominant B^T operand in bfloat16, halving the bytes
# of every B gather.
_STORAGE = {"float32": (jnp.float32, jnp.float32),
            "tf32": (jnp.float32, jnp.float32),
            "mixed": (jnp.float32, jnp.bfloat16),
            "float16": (jnp.float16, jnp.float16),
            "bfloat16": (jnp.bfloat16, jnp.bfloat16)}


def _storage_dtypes(compute_dtype: str):
    return _STORAGE[compute_dtype]


def _storage_dtype(compute_dtype: str):
    """B-side storage dtype (the gather-dominant operand)."""
    return _STORAGE[compute_dtype][1]


def _split_bf16(x):
    """Split fp32/fp16 values into (hi, lo) bfloat16 so hi + lo carries
    >= 16 mantissa bits — exact for fp16 inputs up to the dropped lo*lo
    term (<= 2^-18 relative).

    The barrier on ``hi`` is load-bearing: XLA's excess-precision
    rewrite may elide the f32->bf16->f32 convert pair, turning ``lo``
    into exactly ``x - x = 0`` and silently collapsing the split to
    plain bf16.
    """
    xf = x.astype(jnp.float32)
    hi = jax.lax.optimization_barrier(xf.astype(jnp.bfloat16))
    lo = (xf - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    return hi, lo


def _bf16_dot(x, y, dimension_numbers):
    return jax.lax.dot_general(
        x, y, dimension_numbers=dimension_numbers,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT)


def tile_dot(a_c, bg, dimension_numbers, compute_dtype: str):
    """The one dot every SDDMM path runs, in ``compute_dtype``'s class.

    - ``"float16"``: 3-pass bfloat16 product of the hi/lo splits of both
      operands (>= 16 mantissa bits, exact for fp16 inputs).
    - ``"mixed"``: fp32 A split into bf16 hi/lo against the bf16 B —
      the terms of an upcast 3-pass dot, one pass less, with no fp32
      copy of the gathered B.  The barrier on the two products stops
      XLA's algebraic simplifier from merging dot(ah,b)+dot(al,b) into
      dot(ah+al,b), whose bf16 add would collapse the split.
    - otherwise one ``dot_general`` at ``_PRECISION[compute_dtype]``.
    """
    if compute_dtype == "float16":
        ah, al = _split_bf16(a_c)
        bh, bl = _split_bf16(bg)
        return (_bf16_dot(ah, bh, dimension_numbers)
                + _bf16_dot(ah, bl, dimension_numbers)
                + _bf16_dot(al, bh, dimension_numbers))
    if compute_dtype == "mixed":
        ah, al = _split_bf16(a_c)
        h, l = jax.lax.optimization_barrier(
            (_bf16_dot(ah, bg, dimension_numbers),
             _bf16_dot(al, bg, dimension_numbers)))
        return h + l
    return jax.lax.dot_general(
        a_c, bg, dimension_numbers=dimension_numbers,
        preferred_element_type=jnp.float32,
        precision=_PRECISION[compute_dtype])


@functools.partial(jax.jit,
                   static_argnames=("compute_dtype", "g", "kc",
                                    "super_buckets",
                                    "quad_buckets", "pair_buckets",
                                    "group_buckets", "h"))
def _hybrid_packed_jit(a_pad, bt_phys, super_rows, super_gids, quad_rows,
                       quad_gids, pair_rows, pair_gids, group_rows,
                       group_gids, res_rows, res_gids, res_member,
                       hub_start=None, a_panels=None, super_pst=None,
                       quad_pst=None, pair_pst=None, group_pst=None,
                       rowslab_rows=None,
                       compute_dtype="tf32", g=1, kc=0,
                       super_buckets=(), quad_buckets=(), pair_buckets=(),
                       group_buckets=(), h=0):
    """Hybrid SDDMM producing the *packed-order* flat value vector
    [supertiles ++ quads ++ pairs ++ groups ++ residual] in the run-major
    bucketed layout (reorder/pack.py) — the framework's native layout.

    a_pad: (M+1, K) with zero sentinel row.
    bt_phys: (C, NG+1, G*Kc) grouped/chunked B^T with zero sentinel rows
    (C*Kc == K); built by prepare_operands / device_prepare.
    Each ``*_buckets`` entry (b, start_tile, n_runs) describes a segment
    of containers with b 128-lane chunks each: A is gathered once per
    container and the batched dot runs at n = b*128 lanes.

    a_panels (optional): (num_panels+1, 16, K) — A pre-relayouted into
    reordered *panel-major* order (slot p holds the 16 rows of panel p;
    sentinel panel all-zero).  When given (with the per-run first-panel
    arrays ``*_pst``), containers fetch A with ONE 16-row panel
    descriptor per panel instead of 16 per-row descriptors — containers
    cover consecutive panels (the DP carve), so a run of height R needs
    only R/16 descriptors.  Rows of a short container beyond its member
    panels then read the *neighbouring* panel instead of the zero
    sentinel row: those slots carry garbage dot products, which the
    packed-order contract already allows (see HybridSDDMM docstring) —
    no real entry ever maps to a non-member-panel row slot.
    """
    adtype, bdtype = _storage_dtypes(compute_dtype)
    if adtype != a_pad.dtype:
        a_pad = a_pad.astype(adtype)
    if bdtype != bt_phys.dtype:
        bt_phys = bt_phys.astype(bdtype)
    C = bt_phys.shape[0]
    LG = GROUP_LANES // g

    # For grouped layouts the gathered B stays in its native 4-D view
    # (n, b*LG, G, kc) and the dot contracts kc directly, with no
    # (n, b*LG, G*kc) -> (n, b*128, kc) relayout copy.  The
    # (n, R, b*LG, G) output flattens in exactly the packed lane order
    # (lane = lgrp*G + member, reorder/pack.py).
    dnums = ((((2,), (2,)), ((0,), (0,))) if g == 1
             else (((2,), (3,)), ((0,), (0,))))

    def dot(a_c, bg, dnums=dnums):
        return tile_dot(a_c, bg, dnums, compute_dtype)

    # Per (family, bucket) segment: gather the run's A rows once, then
    # one batched (n_runs, R, Kc) x (n_runs, b*128, Kc) dot per K-chunk.
    segments = []
    for rows_arr, gids_arr, pst_arr, buckets in (
            (super_rows, super_gids, super_pst, super_buckets),
            (quad_rows, quad_gids, quad_pst, quad_buckets),
            (pair_rows, pair_gids, pair_pst, pair_buckets),
            (group_rows, group_gids, group_pst, group_buckets)):
        run_off = 0
        for (b, start, n_runs) in buckets:
            run_rows = jax.lax.slice_in_dim(
                rows_arr, start, start + n_runs * b, stride=b, axis=0)
            gids = jax.lax.slice_in_dim(
                gids_arr, start, start + n_runs * b, axis=0)
            gids = gids.reshape(n_runs, b * LG)
            if a_panels is not None:
                npan = rows_arr.shape[1] // PANEL_ROWS
                pst = jax.lax.slice_in_dim(pst_arr, run_off,
                                           run_off + n_runs)
                pids = pst[:, None] + jnp.arange(npan, dtype=jnp.int32)
                pids = jnp.minimum(pids, jnp.int32(a_panels.shape[0] - 1))
                a_run = jnp.take(a_panels, pids, axis=0).reshape(
                    n_runs, npan * PANEL_ROWS, a_panels.shape[2])
            else:
                a_run = jnp.take(a_pad, run_rows, axis=0)  # (n, R, K)
            run_off += n_runs
            out_shape = ((n_runs, rows_arr.shape[1], b * GROUP_LANES)
                         if g == 1
                         else (n_runs, rows_arr.shape[1], b * LG, g))
            acc = jnp.zeros(out_shape, jnp.float32)
            for c in range(C):
                bt_c = bt_phys[c]
                bg = jnp.take(bt_c, gids, axis=0)  # (n, b*LG, G*Kc)
                if g > 1:
                    bg = bg.reshape(n_runs, b * LG, g, kc)
                a_c = jax.lax.slice_in_dim(a_run, c * kc, (c + 1) * kc,
                                           axis=2)
                acc = acc + dot(a_c, bg)
            segments.append(acc.reshape(-1))

    # Dense hub slab: the leading h column ranks are computed as one
    # plain matmul per K-chunk against a *contiguous* slice of the
    # grouped B^T layout — zero gather descriptors (reorder/pack.py
    # "Dense hub slab"; cols.hub_first_rank).  hub_start is an
    # always-zero runtime scalar: routing the slice start through it
    # keeps the slab loop-body-resident under the timing harness
    # (a constant slice of loop-invariant operands would be hoisted).
    if h:
        hg = h // g
        m_rows = a_pad.shape[0] - 1
        a_real = jax.lax.slice_in_dim(a_pad, 0, m_rows, axis=0)
        start = (hub_start.astype(jnp.int32) if hub_start is not None
                 else jnp.int32(0))
        dn_h = ((((1,), (1,)), ((), ())) if g == 1
                else (((1,), (2,)), ((), ())))
        acc_h = jnp.zeros((m_rows, h) if g == 1 else (m_rows, hg, g),
                          jnp.float32)
        for c in range(C):
            bhub = jax.lax.dynamic_slice_in_dim(bt_phys[c], start, hg,
                                                axis=0)
            if g > 1:
                bhub = bhub.reshape(hg, g, kc)
            a_c = jax.lax.slice_in_dim(a_real, c * kc, (c + 1) * kc,
                                       axis=1)
            acc_h = acc_h + dot(a_c, bhub, dn_h)
        segments.append(acc_h.reshape(-1))

    # Hot-row dense slab (the hub's transpose, reorder/pack.py): the R
    # hottest rows against the FULL grouped B^T (all NG group rows) —
    # one gathered (R, K) A block, zero B descriptors.  rowslab_rows
    # arrives perturbed by the timing harness, so the dot cannot be
    # hoisted; the loop-invariant B slice hoisting is immaterial (a
    # slice is free).
    if rowslab_rows is not None:
        sg = bt_phys.shape[1] - 1
        a_hot = jnp.take(a_pad, rowslab_rows, axis=0)   # (R, K)
        nR_hot = rowslab_rows.shape[0]
        dn_s = ((((1,), (1,)), ((), ())) if g == 1
                else (((1,), (2,)), ((), ())))
        acc_s = jnp.zeros((nR_hot, sg) if g == 1 else (nR_hot, sg, g),
                          jnp.float32)
        for c in range(C):
            bslab = jax.lax.slice_in_dim(bt_phys[c], 0, sg, axis=0)
            if g > 1:
                bslab = bslab.reshape(sg, g, kc)
            a_c = jax.lax.slice_in_dim(a_hot, c * kc, (c + 1) * kc,
                                       axis=1)
            acc_s = acc_s + dot(a_c, bslab, dn_s)
        segments.append(acc_s.reshape(-1))

    # Residual: fetch the entry's column group, select the member lane
    # with a one-hot multiply-reduce (elementwise work XLA fuses into the
    # reduction).
    nR = res_rows.shape[0]
    a_res = jnp.take(a_pad, res_rows, axis=0)       # (nR, K)
    res = jnp.zeros((nR,), jnp.float32)
    if g > 1:
        onehot = (res_member[:, None]
                  == jnp.arange(g, dtype=jnp.int32)[None, :])
    for c in range(C):
        bt_c = bt_phys[c]
        br = jnp.take(bt_c, res_gids, axis=0)
        if g > 1:
            br = br.reshape(nR, g, kc).astype(jnp.float32)
            br = jnp.sum(br * onehot[:, :, None], axis=1)
        a_r = jax.lax.slice_in_dim(a_res, c * kc, (c + 1) * kc, axis=1)
        res = res + jnp.sum(
            a_r.astype(jnp.float32) * br.astype(jnp.float32), axis=-1)

    return jnp.concatenate(segments + [res])


@jax.jit
def _to_csr_order_jit(flat, inv_idx):
    """Reorder the packed flat vector into CSR entry order: one
    per-entry gather through ``inv_idx`` (the packed slot of each CSR
    entry)."""
    return jnp.take(flat, inv_idx)


def build_bt_phys(bt_pad: np.ndarray, packed: PackedMatrix,
                  k_chunks: int = 1) -> np.ndarray:
    """Host-side grouped/chunked B^T layout: (C, NG+1, G*Kc) fp32/bf16.

    bt_pad: (N+1, K) with zero sentinel row.  Physical group row g of
    chunk c holds [K-chunk c of col_order[g*G+0], ..., of col_order[g*G+
    G-1]]; the sentinel group row NG is all zeros (col_order sentinels
    point at bt_pad's zero row N).
    """
    G, NG = packed.group_size, packed.num_col_groups
    n_sent = bt_pad.shape[0] - 1
    k = bt_pad.shape[1]
    C = int(k_chunks)
    kc = k // C
    assert kc * C == k, f"K={k} not divisible by k_chunks={C}"
    order = np.where(packed.col_order < n_sent, packed.col_order, n_sent)
    arr = bt_pad[order]                              # (NG*G, K)
    arr = arr.reshape(NG, G, C, kc).transpose(2, 0, 1, 3)
    arr = np.ascontiguousarray(arr.reshape(C, NG, G * kc))
    sent = np.zeros((C, 1, G * kc), dtype=arr.dtype)
    return np.concatenate([arr, sent], axis=1)


@functools.partial(jax.jit, static_argnames=("g", "ng", "k_chunks"))
def device_bt_phys(bt_pad: jax.Array, col_order: jax.Array, g: int,
                   ng: int, k_chunks: int = 1) -> jax.Array:
    """In-jit equivalent of build_bt_phys for device-resident operands
    (used by models whose B is computed on device)."""
    k = bt_pad.shape[1]
    kc = k // k_chunks
    arr = jnp.take(bt_pad, col_order, axis=0)        # (NG*G, K)
    arr = arr.reshape(ng, g, k_chunks, kc).transpose(2, 0, 1, 3)
    arr = arr.reshape(k_chunks, ng, g * kc)
    sent = jnp.zeros((k_chunks, 1, g * kc), dtype=arr.dtype)
    return jnp.concatenate([arr, sent], axis=1)


def sddmm_hybrid(a, b, packed: PackedMatrix,
                 compute_dtype: str = "tf32") -> np.ndarray:
    """One-shot host convenience wrapper (numpy in / numpy out)."""
    runner = HybridSDDMM(packed, compute_dtype=compute_dtype)
    return np.asarray(runner(a, b))


class HybridSDDMM:
    """Reusable jitted hybrid SDDMM for a fixed sparsity packing.

    Keeps the packed index arrays resident on device so repeated calls
    (benchmark iterations, training steps) only ship A and B.

    Output layouts (``order``):

    - ``"packed"`` (native): the flat vector of dense-tile cells ++
      residual values, length ``packed.packed_size``.  Slots that are not
      nnz of S carry garbage dot products; consumers mask them via
      ``packed.packed_rows`` sentinels (see models/) — this is the layout
      all high-performance consumers should use, exactly like block-sparse
      formats in other SDDMM libraries.
    - ``"csr"``: values in CSR entry order of the input matrix (the
      reference's output convention).  Costs one device-side gather
      (``to_csr_order``).
    """

    def __init__(self, packed: PackedMatrix, compute_dtype: str = "tf32",
                 device=None, default_order: str = "packed",
                 k_chunks: int = 1, a_layout: str = "rows"):
        self.packed = packed
        self.compute_dtype = compute_dtype
        self.default_order = default_order
        self.k_chunks = int(k_chunks)
        if a_layout not in ("rows", "panels"):
            raise ValueError(f"unknown a_layout {a_layout!r}")
        if a_layout == "panels" and packed.cont_panel_off is None:
            raise ValueError("a_layout='panels' needs container topology "
                             "(packed.cont_panel_off)")
        self.a_layout = a_layout
        put = functools.partial(jax.device_put, device=device)
        if a_layout == "panels":
            # Per-run first-panel index per family, in bucketed-run
            # order: containers span consecutive panels (the DP carve),
            # so run i's A block is panels [pst[i], pst[i] + R/16).
            first_panel = packed.cont_panel_ids[packed.cont_panel_off[:-1]]
            self._fam_pst = {
                f: put(jnp.asarray(
                    first_panel[getattr(packed, f + "_run_cont")]
                    if len(getattr(packed, f + "_run_cont")) else
                    np.zeros(0, np.int64), dtype=jnp.int32))
                for f in ("super", "quad", "pair", "group")}
            self._a_panel_gather = put(jnp.asarray(
                np.where(packed.a_row_gather < packed.m,
                         packed.a_row_gather, packed.m), dtype=jnp.int32))
        else:
            self._fam_pst = {f: None
                             for f in ("super", "quad", "pair", "group")}
            self._a_panel_gather = None
        self._super_rows = put(jnp.asarray(packed.super_rows,
                                           dtype=jnp.int32))
        self._super_gids = put(jnp.asarray(packed.super_gids,
                                           dtype=jnp.int32))
        self._quad_rows = put(jnp.asarray(packed.quad_rows,
                                          dtype=jnp.int32))
        self._quad_gids = put(jnp.asarray(packed.quad_gids,
                                          dtype=jnp.int32))
        self._pair_rows = put(jnp.asarray(packed.pair_rows,
                                          dtype=jnp.int32))
        self._pair_gids = put(jnp.asarray(packed.pair_gids,
                                          dtype=jnp.int32))
        self._group_rows = put(jnp.asarray(packed.group_rows,
                                           dtype=jnp.int32))
        self._group_gids = put(jnp.asarray(packed.group_gids,
                                           dtype=jnp.int32))
        self._res_rows = put(jnp.asarray(packed.res_rows, dtype=jnp.int32))
        self._res_gids = put(jnp.asarray(packed.res_gids, dtype=jnp.int32))
        self._res_member = put(jnp.asarray(packed.res_member,
                                           dtype=jnp.int32))
        self._rowslab_rows = (put(jnp.asarray(packed.rowslab_rows,
                                              dtype=jnp.int32))
                              if packed.rowslab_rows is not None else None)
        self._col_order_dev = None
        self._inv_idx = put(jnp.asarray(packed.inv_idx, dtype=jnp.int32))
        self._packed_rows = (put(jnp.asarray(packed.packed_rows,
                                             dtype=jnp.int32))
                             if packed.packed_rows is not None else None)
        self._packed_cols = (put(jnp.asarray(packed.packed_cols,
                                             dtype=jnp.int32))
                             if packed.packed_cols is not None else None)

    @property
    def packed_rows(self) -> jax.Array:
        """(F,) original row id per packed slot (sentinel = m)."""
        if self._packed_rows is None:
            raise ValueError("light packing (full_metadata=False) has no "
                             "packed_rows; re-pack with full metadata")
        return self._packed_rows

    @property
    def packed_cols(self) -> jax.Array:
        """(F,) original col id per packed slot (sentinel = n)."""
        return self._packed_cols

    @functools.cached_property
    def is_identity_layout(self) -> bool:
        """True when bt_phys[0] is exactly bt_pad (G=1, C=1, no column
        clustering): legacy callers may pass plain (N+1, K) operands.
        Computed once (O(n) check) and cached."""
        p = self.packed
        return (p.group_size == 1 and self.k_chunks == 1
                and bool(np.array_equal(p.col_order,
                                        np.arange(p.n, dtype=np.int64))))

    def _norm_a(self, a_ops):
        """Normalize the A operand: plain (M+1, K) array, or the
        (a_pad, a_panels) pair produced by prepare_operands /
        device_prepare under ``a_layout='panels'``."""
        if isinstance(a_ops, (tuple, list)):
            # a rows-layout runner given panels-prepared operands just
            # ignores the relayout (it has no *_pst arrays to use it)
            return a_ops[0], (a_ops[1] if self.a_layout == "panels"
                              else None)
        if self.a_layout == "panels":
            raise ValueError(
                "a_layout='panels' operands must come from "
                "prepare_operands/device_prepare (need the panel-major "
                "A relayout)")
        return a_ops, None

    def prepare_operands(self, a, b=None, bt=None):
        """Pad A (M,K)->(M+1,K); build the grouped/chunked B^T layout
        (C, NG+1, G*Kc) — both as device arrays in the runner's storage
        dtype (fp16/bf16 modes halve the gather payload; the cast happens
        once here instead of on every call)."""
        a = np.asarray(a)
        if bt is None:
            bt = np.ascontiguousarray(np.asarray(b).T)
        else:
            bt = np.asarray(bt)
        a_pad = np.concatenate([a, np.zeros((1, a.shape[1]), a.dtype)])
        bt_pad = np.concatenate([bt, np.zeros((1, bt.shape[1]), bt.dtype)])
        bt_phys = build_bt_phys(bt_pad, self.packed, self.k_chunks)
        adt, bdt = _storage_dtypes(self.compute_dtype)
        a_dev = jnp.asarray(a_pad).astype(adt)
        if self.a_layout == "panels":
            k = a_pad.shape[1]
            ap = a_pad[np.asarray(self.packed.a_row_gather)]
            ap = np.concatenate([ap.reshape(-1, PANEL_ROWS, k),
                                 np.zeros((1, PANEL_ROWS, k), a_pad.dtype)])
            a_dev = (a_dev, jnp.asarray(ap).astype(adt))
        return a_dev, jnp.asarray(bt_phys).astype(bdt)

    def device_prepare(self, a_pad: jax.Array,
                       bt_pad: jax.Array) -> tuple:
        """Device-side counterpart of prepare_operands for operands that
        already live on device as (M+1, K) / (N+1, K) padded arrays."""
        adt, bdt = _storage_dtypes(self.compute_dtype)
        a_pad = a_pad.astype(adt)
        bt_pad = bt_pad.astype(bdt)
        a_dev = a_pad
        if self.a_layout == "panels":
            k = a_pad.shape[1]
            ap = jnp.take(a_pad, self._a_panel_gather, axis=0)
            ap = jnp.concatenate([ap.reshape(-1, PANEL_ROWS, k),
                                  jnp.zeros((1, PANEL_ROWS, k), a_pad.dtype)])
            a_dev = (a_pad, ap)
        if self.is_identity_layout:
            return a_dev, bt_pad[None]
        if self._col_order_dev is None:
            p = self.packed
            order = np.where(p.col_order < p.n, p.col_order, p.n)
            self._col_order_dev = jnp.asarray(order, dtype=jnp.int32)
        return a_dev, device_bt_phys(
            bt_pad, self._col_order_dev, self.packed.group_size,
            self.packed.num_col_groups, self.k_chunks)

    def __call__(self, a, b=None, bt=None, order: str = "csr"):
        """Host convenience: defaults to CSR order for drop-in parity."""
        a_pad, bt_phys = self.prepare_operands(a, b=b, bt=bt)
        return self.run_padded(a_pad, bt_phys, order=order)

    def run_padded(self, a_pad: jax.Array, bt_phys: jax.Array,
                   order: Optional[str] = None) -> jax.Array:
        """Device-resident fast path: operands already in framework
        layout (prepare_operands / device_prepare).  For backward
        compatibility a plain (N+1, K) bt is accepted when the packing
        uses the identity layout."""
        order = order or self.default_order
        a_pad, a_panels = self._norm_a(a_pad)
        if bt_phys.ndim == 2:
            if not self.is_identity_layout:
                raise ValueError(
                    "2-D bt operand requires identity layout; use "
                    "prepare_operands/device_prepare for grouped packing")
            bt_phys = bt_phys[None]
        k = a_pad.shape[1]
        kc = k // bt_phys.shape[0]
        flat = _hybrid_packed_jit(
            a_pad, bt_phys, self._super_rows, self._super_gids,
            self._quad_rows, self._quad_gids,
            self._pair_rows, self._pair_gids,
            self._group_rows, self._group_gids,
            self._res_rows, self._res_gids, self._res_member,
            hub_start=(jnp.int32(0) if self.packed.hub_cols else None),
            a_panels=a_panels,
            super_pst=self._fam_pst["super"],
            quad_pst=self._fam_pst["quad"],
            pair_pst=self._fam_pst["pair"],
            group_pst=self._fam_pst["group"],
            rowslab_rows=self._rowslab_rows,
            compute_dtype=self.compute_dtype,
            g=self.packed.group_size, kc=kc,
            super_buckets=self.packed.super_buckets,
            quad_buckets=self.packed.quad_buckets,
            pair_buckets=self.packed.pair_buckets,
            group_buckets=self.packed.group_buckets,
            h=self.packed.hub_cols)
        if order == "packed":
            return flat
        if order == "csr":
            return self.to_csr_order(flat)
        raise ValueError(f"unknown order {order!r}")

    def _require_csr_metadata(self) -> None:
        # light packs (pack(..., full_metadata=False), autotune
        # candidates) omit the CSR-order/consumer metadata; the packed-
        # order compute path never touches it
        if self.packed.csr_dest is None:
            raise ValueError("light packing (full_metadata=False) has no "
                             "CSR-order metadata; re-pack with full "
                             "metadata")

    def to_csr_order(self, flat: jax.Array) -> jax.Array:
        """Convert a packed-order flat value vector to CSR entry order."""
        self._require_csr_metadata()
        return _to_csr_order_jit(flat, self._inv_idx)

    def make_looped_fn(self, iterations: int, order: str = "packed"):
        """A jitted fn running the hybrid SDDMM ``iterations`` times inside
        one device program, for latency-free kernel timing (the wall clock
        around a single call measures host<->device round-trip, not kernel
        time).  A numerically-null but real data dependency chains the
        iterations so XLA cannot hoist or CSE the loop body:
        ``carry ~ 1e-38`` scales a sum of all outputs, and the operand is
        masked by an always-true predicate on the carry — opaque to the
        compiler, exact at runtime."""

        # The index arrays enter the jitted program as ARGUMENTS (one
        # pytree), never as closure constants: jit inlines closed-over
        # arrays into the HLO as literals, so at suite scale the module
        # would carry megabytes of constants (the powerlaw hub config's
        # nnz-sized inv_idx is ~4 MB) into every compile.
        idx = {
            "super_rows": self._super_rows, "super_gids": self._super_gids,
            "quad_rows": self._quad_rows, "quad_gids": self._quad_gids,
            "pair_rows": self._pair_rows, "pair_gids": self._pair_gids,
            "group_rows": self._group_rows, "group_gids": self._group_gids,
            "res_rows": self._res_rows, "res_gids": self._res_gids,
            "res_member": self._res_member,
            "pst": dict(self._fam_pst),
            "rowslab_rows": self._rowslab_rows,
        }
        if order == "csr":
            self._require_csr_metadata()
            idx["inv_idx"] = self._inv_idx

        def looped(a_pad, bt_phys, ix):
            a_pad, a_panels = self._norm_a(a_pad)
            if bt_phys.ndim == 2:
                bt_phys = bt_phys[None]
            k = a_pad.shape[1]
            kc = k // bt_phys.shape[0]

            def body(_, carry):
                # Perturb the (tiny) index arrays with an always-true
                # predicate on the carry: opaque to XLA (no hoisting/CSE
                # of the loop body), free at runtime.
                live = carry > jnp.float32(-1e30)

                def mask(ix_):
                    return jnp.where(live, ix_, jnp.zeros_like(ix_))

                def mask_opt(ix_):
                    return None if ix_ is None else mask(ix_)

                flat = _hybrid_packed_jit(
                    a_pad, bt_phys,
                    mask(ix["super_rows"]), mask(ix["super_gids"]),
                    mask(ix["quad_rows"]), mask(ix["quad_gids"]),
                    mask(ix["pair_rows"]), mask(ix["pair_gids"]),
                    mask(ix["group_rows"]), mask(ix["group_gids"]),
                    mask(ix["res_rows"]), mask(ix["res_gids"]),
                    mask(ix["res_member"]),
                    hub_start=(jnp.where(live, jnp.int32(0), jnp.int32(1))
                               if self.packed.hub_cols else None),
                    a_panels=a_panels,
                    super_pst=mask_opt(ix["pst"]["super"]),
                    quad_pst=mask_opt(ix["pst"]["quad"]),
                    pair_pst=mask_opt(ix["pst"]["pair"]),
                    group_pst=mask_opt(ix["pst"]["group"]),
                    rowslab_rows=mask_opt(ix["rowslab_rows"]),
                    compute_dtype=self.compute_dtype,
                    g=self.packed.group_size, kc=kc,
                    super_buckets=self.packed.super_buckets,
                    quad_buckets=self.packed.quad_buckets,
                    pair_buckets=self.packed.pair_buckets,
                    group_buckets=self.packed.group_buckets,
                    h=self.packed.hub_cols)
                if order == "csr":
                    flat = _to_csr_order_jit(flat, ix["inv_idx"])
                return jnp.sum(flat) * jnp.float32(1e-38)

            return jax.lax.fori_loop(0, iterations, body, jnp.float32(0.0))

        jitted = jax.jit(looped)
        return lambda a_pad, bt_phys: jitted(a_pad, bt_phys, idx)

    def measure_kernel_ms(self, a_pad, bt_phys, iterations: int = 50,
                          repeats: int = 3, order: str = "packed") -> float:
        """Average device kernel time (ms) via the looped-timing method:
        time N-iteration and 1-iteration programs and difference away the
        fixed dispatch/transfer latency (utils.timing.diff_time_ms)."""
        from bsmr_sddmm.utils.timing import diff_time_ms

        f_many = self.make_looped_fn(iterations, order=order)
        f_one = self.make_looped_fn(1, order=order)
        # the scalar fetch waits for the device to finish the loop
        return diff_time_ms(lambda: float(f_many(a_pad, bt_phys)),
                            lambda: float(f_one(a_pad, bt_phys)),
                            iterations, repeats)

    @staticmethod
    def from_csr(csr: CSR, alpha: float = config.DEFAULT_ALPHA,
                 delta: float = config.DEFAULT_DELTA,
                 compute_dtype: str = "tf32",
                 method: str = "auto") -> "HybridSDDMM":
        bsmr = BSMR(alpha, delta, csr, method=method)
        return HybridSDDMM(pack(csr, bsmr), compute_dtype=compute_dtype)
