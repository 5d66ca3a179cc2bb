"""Multi-chip hybrid SDDMM: the single-chip fast path sharded over a
``('rows', 'feat')`` mesh with ``shard_map``.

This is new capability vs the reference (single-GPU, SURVEY.md §2.3),
and it shards the *same* bucketed run-major packed layout the single-chip
kernel executes (reorder/pack.py) — not a second implementation:

- **'rows' axis (data parallel over S)**: containers (packed tile runs)
  are partitioned into contiguous panel-range *units* — one unit per
  container (containers may span any consecutive panels since the
  cross-window DP carve, reorder/pack.py) or per run of container-less
  panels — contiguous units per device, balanced by packed-cell weight.
  Each device holds only its panels' rows of A (gathered panel-local
  copy, sentinel-padded) and its own residual entries — per-device
  A/index/output memory scales ~1/R.
- **'feat' axis (tensor parallel over K)**: A and the grouped B^T layout
  are split into K-chunks (the same ``k_chunks`` machinery as single
  chip); each feat-device computes partial dot products over its chunks
  and one ``psum`` over 'feat' — the only collective in the hot path —
  reduces them.  The interconnect carries exactly the packed output once.
- The output **stays sharded** in packed order ``(R, F_loc)``; CSR entry
  order is an explicit opt-in conversion (``order="csr"``), exactly like
  the single-chip API.  Nothing all-gathers the flat value vector inside
  the step (verified by the HLO collective check in
  scripts/scaling_bench.py).

Padding uses sentinel rows/groups, so padded runs and residual slots
compute zeros and are dropped by the CSR conversion.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bsmr_sddmm.ops.hybrid import (_hybrid_packed_jit, _storage_dtypes,
                                  build_bt_phys)
from bsmr_sddmm.reorder.pack import GROUP_LANES, PackedMatrix

_FAMS = (  # (name, rows per tile)
    ("super", 128), ("quad", 64), ("pair", 32), ("group", 16))


class _ShardPlan:
    """Host-side partition of a PackedMatrix over R row-devices."""

    def __init__(self, packed: PackedMatrix, n_rows_devices: int):
        R = int(n_rows_devices)
        m = packed.m
        num_panels = packed.num_panels
        nC = len(packed.cont_panel_off) - 1

        # Partition units over the panel axis: one unit per container
        # (its full consecutive panel span — containers may cross old
        # 8-panel window boundaries under the DP carve) and one unit per
        # maximal run of container-less panels.  Unit boundaries
        # therefore never split a container.
        cont_of_panel = np.full(max(num_panels, 1), -1, dtype=np.int64)
        if nC:
            cont_of_panel[packed.cont_panel_ids.astype(np.int64)] = \
                np.repeat(np.arange(nC, dtype=np.int64),
                          np.diff(packed.cont_panel_off).astype(np.int64))
        starts = np.ones(max(num_panels, 1), dtype=bool)
        if num_panels > 1:
            starts[1:num_panels] = ~(
                (cont_of_panel[1:num_panels]
                 == cont_of_panel[:num_panels - 1])
                | ((cont_of_panel[1:num_panels] < 0)
                   & (cont_of_panel[:num_panels - 1] < 0)))
        unit_of_panel = np.cumsum(starts) - 1
        num_units = int(unit_of_panel[num_panels - 1]) + 1 \
            if num_panels else 1
        unit_of_cont = np.zeros(max(nC, 1), dtype=np.int64)
        if nC:
            unit_of_cont[:nC] = unit_of_panel[
                packed.cont_panel_ids[packed.cont_panel_off[:-1]]
                .astype(np.int64)]

        # panel of each original row (sentinel row m -> -1)
        panel_of_row = np.full(m + 1, -1, dtype=np.int64)
        ar = packed.a_row_gather.astype(np.int64)
        real = ar < m
        panel_of_row[ar[real]] = np.nonzero(real)[0] // 16

        # per-run records: (fam_idx, b, tile_start, cont_id)
        runs = {f: [] for f, _ in _FAMS}
        for fi, (fname, rows_h) in enumerate(_FAMS):
            buckets = getattr(packed, f"{fname}_buckets")
            run_cont = getattr(packed, f"{fname}_run_cont")
            ri = 0
            for (b, start, n) in buckets:
                for j in range(n):
                    runs[fname].append((b, start + j * b,
                                        int(run_cont[ri])))
                    ri += 1

        # unit weights: packed cells of each run + residual entries
        w = np.zeros(num_units, dtype=np.float64)
        for fname, rows_h in _FAMS:
            for (b, t0, cid) in runs[fname]:
                w[unit_of_cont[cid]] += rows_h * b * GROUP_LANES
        res_panel = panel_of_row[packed.res_rows.astype(np.int64)]
        res_unit = np.where(res_panel >= 0,
                            unit_of_panel[np.maximum(res_panel, 0)], 0)
        np.add.at(w, res_unit, 64.0)  # nominal residual weight

        # contiguous unit partition into R parts: sequential greedy cut —
        # each device takes units until its load reaches the average of
        # what remains, choosing the nearer boundary (floor cuts alone
        # pile the rounding remainder onto the last device when units
        # are coarse, e.g. DP supertile containers)
        cum = np.cumsum(w)
        total = cum[-1] if len(cum) else 0.0
        bounds = [0]
        for d in range(1, R):
            prev = bounds[-1]
            left = total - (cum[prev - 1] if prev else 0.0)
            target = (cum[prev - 1] if prev else 0.0) \
                + left / (R - d + 1)
            b = int(np.searchsorted(cum, target))
            if b > prev and abs(cum[b - 1] - target) <= \
                    abs((cum[b] if b < len(cum) else total) - target):
                b -= 1
            bounds.append(min(b + 1, num_units))
        bounds.append(num_units)
        # enforce monotone non-decreasing
        for i in range(1, len(bounds)):
            bounds[i] = max(bounds[i], bounds[i - 1])
        self.window_bounds = bounds
        dev_of_unit = np.zeros(num_units, dtype=np.int64)
        for d in range(R):
            dev_of_unit[bounds[d]:bounds[d + 1]] = d

        # panels / local A rows per device
        self.R = R
        panel_dev = dev_of_unit[unit_of_panel[:num_panels]] \
            if num_panels else np.zeros(0, dtype=np.int64)
        counts = np.bincount(panel_dev, minlength=R) if num_panels \
            else np.zeros(R, dtype=np.int64)
        self.rows_max = int(counts.max()) * 16 if num_panels else 16
        a_rows_local = np.full((R, self.rows_max), m, dtype=np.int32)
        # local slot of each original row (sentinel -> rows_max)
        local_of_row = np.full(m + 1, self.rows_max, dtype=np.int32)
        p0 = np.zeros(R, dtype=np.int64)
        for p in range(num_panels):
            d = panel_dev[p]
            s = p0[d]
            rows = ar[p * 16:(p + 1) * 16]
            a_rows_local[d, s:s + len(rows)] = rows
            rr = rows[rows < m]
            local_of_row[rr] = s + np.nonzero(rows < m)[0]
            p0[d] += 16
        self.a_rows_local = a_rows_local  # (R, rows_max) original ids
        self.panel_dev = panel_dev

        # per-family local tile arrays, uniform bucket structure
        NG = packed.num_col_groups
        G = packed.group_size
        LG = GROUP_LANES // G

        # Pass 1: bucket structure + per-device run lists per family, so
        # the flat destination map can be allocated ONCE (int32) instead
        # of concatenating per-segment int64 parts — the concat was the
        # dominant plan-build cost at suite scale (hundreds of MB of
        # first-touch allocations).
        self.local_buckets = {}
        fam_plan = {}
        flat_cells = 0
        for fname, rows_h in _FAMS:
            fruns = runs[fname]
            bsizes = []
            for (b, t0, cid) in fruns:
                if not bsizes or bsizes[-1] != b:
                    bsizes.append(b)
            # bucket sizes are sorted ascending and unique by construction
            dev_runs = {b: [[] for _ in range(R)] for b in bsizes}
            for (b, t0, cid) in fruns:
                dev_runs[b][dev_of_unit[unit_of_cont[cid]]].append(
                    (t0, cid))
            lb = []
            start_local = 0
            for b in bsizes:
                n_max = max(len(x) for x in dev_runs[b])
                if n_max == 0:
                    continue
                lb.append((b, start_local, n_max))
                flat_cells += n_max * rows_h * b * GROUP_LANES
                start_local += n_max * b
            self.local_buckets[fname] = tuple(lb)
            fam_plan[fname] = (dev_runs, start_local)

        H = packed.hub_cols
        # Hot-row slab partition: the (sentinel-padded) hot-row list is
        # split contiguously into R even parts — slab compute per row is
        # uniform (S cold columns each), so row count IS the balance
        # weight.  Each device's hot rows are APPENDED to its local A
        # copy after the sentinel block (prepare_operands), so the local
        # kernel reads them with one static slice, zero descriptors.
        self.rowslab_pad = 0
        self.rowslab_width = packed.rowslab_width
        self.rowslab_rows_local = None
        hot_dev = hot_loc = None
        if packed.rowslab_rows is not None:
            hot = packed.rowslab_rows[packed.rowslab_rows < m] \
                .astype(np.int64)
            rs_max = max(-(-len(hot) // R), 1)
            self.rowslab_pad = -(-rs_max // 16) * 16
            tbl = np.full((R, self.rowslab_pad), m, dtype=np.int64)
            hot_dev = np.full(m + 1, -1, dtype=np.int64)
            hot_loc = np.zeros(m + 1, dtype=np.int64)
            for d, part in enumerate(np.array_split(hot, R)):
                tbl[d, :len(part)] = part
                hot_dev[part] = d
                hot_loc[part] = np.arange(len(part), dtype=np.int64)
            self.rowslab_rows_local = tbl
        res_dev = np.where(res_panel >= 0, dev_of_unit[res_unit], 0)
        counts_r = np.bincount(res_dev, minlength=R)
        nR_max = max(int(counts_r.max()) if len(res_dev) else 0, 1)
        self.flat_local = (flat_cells + (self.rows_max * H if H else 0)
                           + self.rowslab_pad * self.rowslab_width
                           + nR_max)
        csr_dest = np.full((R, self.flat_local), packed.nnz,
                           dtype=np.int32)

        # Pass 2: fill tile arrays and the destination map in place.
        self.tile_rows = {}
        self.tile_gids = {}
        seg_off = 0
        for fname, rows_h in _FAMS:
            rows_arr = getattr(packed, f"{fname}_rows").astype(np.int64)
            gids_arr = getattr(packed, f"{fname}_gids").astype(np.int64)
            csr_arr = getattr(packed, f"{fname}_csr")
            dev_runs, tiles_local = fam_plan[fname]
            t_rows = np.full((R, tiles_local, rows_h), self.rows_max,
                             dtype=np.int32)
            t_gids = np.full((R, tiles_local, LG), NG, dtype=np.int32)
            for (b, start_local, n_max) in self.local_buckets[fname]:
                run_cells = rows_h * b * GROUP_LANES
                seg_dest = csr_dest[:, seg_off:seg_off
                                    + n_max * run_cells]
                # flatten (device, run) pairs and assign all runs at once
                d_arr = np.repeat(
                    np.arange(R, dtype=np.int64),
                    [len(dev_runs[b][d]) for d in range(R)])
                t0_arr = np.concatenate(
                    [np.asarray([t0 for (t0, _) in dev_runs[b][d]],
                                dtype=np.int64)
                     for d in range(R)]) if len(d_arr) else \
                    np.zeros(0, dtype=np.int64)
                j_arr = np.concatenate(
                    [np.arange(len(dev_runs[b][d]), dtype=np.int64)
                     for d in range(R)]) if len(d_arr) else \
                    np.zeros(0, dtype=np.int64)
                if len(d_arr):
                    nrb = len(d_arr)
                    tile_src = (t0_arr[:, None]
                                + np.arange(b, dtype=np.int64)).reshape(-1)
                    d_rep = np.repeat(d_arr, b)
                    slot = (start_local + j_arr[:, None] * b
                            + np.arange(b, dtype=np.int64)).reshape(-1)
                    # all b tiles of a run share the same rows; the
                    # run's first row sits at its first local panel's
                    # 16-row boundary (panel-blocked local A layout)
                    rloc = local_of_row[rows_arr[t0_arr]]  # (nrb, rows_h)
                    t_rows[d_rep, slot] = np.repeat(rloc, b, axis=0)
                    t_gids[d_rep, slot] = gids_arr[tile_src]
                    # run-major cells: (rows_h, b, 128) per run
                    cells = csr_arr[tile_src].reshape(
                        nrb, b, rows_h, GROUP_LANES).transpose(0, 2, 1, 3)
                    cells = np.where(cells >= 0, cells,
                                     packed.nnz).astype(np.int32)
                    seg_dest[d_arr[:, None],
                             j_arr[:, None] * run_cells
                             + np.arange(run_cells, dtype=np.int64)] = \
                        cells.reshape(nrb, run_cells)
                seg_off += n_max * run_cells
            self.tile_rows[fname] = t_rows
            self.tile_gids[fname] = t_gids

        # Per-run first LOCAL panel per family (a_layout="panels"):
        # containers occupy consecutive local panels (unit = whole
        # container on one device, and panel_dev is monotone so local
        # slots follow global panel order); padded runs carry the
        # sentinel panel rows_max/16.
        starts_d = np.searchsorted(panel_dev, np.arange(R)) \
            if num_panels else np.zeros(R, dtype=np.int64)
        local_panel = (np.arange(num_panels, dtype=np.int64)
                       - starts_d[panel_dev]) if num_panels else \
            np.zeros(0, dtype=np.int64)
        cfirst = (packed.cont_panel_ids[packed.cont_panel_off[:-1]]
                  .astype(np.int64) if nC else np.zeros(0, np.int64))
        sent_panel = self.rows_max // 16
        self.run_pst = {}
        for fname, rows_h in _FAMS:
            runs_local = sum(n_max for (_, _, n_max)
                             in self.local_buckets[fname])
            pst = np.full((R, runs_local), sent_panel, dtype=np.int32)
            roff = 0
            dev_runs, _ = fam_plan[fname]
            for (b, start_local, n_max) in self.local_buckets[fname]:
                for d in range(R):
                    cids = np.asarray(
                        [cid for (_, cid) in dev_runs[b][d]],
                        dtype=np.int64)
                    if len(cids):
                        pst[d, roff:roff + len(cids)] = \
                            local_panel[cfirst[cids]]
                roff += n_max
            self.run_pst[fname] = pst

        # Dense hub slab: per-device (rows_max, H) block computed from the
        # device's panel-local A rows (kernel order: families ++ slab ++
        # residual).
        if H:
            slab_dest = csr_dest[:, seg_off:seg_off + self.rows_max * H]
            hr = packed.hub_rows.astype(np.int64)
            if len(hr) and not (panel_of_row[hr] >= 0).all():
                raise ValueError(
                    "hub entry in a panel-less row — only pre-tiling "
                    "hot-slab rows may be panel-less, and the pack "
                    "routes their hub columns to the full-width slab")
            hd = dev_of_unit[unit_of_panel[
                np.maximum(panel_of_row[hr], 0)]]
            hs = local_of_row[hr]
            slab_dest[hd, hs * H + packed.hub_rank.astype(np.int64)] = \
                packed.hub_csr.astype(np.int64)
            seg_off += self.rows_max * H

        # Hot-row slab entries: slot = local_hot_index * S + (rank - H).
        if self.rowslab_pad and packed.rowslab_csr is not None \
                and len(packed.rowslab_csr):
            S = self.rowslab_width
            rs_dest = csr_dest[:, seg_off:seg_off
                               + self.rowslab_pad * S]
            er = packed.rowslab_erows.astype(np.int64)
            rs_dest[hot_dev[er],
                    hot_loc[er] * S
                    + packed.rowslab_rank.astype(np.int64)] = \
                packed.rowslab_csr.astype(np.int64)
        seg_off += self.rowslab_pad * self.rowslab_width

        # residual per device (local row ids) — vectorized: stable-sort by
        # device, then each entry's slot is its rank within its device.
        self.res_rows = np.full((R, nR_max), self.rows_max, dtype=np.int32)
        self.res_gids = np.full((R, nR_max), NG, dtype=np.int32)
        self.res_member = np.zeros((R, nR_max), dtype=np.int64)
        res_dest = csr_dest[:, seg_off:seg_off + nR_max]
        rr = packed.res_rows.astype(np.int64)
        rg = packed.res_gids.astype(np.int64)
        rm = packed.res_member.astype(np.int64)
        rc = packed.res_csr.astype(np.int64)
        if len(rr):
            order_r = np.argsort(res_dev, kind="stable")
            d_s = res_dev[order_r]
            starts = np.zeros(R, dtype=np.int64)
            np.cumsum(counts_r[:-1], out=starts[1:])
            j_s = np.arange(len(rr), dtype=np.int64) - starts[d_s]
            self.res_rows[d_s, j_s] = local_of_row[rr[order_r]]
            self.res_gids[d_s, j_s] = rg[order_r]
            self.res_member[d_s, j_s] = rm[order_r]
            res_dest[d_s, j_s] = rc[order_r]

        # per-device flat layout: [family segments ++ slab ++ residual]
        self.csr_dest = csr_dest


class DistributedHybridSDDMM:
    """Hybrid SDDMM sharded over a ('rows', 'feat') mesh.

    Same packed layout, same kernel (``_hybrid_packed_jit``) as the
    single-chip ``HybridSDDMM`` — run per row-device under ``shard_map``
    with K-chunk tensor parallelism and one psum over 'feat'.

    Output layouts: ``"packed"`` (default) = the sharded (R, flat_local)
    value array; ``"csr"`` = CSR entry order of the input matrix (opt-in
    global conversion: key-value sort over the gathered flat values).
    """

    def __init__(self, packed: PackedMatrix, mesh: Mesh,
                 compute_dtype: str = "float32", k_chunks: int = 0,
                 default_order: str = "packed", a_layout: str = "rows"):
        self.packed = packed
        self.mesh = mesh
        self.compute_dtype = compute_dtype
        self.default_order = default_order
        if a_layout not in ("rows", "panels"):
            raise ValueError(f"unknown a_layout {a_layout!r}")
        self.a_layout = a_layout
        R = mesh.shape["rows"]
        self.F = mesh.shape.get("feat", 1)
        self.k_chunks = int(k_chunks) if k_chunks else self.F
        if self.k_chunks % self.F:
            raise ValueError(
                f"k_chunks={self.k_chunks} must be a multiple of the "
                f"'feat' axis size {self.F}")
        self.plan = plan = _ShardPlan(packed, R)

        sh_rows2 = NamedSharding(mesh, P("rows", None))
        sh_rows3 = NamedSharding(mesh, P("rows", None, None))
        put2 = functools.partial(jax.device_put, device=sh_rows2)
        put3 = functools.partial(jax.device_put, device=sh_rows3)
        i32 = lambda x: jnp.asarray(x, dtype=jnp.int32)
        self._tiles = {}
        for fname, _ in _FAMS:
            self._tiles[fname] = (put3(i32(plan.tile_rows[fname])),
                                  put3(i32(plan.tile_gids[fname])))
        self._res_rows = put2(i32(plan.res_rows))
        self._res_gids = put2(i32(plan.res_gids))
        self._res_member = put2(i32(plan.res_member))
        self._run_pst = {f: put2(i32(plan.run_pst[f]))
                         for f, _ in _FAMS} if a_layout == "panels" \
            else None
        self._csr_dest = put2(jnp.asarray(plan.csr_dest, dtype=jnp.int32))
        self._a_sharding = NamedSharding(mesh, P("rows", None, "feat"))
        self._bt_sharding = NamedSharding(mesh, P("feat", None, None))
        self._out_sharding = NamedSharding(mesh, P("rows", None))

    def _a_order_full(self) -> np.ndarray:
        """(R, rows_max + n_sent [+ rowslab_pad]) GLOBAL row id per local
        A slot: panel-local rows, then the zero-sentinel block (index m
        — the padded A's zero row), then this device's hot-slab rows.
        The sentinel block position is load-bearing: tile/residual
        sentinels index rows_max, which must stay the first zero row."""
        plan = self.plan
        m = self.packed.m
        n_sent = 16 if self.a_layout == "panels" else 1
        parts = [np.where(plan.a_rows_local < m, plan.a_rows_local, m),
                 np.full((plan.R, n_sent), m, dtype=np.int64)]
        if plan.rowslab_pad:
            parts.append(plan.rowslab_rows_local)
        return np.concatenate(parts, axis=1).astype(np.int64)

    # -- operand preparation -------------------------------------------
    def prepare_operands(self, a, b=None, bt=None):
        """Build the sharded operands: per-device panel-local A
        (R, rows_max+1, K) and the K-chunked grouped B^T layout
        (C, NG+1, G*kc)."""
        adt, bdt = _storage_dtypes(self.compute_dtype)
        a = np.asarray(a)
        if bt is None:
            bt = np.ascontiguousarray(np.asarray(b).T)
        else:
            bt = np.asarray(bt)
        k = a.shape[1]
        if k % self.k_chunks:
            raise ValueError(f"K={k} not divisible by C={self.k_chunks}")
        a_pad = np.concatenate([a, np.zeros((1, k), a.dtype)])
        # panel-local copies + per-device sentinel zero rows (one row
        # suffices for the row-gather layout; a_layout="panels" pads a
        # whole 16-row sentinel PANEL so the local A reshapes directly
        # into (nP_loc+1, 16, K) with the sentinel panel last — the row
        # sentinel rows_max is its first row either way)
        order = self._a_order_full()
        a_sh = a_pad[order]          # (R, rows_max + n_sent [+ slab], K)
        bt_pad = np.concatenate([bt, np.zeros((1, k), bt.dtype)])
        bt_phys = build_bt_phys(bt_pad, self.packed, self.k_chunks)
        return (jax.device_put(jnp.asarray(a_sh).astype(adt),
                               self._a_sharding),
                jax.device_put(jnp.asarray(bt_phys).astype(bdt),
                               self._bt_sharding))

    def device_prepare(self, a_pad, bt_pad):
        """In-jit counterpart of prepare_operands for device-resident
        global operands (M+1, K) / (N+1, K): builds the panel-local A
        copies and the grouped/chunked B^T layout with sharding
        constraints.  Differentiable — training steps route parameter
        gradients back through the gathers."""
        from bsmr_sddmm.ops.hybrid import device_bt_phys

        adt, bdt = _storage_dtypes(self.compute_dtype)
        a_pad = a_pad.astype(adt)
        bt_pad = bt_pad.astype(bdt)
        plan = self.plan
        k = a_pad.shape[1]
        order = self._a_order_full()
        a_sh = jnp.take(a_pad, jnp.asarray(order.reshape(-1),
                                           dtype=jnp.int32), axis=0)
        a_sh = a_sh.reshape(plan.R, order.shape[1], k)
        a_sh = jax.lax.with_sharding_constraint(a_sh, self._a_sharding)
        p = self.packed
        col_order = np.where(p.col_order < p.n, p.col_order, p.n)
        bt_phys = device_bt_phys(
            bt_pad, jnp.asarray(col_order, dtype=jnp.int32),
            p.group_size, p.num_col_groups, self.k_chunks)
        bt_phys = jax.lax.with_sharding_constraint(bt_phys,
                                                   self._bt_sharding)
        return a_sh, bt_phys

    def make_packed_targets(self, csr_values) -> tuple:
        """(targets, mask) in the sharded packed layout (R, flat_local):
        the training-loss pattern that keeps everything sharded (no
        flat-vector all-gather; see __graft_entry__.dryrun_multichip)."""
        dest = self.plan.csr_dest
        valid = dest < self.packed.nnz
        vals = np.asarray(csr_values)
        tgt = np.where(valid, vals[np.minimum(dest, len(vals) - 1)], 0.0)
        sh = NamedSharding(self.mesh, P("rows", None))
        return (jax.device_put(jnp.asarray(tgt, dtype=jnp.float32), sh),
                jax.device_put(jnp.asarray(valid), sh))

    # -- compute --------------------------------------------------------
    def _make_sharded_fn(self, k: int):
        plan = self.plan
        kc = k // self.k_chunks
        lb = plan.local_buckets
        compute_dtype = self.compute_dtype

        panels = self.a_layout == "panels"

        rs_pad = plan.rowslab_pad
        n_sent = 16 if panels else 1
        G_ = self.packed.group_size

        def local_step(a_loc, bt_loc, s_rows, s_gids, q_rows, q_gids,
                       p_rows, p_gids, g_rows, g_gids, r_rows, r_gids,
                       r_member, s_pst=None, q_pst=None, p_pst=None,
                       g_pst=None):
            a_full = a_loc[0]
            a_dev = a_full
            a_panels = None
            if panels:
                # the local A is panel-blocked: a free reshape gives the
                # panel-major layout, sentinel panel after the real
                # panels (prepared with a 16-row sentinel pad; hot-slab
                # rows follow it and are never referenced by pst).
                k_ = a_full.shape[1]
                a_panels = a_full.reshape(-1, 16, k_)
            if panels or rs_pad:
                # the kernel's row view must stay (rows_max+1, K) — the
                # hub slab sizes itself from a_pad.shape[0]-1, and the
                # sentinel row must stay the first zero row
                a_dev = jax.lax.slice_in_dim(a_full, 0, plan.rows_max + 1,
                                             axis=0)
            flat = _hybrid_packed_jit(
                a_dev, bt_loc, s_rows[0], s_gids[0], q_rows[0],
                q_gids[0], p_rows[0], p_gids[0], g_rows[0], g_gids[0],
                r_rows[0], r_gids[0], r_member[0],
                hub_start=(jnp.int32(0) if self.packed.hub_cols
                           else None),
                a_panels=a_panels,
                super_pst=s_pst[0] if panels else None,
                quad_pst=q_pst[0] if panels else None,
                pair_pst=p_pst[0] if panels else None,
                group_pst=g_pst[0] if panels else None,
                compute_dtype=compute_dtype,
                g=self.packed.group_size, kc=kc,
                super_buckets=lb["super"], quad_buckets=lb["quad"],
                pair_buckets=lb["pair"], group_buckets=lb["group"],
                h=self.packed.hub_cols)
            if rs_pad:
                # hot-row slab: this device's hot rows live at local A
                # slots [rows_max + n_sent, + rs_pad) — one static
                # slice, zero descriptors; spliced between the hub-slab
                # segment and the residual (the plan's flat layout)
                from bsmr_sddmm.ops.hybrid import tile_dot
                a_hot = jax.lax.slice_in_dim(
                    a_full, plan.rows_max + n_sent,
                    plan.rows_max + n_sent + rs_pad, axis=0)
                kc_l = a_hot.shape[1] // bt_loc.shape[0]
                sg = bt_loc.shape[1] - 1
                dn = ((((1,), (1,)), ((), ())) if G_ == 1
                      else (((1,), (2,)), ((), ())))

                acc = jnp.zeros((rs_pad, sg) if G_ == 1
                                else (rs_pad, sg, G_), jnp.float32)
                for c in range(bt_loc.shape[0]):
                    bs = jax.lax.slice_in_dim(bt_loc[c], 0, sg, axis=0)
                    if G_ > 1:
                        bs = bs.reshape(sg, G_, kc_l)
                    a_c = jax.lax.slice_in_dim(a_hot, c * kc_l,
                                               (c + 1) * kc_l, axis=1)
                    acc = acc + tile_dot(a_c, bs, dn, compute_dtype)
                nR_loc = r_rows.shape[1]
                head = jax.lax.slice_in_dim(
                    flat, 0, flat.shape[0] - nR_loc, axis=0)
                tail = jax.lax.slice_in_dim(
                    flat, flat.shape[0] - nR_loc, flat.shape[0], axis=0)
                flat = jnp.concatenate([head, acc.reshape(-1), tail])
            return jax.lax.psum(flat, "feat")[None]

        spec2 = P("rows", None)
        spec3 = P("rows", None, None)
        in_specs = [P("rows", None, "feat"), P("feat", None, None),
                    spec3, spec3, spec3, spec3, spec3, spec3,
                    spec3, spec3, spec2, spec2, spec2]
        if panels:
            in_specs += [spec2, spec2, spec2, spec2]
        return shard_map(
            local_step, mesh=self.mesh,
            in_specs=tuple(in_specs),
            out_specs=spec2)

    @functools.cached_property
    def _jitted(self):
        cache = {}

        def run(a_sh, bt_sh):
            k = a_sh.shape[2]
            if k not in cache:
                cache[k] = jax.jit(self._make_sharded_fn(k))
            args = [a_sh, bt_sh, *self._tiles["super"],
                    *self._tiles["quad"], *self._tiles["pair"],
                    *self._tiles["group"],
                    self._res_rows, self._res_gids, self._res_member]
            if self._run_pst is not None:
                args += [self._run_pst[f] for f, _ in _FAMS]
            return cache[k](*args)

        return run

    def run_padded(self, a_sh, bt_sh, order: str = None):
        """Sharded fast path; operands from prepare_operands.  Returns
        the (R, flat_local) packed-order values (sharded on 'rows') or
        CSR-order values with ``order="csr"``."""
        order = order or self.default_order
        flat = self._jitted(a_sh, bt_sh)
        if order == "packed":
            return flat
        if order == "csr":
            return self.to_csr_order(flat)
        raise ValueError(f"unknown order {order!r}")

    @functools.cached_property
    def _to_csr_jit(self):
        # per-instance jit (a static `self` would pin the instance and
        # its device buffers in the global jit cache forever)
        nnz = self.packed.nnz
        csr_dest = self._csr_dest

        @jax.jit
        def f(flat):
            _, vals = jax.lax.sort((csr_dest.reshape(-1),
                                    flat.reshape(-1)), num_keys=1)
            return jax.lax.slice_in_dim(vals, 0, nnz)

        return f

    def to_csr_order(self, flat):
        """Global CSR-order conversion (explicit opt-in: gathers the
        sharded flat vector; cost scales with packed size)."""
        return self._to_csr_jit(flat)

    def __call__(self, a, b=None, bt=None, order: str = "csr"):
        """Host convenience: numpy operands in, CSR-order values out
        (drop-in parity with the reference; the sharded fast path is
        run_padded with the default packed order)."""
        a_sh, bt_sh = self.prepare_operands(a, b=b, bt=bt)
        return self.run_padded(a_sh, bt_sh, order=order)

    # -- introspection --------------------------------------------------
    def tile_balance(self) -> np.ndarray:
        """Per-device real (non-padding) packed-slot counts — the
        load-balance diagnostic the window partitioner optimizes."""
        plan = self.plan
        dest = plan.csr_dest
        return np.sum(dest < self.packed.nnz, axis=1)

    def compiled_hlo(self, a_sh, bt_sh) -> str:
        """Compiled HLO text of the sharded packed-order step (for
        collective auditing: scripts/scaling_bench.py asserts no
        all-gather of the flat value vector appears)."""
        k = a_sh.shape[2]
        fn = jax.jit(self._make_sharded_fn(k))
        args = [a_sh, bt_sh, *self._tiles["super"], *self._tiles["quad"],
                *self._tiles["pair"], *self._tiles["group"],
                self._res_rows, self._res_gids, self._res_member]
        if self._run_pst is not None:
            args += [self._run_pst[f] for f, _ in _FAMS]
        return fn.lower(*args).compile().as_text()


def count_collectives(hlo_text: str) -> dict:
    """Histogram of collective ops in compiled HLO text."""
    import re
    ops = ("all-gather", "all-reduce", "reduce-scatter",
           "collective-permute", "all-to-all")
    out = {}
    for op in ops:
        out[op] = len(re.findall(rf"\b{op}(?:-start)?\(", hlo_text))
    return out


class DistributedDenseSDDMM:
    """Dense-tiling SDDMM strategy (ops/dense.DenseSDDMM — the true-DLMC
    density class) sharded over the same ('rows', 'feat') mesh as
    ``DistributedHybridSDDMM``.

    Pure tensor parallelism: A is sharded (rows, feat) and B^T (None,
    feat), each device contracts its local K-slice with one matmul, and the
    only hot-path collective is one ``psum`` of the (rows-local, N)
    partial products over 'feat' — the exact analogue of the hybrid
    path's single flat-output psum.  The (M, N) output stays sharded by
    'rows'; CSR-entry order is the same opt-in global conversion.

    The reference is single-GPU and always runs BSMR; both the strategy
    and the sharding are new capability (SURVEY §5 distributed row).
    """

    def __init__(self, m: int, n: int, mesh: Mesh,
                 compute_dtype: str = "float32", csr=None):
        self.m, self.n = int(m), int(n)
        self.mesh = mesh
        self.compute_dtype = compute_dtype
        self._csr = csr
        self.R = mesh.shape["rows"]
        self.F = mesh.shape.get("feat", 1)
        self.m_pad = -(-self.m // self.R) * self.R
        self._a_sharding = NamedSharding(mesh, P("rows", "feat"))
        self._bt_sharding = NamedSharding(mesh, P(None, "feat"))
        self._flat_idx = None
        self._rows_cols = None

    @staticmethod
    def from_csr(csr, mesh: Mesh,
                 compute_dtype: str = "float32") -> "DistributedDenseSDDMM":
        return DistributedDenseSDDMM(csr.m, csr.n, mesh,
                                     compute_dtype=compute_dtype, csr=csr)

    def prepare_operands(self, a, b=None, bt=None):
        """Sharded A (m_pad, K) by (rows, feat) and B^T (N, K) by
        (None, feat); K must divide by the 'feat' axis size."""
        adt, bdt = _storage_dtypes(self.compute_dtype)
        a = np.asarray(a)
        if bt is None:
            bt = np.ascontiguousarray(np.asarray(b).T)
        else:
            bt = np.asarray(bt)
        k = a.shape[1]
        if k % self.F:
            raise ValueError(f"K={k} not divisible by 'feat' axis "
                             f"size {self.F}")
        if self.m_pad > self.m:
            a = np.concatenate(
                [a, np.zeros((self.m_pad - self.m, k), a.dtype)])
        return (jax.device_put(jnp.asarray(a).astype(adt),
                               self._a_sharding),
                jax.device_put(jnp.asarray(bt).astype(bdt),
                               self._bt_sharding))

    def _sharded_fn(self):
        from bsmr_sddmm.ops.dense import _dense_full_jit

        def local(a_loc, bt_loc):
            part = _dense_full_jit(a_loc, bt_loc,
                                   compute_dtype=self.compute_dtype)
            return jax.lax.psum(part, "feat")

        return shard_map(local, mesh=self.mesh,
                         in_specs=(P("rows", "feat"), P(None, "feat")),
                         out_specs=P("rows", None))

    @functools.cached_property
    def _jitted(self):
        return jax.jit(self._sharded_fn())

    def run_padded(self, a_sh, bt_sh, order: str = "packed"):
        full = self._jitted(a_sh, bt_sh)
        if order == "packed":
            return full
        if order == "csr":
            return self.to_csr_order(full)
        raise ValueError(f"unknown order {order!r}")

    def to_csr_order(self, full):
        if self._csr is None:
            raise ValueError("order='csr' needs the CSR pattern; build "
                             "with DistributedDenseSDDMM.from_csr")
        # max flat index is m*n - 1; beyond int32 range jnp would
        # silently downcast int64 indices (x64 disabled), so use the
        # 2-D gather instead (same fallback as single-chip DenseSDDMM)
        if self.m * self.n < 2 ** 31:
            if self._flat_idx is None:
                flat = (self._csr.row_indices().astype(np.int64) * self.n
                        + self._csr.col_idx.astype(np.int64))
                self._flat_idx = jnp.asarray(flat.astype(np.int32))
            return jnp.take(full.reshape(-1), self._flat_idx)
        if self._rows_cols is None:
            self._rows_cols = (
                jnp.asarray(self._csr.row_indices(), dtype=jnp.int32),
                jnp.asarray(self._csr.col_idx, dtype=jnp.int32))
        return full[self._rows_cols[0], self._rows_cols[1]]

    def __call__(self, a, b=None, bt=None, order: str = "csr"):
        a_sh, bt_sh = self.prepare_operands(a, b=b, bt=bt)
        return self.run_padded(a_sh, bt_sh, order=order)

    def compiled_hlo(self, a_sh, bt_sh) -> str:
        return self._jitted.lower(a_sh, bt_sh).compile().as_text()
