"""Device packing: the counterpart of the reference's RPHM
("Row-Panel Hybrid Matrix", src/BSMR.cpp:83-265, include/BSMR.hpp:79-159).

The reference packs dense blocks as a BELL-style ``blockValues`` array of
CSR-value indices and scatters WMMA accumulator fragments through it.
Here the data flow is inverted so the hot path has **no scatter at all**,
and blocks are packed at 128-lane granularity into four dense tile
families plus a residual — sub-runs of r in {1, 2, 4, 8} consecutive
panels, merged over the *union* of their dense columns:

- **Supertiles (128 x 128, r=8)**: each B column gathered once per 128
  rows instead of once per 16.
- **Quads (64 x 128, r=4)**: 4-way column dedup.
- **Pairs (32 x 128, r=2)**: two cluster-adjacent panels; halves the
  sentinel-lane padding of single panels.
- **Groups (16 x 128, r=1)**: single panels, for windows where even
  pairwise unions blow up.

r is chosen by a byte+matmul cost model (constants in
reorder/autotune.py); merging panels dedups the columns they share
(cluster order makes adjacent panels similar by construction).

**Gather groups (G)**: columns are optionally pre-clustered by similarity
(reorder/cols.py cluster_columns) and the packing then works in *physical
groups* of G rank-adjacent columns.  The grouped B^T device layout stores
one group per physical row, so one gathered row carries G columns (a
(1, 32) fp32 row is 128 bytes; G=4 makes it 512).

**Residual absorption**: sentinel (padding) lanes in the last column-chunk
of every container are re-purposed to fetch its highest-count residual
column groups, turning residual nnz (~2*K*4 B each on the gather-dot
path) into free riders on matmul lanes that were already paid for.  Entries
whose column group is fetched by their container for any other reason
ride along automatically.

The framework's native output layout ("packed order") is the flat vector
[supertiles ++ quads ++ pairs ++ groups ++ residual] (run-major within
bucket segments); CSR entry order is an
explicit conversion through a precomputed permutation (every CSR index
appears in exactly one packed slot — the invariant the reference's
check_rphm verifies, src/BSMR.cpp:639-824).

All index arrays are static-shaped int32; sentinel indices point to an
appended zero row of A / grouped-B^T so no masking is needed in the
compute path.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from bsmr_sddmm import config
from bsmr_sddmm.data.sparse import CSR
from bsmr_sddmm.reorder.bsmr import BSMR

#: Host-time attribution of the last pack() call, stage -> seconds
#: (the preprocessing analogue of the reference's per-stage GPU timing,
#: src/BSMR.cpp:16-25).  Printed when BSMR_SDDMM_PACK_TIMING is set.
last_stage_times: dict = {}

GROUP_LANES = config.DENSE_GROUP_BLOCKS * config.BLOCK_COL_SIZE  # 128
GROUP_CELLS = config.ROW_PANEL_SIZE * GROUP_LANES                # 2048
PAIR_ROWS = 2 * config.ROW_PANEL_SIZE                            # 32
PAIR_CELLS = PAIR_ROWS * GROUP_LANES                             # 4096
QUAD_ROWS = 4 * config.ROW_PANEL_SIZE                            # 64
QUAD_CELLS = QUAD_ROWS * GROUP_LANES                             # 8192
SUPER_ROWS = 128
SUPER_CELLS = SUPER_ROWS * GROUP_LANES                           # 16384
PANELS_PER_SUPER = SUPER_ROWS // config.ROW_PANEL_SIZE           # 8

# Per-window family decision, in nanoseconds.  Gather+write bytes are
# converted at the measured effective gather bandwidth (512 B rows from
# an 8 MB source: 13420 M rows/s, scripts/calibrate.py on an NVIDIA H100
# 80GB HBM3 at its 700 W limit); matmul costs are the measured
# batched-dot rates by compute dtype (shared with autotune._DOT_G16_MS).
_GATHER_BYTES_PER_NS = 6.87          # ~6.9 TB/s, L2-resident source


def _cost_per_col(b_cost_scale: float = 1.0) -> dict:
    """ns per 128-lane chunk of a container of r panels: gather+write
    bytes of B's 128 lanes (priced x ``b_cost_scale``), A's 16r rows and
    the 16r output cells."""
    return {r: (128 * b_cost_scale + 32 * r) * 4 / _GATHER_BYTES_PER_NS
            for r in (1, 2, 4, 8)}


def _dot_slice16_ns(compute_dtype: str) -> dict:
    """ns per 16-row matmul slice by sub-run height r, from the measured
    batched-dot rates autotune uses (autotune._DOT_G16_MS)."""
    from bsmr_sddmm.reorder.autotune import _DOT_G16_MS
    return {r: 1e9 / _DOT_G16_MS[(compute_dtype, h)]  # ns per 16-row group
            for r, h in ((1, 16), (2, 32), (4, 64), (8, 128))}


def _bucket_of(chunks: int) -> int:
    """Next power of 2 >= chunks — the fallback bucket sizing for
    pathologically diverse chunk-count distributions (the default is
    exact-first sizing, see pack())."""
    b = 1
    while b < chunks:
        b *= 2
    return b

_FAM_SUPER, _FAM_QUAD, _FAM_PAIR, _FAM_GROUP = 0, 1, 2, 3
_FAM_OF_R = {8: _FAM_SUPER, 4: _FAM_QUAD, 2: _FAM_PAIR, 1: _FAM_GROUP}
_FAM_ROWS = {_FAM_SUPER: SUPER_ROWS, _FAM_QUAD: QUAD_ROWS,
             _FAM_PAIR: PAIR_ROWS, _FAM_GROUP: config.ROW_PANEL_SIZE}
_FAM_CELLS = {_FAM_SUPER: SUPER_CELLS, _FAM_QUAD: QUAD_CELLS,
              _FAM_PAIR: PAIR_CELLS, _FAM_GROUP: GROUP_CELLS}


@dataclasses.dataclass
class PackedMatrix:
    """Packed BSMR matrix ready for the hybrid SDDMM."""

    m: int
    n: int
    k_hint: int  # informational; packing is K-independent
    nnz: int
    num_panels: int
    num_blocks: int   # real (unpadded) 16x16 dense blocks, for stats
    num_super: int    # (128, 128) supertiles
    num_quads: int    # (64, 128) quad tiles
    num_pairs: int    # (32, 128) pair tiles
    num_groups: int   # (16, 128) dense groups

    # Run-major bucket metadata per family: ordered (chunks_per_run,
    # first_tile, num_runs) segments describing the flat device layout
    # (see "bucketed run-major" in pack()).
    super_buckets: tuple
    quad_buckets: tuple
    pair_buckets: tuple
    group_buckets: tuple

    # Gather-group geometry.
    group_size: int          # G: columns per gather descriptor
    num_col_groups: int      # NG: physical rows of the grouped B^T layout
    # (NG*G,) column id stored at each physical slot (sentinel = n); the
    # host builds bt_phys rows from this (ops/hybrid.py build_bt_phys).
    col_order: np.ndarray

    # (num_panels * 16,) original row id per reordered slot; sentinel = m.
    a_row_gather: np.ndarray
    # Supertile family.
    super_rows: np.ndarray   # (nS, 128) original row ids (sentinel m)
    super_cols: np.ndarray   # (nS, 128) original col ids (sentinel n)
    super_gids: np.ndarray   # (nS, 128/G) physical group row ids (sent NG)
    super_csr: np.ndarray    # (nS, 128, 128) CSR index or -1
    # Quad family.
    quad_rows: np.ndarray    # (nQ, 64)
    quad_cols: np.ndarray    # (nQ, 128)
    quad_gids: np.ndarray    # (nQ, 128/G)
    quad_csr: np.ndarray     # (nQ, 64, 128)
    # Pair family.
    pair_rows: np.ndarray    # (nP, 32)
    pair_cols: np.ndarray    # (nP, 128)
    pair_gids: np.ndarray    # (nP, 128/G)
    pair_csr: np.ndarray     # (nP, 32, 128)
    # Group family.
    group_rows: np.ndarray   # (nG, 16)
    group_cols: np.ndarray   # (nG, 128)
    group_gids: np.ndarray   # (nG, 128/G)
    group_csr: np.ndarray    # (nG, 16, 128)
    # Residual COO (absolute ids).
    res_rows: np.ndarray     # (nnz_res,) original row ids
    res_cols: np.ndarray     # (nnz_res,) original col ids
    res_gids: np.ndarray     # (nnz_res,) physical group row id of the col
    res_member: np.ndarray   # (nnz_res,) member index of the col in group
    res_csr: np.ndarray      # (nnz_res,) CSR value index
    # (nnz,) position of each CSR entry in the packed flat vector.
    inv_idx: np.ndarray
    # Packed-order metadata over the flat vector (see module docstring).
    packed_rows: np.ndarray  # (F,) int32
    packed_cols: np.ndarray  # (F,) int32
    csr_dest: np.ndarray     # (F,) int64
    # Container topology (for multi-chip partitioning, parallel/dist.py):
    # container -> member panels (CSR layout), and per family the
    # container id of each run in bucketed-run order.
    cont_panel_off: np.ndarray = None   # (nC+1,)
    #: the carve's modelled cost (ns) of the containers it chose: the
    #: objective both carves minimize (window_dp or per window)
    carve_cost_ns: float = 0.0
    cont_panel_ids: np.ndarray = None   # (sum,) panel ids
    super_run_cont: np.ndarray = None   # (n_super_runs,)
    quad_run_cont: np.ndarray = None
    pair_run_cont: np.ndarray = None
    group_run_cont: np.ndarray = None
    # Dense hub slab: the leading hub_cols ranks of the column order are
    # computed as ONE plain (m, K) x (K, H) matmul against a
    # contiguous slice of the grouped B^T layout — zero gather
    # descriptors (cols.hub_first_rank).  Slab slot of an entry is
    # row * H + rank; slab cells that are not nnz are padding.
    hub_cols: int = 0        # H (0 = no slab)
    hub_rows: np.ndarray = None   # (nnz_hub,) original row ids
    hub_rank: np.ndarray = None   # (nnz_hub,) column rank = slab lane
    hub_csr: np.ndarray = None    # (nnz_hub,) CSR value index
    # Hot-row dense slab (the hub's transpose): the R hottest rows are
    # computed as ONE (R, K) x (K, S) dot against the FULL grouped
    # B^T layout (S = NG*G ranks) — R gather descriptors total instead
    # of 2 per entry.  The power-law regime's tail is exactly this
    # shape (hot rows x scattered cols; the hub catches hot COLS).
    # Slab slot of an entry is hot_index(row) * S + rank.  In
    # pre-tiling mode the hot rows' hub-column entries ALSO live here
    # (the rows are panel-less, so the per-panel hub machinery of the
    # distributed runner cannot hold them); rank < hub_cols slab cells
    # duplicate hub-slab compute but every ENTRY has exactly one home.
    rowslab_rows: np.ndarray = None   # (R,) row ids (sentinel m)
    rowslab_erows: np.ndarray = None  # (nnz_rs,) original row ids
    rowslab_rank: np.ndarray = None   # (nnz_rs,) rank = slab lane
    rowslab_csr: np.ndarray = None    # (nnz_rs,) CSR value index

    @property
    def packed_size(self) -> int:
        return (self.num_super * SUPER_CELLS + self.num_quads * QUAD_CELLS
                + self.num_pairs * PAIR_CELLS
                + self.num_groups * GROUP_CELLS
                + self.m * self.hub_cols
                + self.rowslab_nrows * self.rowslab_width + self.nnz_res)

    @property
    def nnz_dense(self) -> int:
        return (self.nnz - self.nnz_res - self.nnz_hub
                - self.nnz_rowslab)

    @property
    def nnz_res(self) -> int:
        return int(len(self.res_rows))

    @property
    def nnz_hub(self) -> int:
        return int(len(self.hub_rows)) if self.hub_rows is not None else 0

    @property
    def nnz_rowslab(self) -> int:
        return (int(len(self.rowslab_erows))
                if self.rowslab_erows is not None else 0)

    @property
    def rowslab_nrows(self) -> int:
        return (int(len(self.rowslab_rows))
                if self.rowslab_rows is not None else 0)

    @property
    def rowslab_width(self) -> int:
        """S: full rank-space width of the hot-row slab."""
        return (self.num_col_groups * self.group_size
                if self.rowslab_rows is not None else 0)

    @property
    def average_block_density(self) -> float:
        """nnz density over dense tile cells (reference metric analogue,
        src/BSMR.cpp:334-442)."""
        cells = (self.num_super * SUPER_CELLS + self.num_quads * QUAD_CELLS
                 + self.num_pairs * PAIR_CELLS
                 + self.num_groups * GROUP_CELLS)
        return self.nnz_dense / cells if cells else 0.0


def _panel_group_lists(bsmr: BSMR, n: int, num_panels: int):
    """Per-panel dense group-id lists derived from bsmr.dense_cols.

    Group ids live in *rank* space whenever a column clustering is
    present (even at G=1), matching pack()'s gid_of/cols_of_groups
    keyspace."""
    G = bsmr.group_size
    dco = bsmr.dense_col_offsets
    out = []
    for p in range(num_panels):
        dc = bsmr.dense_cols[dco[p]:dco[p + 1]]
        if G == 1:
            real = dc[dc != n].astype(np.int64)
            if bsmr.col_rank is not None:
                real = bsmr.col_rank[real]
            out.append(real)
        else:
            runs = dc.reshape(-1, G)
            real = runs != n
            # every dense group has >= 1 real member; derive its id from
            # the first real member's rank
            first = np.argmax(real, axis=1)
            members = runs[np.arange(len(runs)), first]
            out.append(bsmr.col_rank[members] // G)
    return out


def pack(csr: CSR, bsmr: BSMR, k_hint: int = 0,
         merge_superpanels: bool = True,
         pair_panels: bool = True,
         absorb_residual: bool = True,
         compute_dtype: str = "tf32",
         window_dp: bool = True,
         sort_runs: str = "cid",
         sort_res: str = "csr",
         b_cost_scale: float = 1.0,
         hot_rows: int = 0,
         hot_row_ids: np.ndarray = None,
         full_metadata: bool = True) -> PackedMatrix:
    """sort_runs: run order of containers within each (family, bucket)
    device segment — "cid" (panel/cluster order, historical default) or
    "gid" (ascending first column-group id, so the concatenated B-gather
    descriptor stream is near-monotone in source address; the gather
    grid shows packed/ascending patterns run faster than random-window
    order at the same width x footprint).  Pure layout permutation: the
    packed-order contract, inv_idx and all metadata follow the chosen
    order.

    sort_res: residual-slot order — "csr" (CSR entry order, historical
    default: row-major, so the per-entry A-row stream repeats within a
    row) or "gid" (ascending column-group id: the per-entry B stream
    becomes repeat-heavy/monotone — the gather grid's fast hot64 class —
    at the cost of randomizing the A-row stream).  Which side wins
    depends on the residual's row/col repeat structure; shootout decides
    per matrix.

    hot_rows: R > 0 adds the hot-row dense slab (PackedMatrix
    docstring): the R rows with the most residual entries after tile
    matching and hub assignment are computed as one (R, K) x (K, S)
    dot against the contiguous cold-column slice of grouped B^T —
    residual entries in those rows stop paying 2 gather descriptors
    each (their A row + their B group), the power-law residual's
    dominant cost.

    hot_row_ids: EXPLICIT hot-row set (pre-tiling mode,
    autotune.from_params hot_rows_pre): the caller selected these rows
    before clustering/carving (typically by non-hub degree, with the
    rows' entries removed from the BSMR input so the carve never
    builds tiles around them).  Their unmatched non-hub entries go to
    the slab; entries a container happens to cover stay in tiles
    (exactly-once either way).  Overrides the count-based selection.

    b_cost_scale: multiplies the B-descriptor term of the carve cost
    model (the 128-lane gather per chunk).  >1 biases the DP toward
    taller containers wherever panel unions overlap (B descriptors are
    per-container, so sharing a window across 16-row panels removes
    whole gathered rows); the bytes model at 1.0 prices only bytes,
    not the per-row cost of a gather.

    full_metadata=False skips the packed_size-sized metadata
    (per-tile CSR cubes, packed_rows/cols, csr_dest) — those arrays cost
    ~85% of pack() host time and only the autotune *winner* needs them
    (HybridSDDMM kernel timing in packed order does not).  Light packs
    raise on any CSR-order / validation / multi-chip use; re-pack with
    full metadata first (autotune does this for the winner)."""
    _t0 = time.perf_counter()
    last_stage_times.clear()

    def _mark(name: str) -> None:
        nonlocal _t0
        now = time.perf_counter()
        last_stage_times[name] = (last_stage_times.get(name, 0.0)
                                  + now - _t0)
        _t0 = now

    if sort_runs not in ("cid", "gid"):
        raise ValueError(f"unknown sort_runs {sort_runs!r} "
                         "(expected 'cid' or 'gid')")
    if sort_res not in ("csr", "gid"):
        raise ValueError(f"unknown sort_res {sort_res!r} "
                         "(expected 'csr' or 'gid')")
    cost_per_col = _cost_per_col(float(b_cost_scale))
    panel_sz = config.ROW_PANEL_SIZE
    m, n = csr.shape
    G = int(bsmr.group_size)
    if G < 1 or GROUP_LANES % G:
        raise ValueError(
            f"group_size must divide {GROUP_LANES} (a power of 2 <= "
            f"{GROUP_LANES}); got {G}")
    LG = GROUP_LANES // G            # groups per 128-lane tile chunk
    reordered = bsmr.reordered_rows
    num_panels = bsmr.num_row_panels
    col_idx = csr.col_idx
    NG = (n + G - 1) // G if G > 1 else n
    H = int(getattr(bsmr, "hub_cols", 0))
    if H:
        if bsmr.col_rank is None:
            raise ValueError(
                "hub_cols requires a hub-first col_rank "
                "(cols.hub_first_rank / BSMR(hub_cols=...))")
        if H % G or H > NG * G:
            raise ValueError(f"hub_cols={H} must be a multiple of "
                             f"group_size={G} and <= {NG * G}")

    # Physical column layout: slot g*G+j holds the column with rank g*G+j.
    if G == 1 and bsmr.col_rank is None:
        col_order = np.arange(n, dtype=np.int64)
        col_rank = None
    else:
        col_rank = (bsmr.col_rank if bsmr.col_rank is not None
                    else np.arange(n, dtype=np.int64))
        col_order = np.full(NG * G, n, dtype=np.int64)
        col_order[col_rank] = np.arange(n, dtype=np.int64)

    def gid_of(cols):
        if col_rank is None:
            return cols
        return col_rank[cols] // G

    def member_of(cols):
        if col_rank is None:
            return np.zeros(len(cols), dtype=np.int64)
        return col_rank[cols] % G

    def cols_of_groups(gids):
        """(k, G) member column ids of each group id (sentinel n)."""
        gids = np.asarray(gids, dtype=np.int64)
        if col_rank is None:
            out = np.full((len(gids), 1), n, dtype=np.int64)
            real = gids < n
            out[real, 0] = gids[real]
            return out
        slots = gids[:, None] * G + np.arange(G, dtype=np.int64)[None, :]
        out = np.full(slots.shape, n, dtype=np.int64)
        real = gids < NG
        out[real] = col_order[slots[real]]
        return out

    # Reordered row slots, padded with sentinel m.
    a_row_gather = np.full(num_panels * panel_sz, m, dtype=np.int32)
    a_row_gather[:len(reordered)] = reordered

    num_blocks = int(np.count_nonzero(bsmr.dense_cols != n)
                     // max(config.BLOCK_COL_SIZE, 1))

    panel_groups = _panel_group_lists(bsmr, n, num_panels)

    def padded(x: int) -> int:
        return -(-x // LG) * LG

    # --- Carve the panel sequence into tile containers ---
    # Containers: (family, member panel list, group-id list).
    cont_family: list[int] = []
    cont_panels: list[list[int]] = []
    cont_groups: list[np.ndarray] = []
    panel_container = np.full(num_panels, -1, dtype=np.int64)
    panel_offset = np.zeros(num_panels, dtype=np.int64)  # 16-row slot

    dot_ns = _dot_slice16_ns(compute_dtype)
    carve_cost_ns = 0.0
    _mark("setup")

    if window_dp:
        # Cross-window DP (round 3): tile heights are r in {1,2,4,8}
        # panels, but nothing in the kernel requires runs to start at
        # 8-panel-aligned boundaries — A rows are gathered by index, so
        # a container may cover ANY consecutive panels.  The old
        # per-window carve (below, window_dp=False) strands similar
        # panels on opposite sides of a window boundary in separate
        # half-empty containers; the shortest-path DP over the full
        # panel sequence removes that restriction and is a strict
        # superset of the per-window solutions under the same cost
        # model.  (Reference counterpart: the fixed row-panel blocking
        # of BSMR.cpp:83-265, a launch-grid constraint of its kernels.)
        allowed_r = [1]
        if pair_panels:
            allowed_r.append(2)
        if merge_superpanels:
            allowed_r += [4, 8]
        max_r = max(allowed_r)

        # unions[r][i] = sorted unique dense group-ids of panels
        # [i, min(i+r, num_panels)), built by doubling merges.
        unions: dict[int, list[np.ndarray]] = {1: panel_groups}
        r_prev = 1
        for r in (2, 4, 8):
            if r > max_r:
                break
            prev = unions[r_prev]
            cur = []
            for i in range(num_panels):
                a_ = prev[i]
                b_ = (prev[i + r_prev] if i + r_prev < num_panels
                      else None)
                if b_ is None or not len(b_):
                    cur.append(a_)
                elif not len(a_):
                    cur.append(b_)
                else:
                    cur.append(np.unique(np.concatenate([a_, b_])))
            unions[r] = cur
            r_prev = r

        usize = {r: np.fromiter((len(u) for u in unions[r]),
                                dtype=np.int64, count=num_panels)
                 for r in allowed_r}
        seg_cost = {}
        for r in allowed_r:
            chunks = -(-usize[r] // LG)  # padded(len)/LG, vectorized
            seg_cost[r] = np.where(
                usize[r] > 0,
                cost_per_col[r] * G * chunks * LG + dot_ns[r] * r * chunks,
                0.0)

        dp = np.zeros(num_panels + 1)
        choice = np.ones(num_panels, dtype=np.int64)
        for i in range(num_panels - 1, -1, -1):
            best = seg_cost[1][i] + dp[i + 1]
            best_r = 1
            for r in allowed_r[1:]:
                c = seg_cost[r][i] + dp[min(i + r, num_panels)]
                if c < best:
                    best, best_r = c, r
            dp[i] = best
            choice[i] = best_r
        carve_cost_ns = float(dp[0])

        i = 0
        while i < num_panels:
            r = int(choice[i])
            j = min(i + r, num_panels)
            u = unions[r][i]
            if len(u):
                cid = len(cont_family)
                cont_family.append(_FAM_OF_R[r])
                members = list(range(i, j))
                cont_panels.append(members)
                cont_groups.append(np.asarray(u, dtype=np.int64))
                for jj, p in enumerate(members):
                    panel_container[p] = cid
                    panel_offset[p] = jj
            i = j

    num_windows = (0 if window_dp
                   else (num_panels + PANELS_PER_SUPER - 1)
                   // PANELS_PER_SUPER)
    for w in range(num_windows):
        ps = [p for p in range(w * PANELS_PER_SUPER,
                               min((w + 1) * PANELS_PER_SUPER, num_panels))]
        lists = [panel_groups[p] for p in ps]
        if sum(len(x) for x in lists) == 0:
            continue  # dense-free window: everything residual
        lane_b = G  # one lane fetches G columns; costs are per group-lane
        # Cost of carving the window into sub-runs of r panels, for every
        # height the carve supports: union dedup + per-chunk gather bytes
        # vs the measured per-height batched-dot rate.
        sub_unions = {}
        costs = {}
        for r in (1, 2, 4, 8):
            if r == 2 and not pair_panels:
                continue
            if r in (4, 8) and not merge_superpanels:
                continue
            unions_r = []
            cost_r = 0.0
            for i in range(0, len(ps), r):
                chunk = [x for x in lists[i:i + r] if len(x)]
                if not chunk:
                    u = np.zeros(0, dtype=np.int64)
                elif len(chunk) == 1:
                    u = chunk[0]  # already duplicate-free
                else:
                    u = np.unique(np.concatenate(chunk))
                unions_r.append(u)
                if len(u):
                    # Exact-first bucketing (below) pads at most a
                    # handful of low-population chunk counts, so cost
                    # the unpadded chunk count (pow2-padded costing was
                    # measured to push decisions toward small r and
                    # lose ~45% end-to-end on coarse block structure).
                    chunks = padded(len(u)) // LG
                    cost_r += (cost_per_col[r] * lane_b * chunks * LG
                               + dot_ns[r] * r * chunks)
            sub_unions[r] = unions_r
            costs[r] = cost_r
        r_best = min(costs, key=lambda r: costs[r])
        carve_cost_ns += costs[r_best]

        for i0 in range(0, len(ps), r_best):
            members = ps[i0:i0 + r_best]
            u = sub_unions[r_best][i0 // r_best]
            if not len(u):
                continue
            cid = len(cont_family)
            cont_family.append(_FAM_OF_R[r_best])
            cont_panels.append(members)
            cont_groups.append(u)
            for j, p in enumerate(members):
                panel_container[p] = cid
                panel_offset[p] = j

    num_cont = len(cont_family)
    _mark("carve")

    # --- Entry coordinates ---
    rpos = np.full(m, -1, dtype=np.int64)
    rpos[reordered] = np.arange(len(reordered))
    entry_rows = csr.row_indices().astype(np.int64)
    er = rpos[entry_rows]
    panel_e = np.where(er >= 0, er // panel_sz, -1)
    local_e = np.where(er >= 0, er % panel_sz, 0)
    entry_gid = gid_of(col_idx.astype(np.int64))
    entry_member = member_of(col_idx.astype(np.int64))
    # Hub entries (rank < H) are covered by the dense slab, never by
    # tiles (cols.py excludes hub groups from dense lists) or residual.
    hub_e = (entry_gid < H // G if H
             else np.zeros(csr.nnz, dtype=bool))
    # Pre-selected hot rows own ALL their entries (hub columns
    # included): the rows are panel-less, and the hot-row slab spans
    # the full rank space exactly so they need no second home.
    if hot_row_ids is not None and len(hot_row_ids) and H:
        _hot_mask = np.zeros(m, dtype=bool)
        _hot_mask[np.asarray(hot_row_ids, dtype=np.int64)] = True
        hub_e = hub_e & ~_hot_mask[entry_rows]
    cont_e = np.where(panel_e >= 0, panel_container[panel_e], -1)

    _mark("coords")

    def chunks_of(cid: int) -> int:
        return max(padded(len(cont_groups[cid])) // LG, 1)

    # --- Assign per-container device bucket sizes: exact chunk counts,
    # with low-population counts merged upward so each family keeps a
    # bounded number of batched-dot segments.  (Power-of-2 buckets were
    # measured ~45-80% slower end-to-end on coarse block structure: the
    # padding chunks pay real gathers, dots, and output writes.) ---
    cont_bucket = np.zeros(max(num_cont, 1), dtype=np.int64)
    for f in (_FAM_SUPER, _FAM_QUAD, _FAM_PAIR, _FAM_GROUP):
        cids = [cid for cid in range(num_cont) if cont_family[cid] == f]
        if not cids:
            continue
        counts = {cid: chunks_of(cid) for cid in cids}
        pop: dict[int, int] = {}
        for c in counts.values():
            pop[c] = pop.get(c, 0) + 1
        sizes = sorted(pop)
        assign: dict[int, int] = {}
        group: list[int] = []
        for s in sizes:
            # never merge a count into a bucket > 2x its size — the
            # sentinel chunks pay real gathers/dots/writes, so the
            # padding ratio must stay bounded
            if group and s > 2 * group[0]:
                for x in group:
                    assign[x] = group[-1]
                group = []
            group.append(s)
            if (sum(pop[x] for x in group) >= 3) or s == sizes[-1]:
                for x in group:
                    assign[x] = s
                group = []
        for x in group:  # tail group (closed by the ratio bound)
            assign[x] = group[-1]
        if len(set(assign.values())) > 12:
            # pathological diversity: fall back to pow2 buckets
            assign = {s: _bucket_of(s) for s in sizes}
        for cid in cids:
            cont_bucket[cid] = assign[counts[cid]]

    _mark("buckets")

    def bucket_of_cid(cid: int) -> int:
        return int(cont_bucket[cid])

    # --- Residual absorption into the sentinel lanes of the container's
    # bucket-padded capacity (the padding tiles exist either way) ---
    if absorb_residual and num_cont:
        ckeys = cont_e * np.int64(NG + 1) + entry_gid
        tk = np.sort(np.concatenate(
            [np.full(len(gset), cid, dtype=np.int64) * np.int64(NG + 1)
             + np.asarray(gset, dtype=np.int64)
             for cid, gset in enumerate(cont_groups)]))
        covered = np.zeros(len(entry_rows), dtype=bool)
        if len(tk):
            j = np.minimum(np.searchsorted(tk, ckeys), len(tk) - 1)
            covered = (tk[j] == ckeys) & (cont_e >= 0)
        miss = (~covered) & (cont_e >= 0) & ~hub_e
        uk, ucnt = np.unique(ckeys[miss], return_counts=True)
        u_cont = uk // (NG + 1)
        u_gid = uk % (NG + 1)
        order_ = np.lexsort((-ucnt, u_cont))
        u_cont, u_gid = u_cont[order_], u_gid[order_]
        start = np.searchsorted(u_cont, np.arange(num_cont))
        end = np.searchsorted(u_cont, np.arange(num_cont), side="right")
        for cid in range(num_cont):
            nreal = len(cont_groups[cid])
            free = bucket_of_cid(cid) * LG - nreal
            if free <= 0 or end[cid] <= start[cid]:
                continue
            pick = u_gid[start[cid]:end[cid]][:free]
            if len(pick):
                cont_groups[cid] = np.concatenate([cont_groups[cid], pick])

    _mark("absorb")

    # --- Build the three tile families, bucketed run-major ---
    # Containers of a family are sorted by their assigned chunk-count
    # bucket and padded with sentinel chunks up to the bucket size; the
    # flat device layout is then *run-major* within each bucket
    # (run, row, chunk*128 + lane), so the hybrid kernel gathers A once
    # per container and runs one batched dot per bucket with
    # n = bucket*128 lanes — instead of refetching the same A rows for
    # every 128-lane chunk (measured ~7 chunks per supertile container on
    # coarse block structure: a 7x A-traffic saving).

    fam_conts: dict[int, list[int]] = {
        _FAM_SUPER: [], _FAM_QUAD: [], _FAM_PAIR: [], _FAM_GROUP: []}
    for cid in range(num_cont):
        fam_conts[cont_family[cid]].append(cid)

    if sort_runs == "gid":
        # ascending-window run order: the concatenated per-bucket gid
        # stream becomes near-monotone in B^T source address (see the
        # sort_runs docstring); ties broken by cid for determinism
        def _run_key(cid):
            return (bucket_of_cid(cid), int(cont_groups[cid][0]), cid)
    else:
        def _run_key(cid):
            return (bucket_of_cid(cid), cid)
    for f in fam_conts:
        fam_conts[f].sort(key=_run_key)

    # Per-container topology as flat arrays (members are CONSECUTIVE
    # panels under both carves — the DP emits range(i, j) and the window
    # path slices of ps — which both the vectorized build below and the
    # a_layout="panels" kernel path rely on).
    cont_first = (np.fromiter((cp[0] for cp in cont_panels),
                              dtype=np.int64, count=num_cont)
                  if num_cont else np.zeros(0, dtype=np.int64))
    cont_nmem = (np.fromiter((len(cp) for cp in cont_panels),
                             dtype=np.int64, count=num_cont)
                 if num_cont else np.zeros(0, dtype=np.int64))

    fam_tile_cid: dict[int, np.ndarray] = {}
    fam_gids_arr: dict[int, np.ndarray] = {}
    fam_buckets: dict[int, list[tuple[int, int, int]]] = {}
    for f, cids_l in fam_conts.items():
        cids = np.asarray(cids_l, dtype=np.int64)
        b_of = cont_bucket[cids] if len(cids) else cids
        # bucket run-lengths (cids sorted by bucket): (b, start_tile, n)
        buckets = []
        if len(cids):
            change = np.flatnonzero(np.diff(b_of)) + 1
            starts = np.concatenate([[0], change, [len(cids)]])
            tile_start = np.concatenate([[0], np.cumsum(b_of)])
            for s, e in zip(starts[:-1], starts[1:]):
                buckets.append((int(b_of[s]), int(tile_start[s]),
                                int(e - s)))
        fam_buckets[f] = buckets
        totT = int(b_of.sum()) if len(cids) else 0
        fam_tile_cid[f] = (np.repeat(cids, b_of) if totT
                           else np.zeros(0, dtype=np.int64))
        # flat (totT, LG) group table: container cid's groups padded
        # with the sentinel NG to its bucket capacity b*LG
        gids_flat = np.full(totT * LG, NG, dtype=np.int64)
        if totT:
            glens = np.fromiter((len(cont_groups[c]) for c in cids_l),
                                dtype=np.int64, count=len(cids))
            all_g = (np.concatenate([cont_groups[c] for c in cids_l])
                     if glens.sum() else np.zeros(0, dtype=np.int64))
            cap_off = np.concatenate([[0], np.cumsum(b_of * LG)])[:-1]
            within = (np.arange(int(glens.sum()), dtype=np.int64)
                      - np.repeat(np.concatenate(
                          [[0], np.cumsum(glens)])[:-1], glens))
            gids_flat[np.repeat(cap_off, glens) + within] = all_g
        fam_gids_arr[f] = gids_flat.reshape(totT, LG)

    def build_family(f: int):
        rows_h = _FAM_ROWS[f]
        t_gids = fam_gids_arr[f]
        nT = t_gids.shape[0]
        tcid = fam_tile_cid[f]
        # rows: consecutive reordered slots [first*16, first*16 +
        # 16*n_members) per container, sentinel m past the members
        j = np.arange(rows_h, dtype=np.int64)
        if nT:
            idx = cont_first[tcid][:, None] * panel_sz + j[None, :]
            valid = j[None, :] < cont_nmem[tcid][:, None] * panel_sz
            t_rows = np.where(valid, a_row_gather[np.minimum(
                idx, len(a_row_gather) - 1)], m)
        else:
            t_rows = np.zeros((0, rows_h), dtype=np.int64)
        t_cols = cols_of_groups(t_gids.reshape(-1)).reshape(nT, GROUP_LANES)
        t_csr = (np.full((nT, rows_h, GROUP_LANES), config.NULL_INDEX,
                         dtype=np.int32) if full_metadata else None)
        return t_rows, t_gids, t_cols, t_csr

    super_rows, super_gids, super_cols, super_csr = build_family(_FAM_SUPER)
    quad_rows_a, quad_gids, quad_cols, quad_csr = build_family(_FAM_QUAD)
    pair_rows_a, pair_gids, pair_cols, pair_csr = build_family(_FAM_PAIR)
    group_rows, group_gids, group_cols, group_csr = build_family(_FAM_GROUP)
    _mark("tiles")
    num_super, num_quads, num_pairs, num_groups = (
        len(fam_gids_arr[_FAM_SUPER]), len(fam_gids_arr[_FAM_QUAD]),
        len(fam_gids_arr[_FAM_PAIR]), len(fam_gids_arr[_FAM_GROUP]))

    base_super = 0
    base_quad = num_super * SUPER_CELLS
    base_pair = base_quad + num_quads * QUAD_CELLS
    base_group = base_pair + num_pairs * PAIR_CELLS
    dense_slots = base_group + num_groups * GROUP_CELLS
    fam_base = {_FAM_SUPER: base_super, _FAM_QUAD: base_quad,
                _FAM_PAIR: base_pair, _FAM_GROUP: base_group}

    # Per-tile flat-slot origin and row stride under the run-major
    # bucketed layout (vectorized per bucket).
    tile_origin: dict[int, np.ndarray] = {}
    tile_stride: dict[int, np.ndarray] = {}
    for f, gids2 in fam_gids_arr.items():
        rows_h = _FAM_ROWS[f]
        nT = gids2.shape[0]
        origin = np.zeros(nT, dtype=np.int64)
        stride = np.zeros(nT, dtype=np.int64)
        seg = fam_base[f]
        for (b, start, n_runs) in fam_buckets[f]:
            run_cells = rows_h * b * GROUP_LANES
            sl = slice(start, start + n_runs * b)
            origin[sl] = (seg
                          + (np.arange(n_runs, dtype=np.int64)[:, None]
                             * run_cells
                             + np.arange(b, dtype=np.int64)[None, :]
                             * GROUP_LANES).reshape(-1))
            stride[sl] = b * GROUP_LANES
            seg += n_runs * run_cells
        tile_origin[f] = origin
        tile_stride[f] = stride

    # --- Join each nnz entry against its container's group table ---
    tab_key_l, tab_slotbase_l, tab_stride_l = [], [], []
    tab_fam_l, tab_tile_l, tab_lgrp_l = [], [], []
    for f, gids2 in fam_gids_arr.items():
        nT = gids2.shape[0]
        if not nT:
            continue
        real = gids2 < NG  # (nT, LG)
        t_idx = np.broadcast_to(
            np.arange(nT, dtype=np.int64)[:, None], gids2.shape)[real]
        pos = np.broadcast_to(
            np.arange(LG, dtype=np.int64)[None, :], gids2.shape)[real]
        tab_key_l.append(fam_tile_cid[f][t_idx] * np.int64(NG + 1)
                         + gids2[real])
        # slot of (tile, lane_grp) at local row 0, lane member 0
        tab_slotbase_l.append(tile_origin[f][t_idx] + pos * np.int64(G))
        tab_stride_l.append(tile_stride[f][t_idx])
        tab_fam_l.append(np.full(len(pos), f, dtype=np.int64))
        tab_tile_l.append(t_idx)
        tab_lgrp_l.append(pos)
    if tab_key_l:
        tab_key = np.concatenate(tab_key_l)
        tab_slotbase = np.concatenate(tab_slotbase_l)
        tab_stride = np.concatenate(tab_stride_l)
        tab_fam = np.concatenate(tab_fam_l)
        tab_tile = np.concatenate(tab_tile_l)
        tab_lgrp = np.concatenate(tab_lgrp_l)
        order_t = np.argsort(tab_key)
        tab_key = tab_key[order_t]
        tab_slotbase = tab_slotbase[order_t]
        tab_stride = tab_stride[order_t]
        tab_fam = tab_fam[order_t]
        tab_tile = tab_tile[order_t]
        tab_lgrp = tab_lgrp[order_t]
    else:
        tab_key = np.zeros(0, dtype=np.int64)
        tab_slotbase = np.zeros(0, dtype=np.int64)
        tab_stride = np.zeros(0, dtype=np.int64)
        tab_fam = np.zeros(0, dtype=np.int64)
        tab_tile = np.zeros(0, dtype=np.int64)
        tab_lgrp = np.zeros(0, dtype=np.int64)

    _mark("join")

    ekey = cont_e * np.int64(NG + 1) + entry_gid
    if len(tab_key):
        j = np.minimum(np.searchsorted(tab_key, ekey), len(tab_key) - 1)
        matched = (tab_key[j] == ekey) & (cont_e >= 0)
        slot_base = tab_slotbase[j]
        stride_e = tab_stride[j]
        fam_e = tab_fam[j]
        tile_e = tab_tile[j]
        lgrp_e = tab_lgrp[j]
    else:
        matched = np.zeros(csr.nnz, dtype=bool)
        slot_base = np.zeros(csr.nnz, dtype=np.int64)
        stride_e = np.zeros(csr.nnz, dtype=np.int64)
        fam_e = np.zeros(csr.nnz, dtype=np.int64)
        tile_e = np.zeros(csr.nnz, dtype=np.int64)
        lgrp_e = np.zeros(csr.nnz, dtype=np.int64)

    local_row = np.where(cont_e >= 0,
                         panel_offset[np.maximum(panel_e, 0)] * panel_sz
                         + local_e, 0)
    slot = slot_base + local_row * stride_e + entry_member

    entry_idx = np.arange(csr.nnz, dtype=np.int64)
    # Fill the tile-major csr arrays (validation / multi-chip layout).
    lane_m = lgrp_e * G + entry_member
    if full_metadata:
        for f, csr_arr in ((_FAM_SUPER, super_csr), (_FAM_QUAD, quad_csr),
                           (_FAM_PAIR, pair_csr), (_FAM_GROUP, group_csr)):
            sel = matched & (fam_e == f)
            csr_arr[tile_e[sel], local_row[sel],
                    lane_m[sel]] = entry_idx[sel]

    _mark("match")

    if np.any(matched & hub_e):
        raise AssertionError("hub column matched a dense tile "
                             "(cols.py must exclude hub groups)")
    rest = ~matched & ~hub_e

    # Hot-row dense slab: pick the R rows carrying the most residual
    # entries; their residual entries move to the slab (slot =
    # hot_index * S + rank - H), everything else stays per-entry.
    R_hot = (int(len(hot_row_ids)) if hot_row_ids is not None
             else int(hot_rows))
    S_width = NG * G
    rowslab_rows_arr = None
    rs_rows_e = rs_rank_e = rs_csr_e = None
    if R_hot > 0:
        if hot_row_ids is not None:
            top = np.asarray(hot_row_ids, dtype=np.int64)
        else:
            counts = np.bincount(entry_rows[rest], minlength=m)
            top = np.argsort(-counts, kind="stable")[:R_hot]
            top = top[counts[top] > 0]
        rowslab_rows_arr = np.full(R_hot, m, dtype=np.int64)
        rowslab_rows_arr[:len(top)] = np.sort(top)
        hot_index = np.full(m, -1, dtype=np.int64)
        hot_index[rowslab_rows_arr[:len(top)]] = \
            np.arange(len(top), dtype=np.int64)
        in_slab = rest & (hot_index[entry_rows] >= 0)
        rest = rest & ~in_slab
        rs_rows_e = entry_rows[in_slab]
        rs_rank_e = entry_gid[in_slab] * G + entry_member[in_slab]
        rs_csr_e = entry_idx[in_slab]

    res_rows = entry_rows[rest]
    res_cols = col_idx[rest].astype(np.int64)
    res_gids_arr = entry_gid[rest]
    res_member_arr = entry_member[rest]
    res_csr = entry_idx[rest]
    if sort_res == "gid" and len(res_gids_arr):
        rorder = np.argsort(res_gids_arr, kind="stable")
        res_rows = res_rows[rorder]
        res_cols = res_cols[rorder]
        res_gids_arr = res_gids_arr[rorder]
        res_member_arr = res_member_arr[rorder]
        res_csr = res_csr[rorder]

    # Dense hub slab entries: slot = slab_base + row * H + rank.
    hub_rows_arr = entry_rows[hub_e]
    hub_rank_arr = (entry_gid[hub_e] * G + entry_member[hub_e])
    hub_csr_arr = entry_idx[hub_e]
    slab_base = dense_slots
    rowslab_base = dense_slots + m * H
    res_base = rowslab_base + (R_hot * S_width if R_hot > 0 else 0)

    # Inverse permutation: CSR entry -> packed slot.
    inv_idx = np.full(csr.nnz, -1, dtype=np.int64)
    inv_idx[entry_idx[matched]] = slot[matched]
    inv_idx[hub_csr_arr] = slab_base + hub_rows_arr * np.int64(H) \
        + hub_rank_arr
    if R_hot > 0 and len(rs_csr_e):
        inv_idx[rs_csr_e] = (rowslab_base
                             + hot_index[rs_rows_e] * np.int64(S_width)
                             + rs_rank_e)
    inv_idx[res_csr] = res_base + np.arange(len(res_csr), dtype=np.int64)
    if np.any(inv_idx < 0):
        missing = int(np.count_nonzero(inv_idx < 0))
        raise AssertionError(
            f"packing lost {missing} CSR entries (invariant violation)")

    # Packed-order metadata: slots that hold a CSR entry carry its
    # (row, col); every other slot carries the sentinel (m, n).  A slot
    # is non-sentinel iff an entry maps to it, so this is exactly one
    # nnz-sized scatter through inv_idx — not a packed_size-sized
    # tile-table expansion (which was ~70% of pack() host time).
    F = res_base + len(res_csr)
    if F >= 2**31:
        raise ValueError(
            f"packed flat vector has {F} slots, exceeding the int32 "
            "index range of the packed metadata")
    if full_metadata:
        packed_rows = np.full(F, m, dtype=np.int32)
        packed_cols = np.full(F, n, dtype=np.int32)
        packed_rows[inv_idx] = entry_rows
        packed_cols[inv_idx] = col_idx
        csr_dest = np.full(F, -1, dtype=np.int32)
        csr_dest[inv_idx] = np.arange(csr.nnz, dtype=np.int32)
        spill = csr_dest < 0
        csr_dest[spill] = csr.nnz + np.arange(int(spill.sum()),
                                              dtype=np.int32)
    else:
        packed_rows = packed_cols = csr_dest = None
    _mark("metadata")

    # Container topology for multi-chip partitioning.
    cont_panel_off = np.zeros(num_cont + 1, dtype=np.int64)
    for cid in range(num_cont):
        cont_panel_off[cid + 1] = cont_panel_off[cid] + len(cont_panels[cid])
    cont_panel_ids = (np.concatenate([np.asarray(p, dtype=np.int64)
                                      for p in cont_panels])
                      if num_cont else np.zeros(0, dtype=np.int64))
    run_cont = {f: np.asarray(fam_conts[f], dtype=np.int64)
                for f in fam_conts}
    _mark("topology")
    if os.environ.get("BSMR_SDDMM_PACK_TIMING"):
        total = sum(last_stage_times.values())
        print("pack stages: " + " ".join(
            f"{k}={v:.2f}s" for k, v in last_stage_times.items())
            + f" total={total:.2f}s")

    return PackedMatrix(
        m=m, n=n, k_hint=k_hint, nnz=csr.nnz, carve_cost_ns=carve_cost_ns,
        num_panels=num_panels, num_blocks=num_blocks,
        num_super=num_super, num_quads=num_quads, num_pairs=num_pairs,
        num_groups=num_groups,
        super_buckets=tuple(fam_buckets[_FAM_SUPER]),
        quad_buckets=tuple(fam_buckets[_FAM_QUAD]),
        pair_buckets=tuple(fam_buckets[_FAM_PAIR]),
        group_buckets=tuple(fam_buckets[_FAM_GROUP]),
        group_size=G, num_col_groups=NG,
        col_order=col_order,
        a_row_gather=a_row_gather,
        super_rows=super_rows, super_cols=super_cols,
        super_gids=super_gids.astype(np.int32), super_csr=super_csr,
        quad_rows=quad_rows_a.astype(np.int32), quad_cols=quad_cols,
        quad_gids=quad_gids.astype(np.int32), quad_csr=quad_csr,
        pair_rows=pair_rows_a.astype(np.int32), pair_cols=pair_cols,
        pair_gids=pair_gids.astype(np.int32), pair_csr=pair_csr,
        group_rows=group_rows.astype(np.int32),
        group_cols=group_cols,
        group_gids=group_gids.astype(np.int32),
        group_csr=group_csr,
        res_rows=res_rows, res_cols=res_cols,
        res_gids=res_gids_arr.astype(np.int32),
        res_member=res_member_arr.astype(np.int32),
        res_csr=res_csr,
        hub_cols=H,
        hub_rows=hub_rows_arr, hub_rank=hub_rank_arr, hub_csr=hub_csr_arr,
        rowslab_rows=rowslab_rows_arr,
        rowslab_erows=rs_rows_e, rowslab_rank=rs_rank_e,
        rowslab_csr=rs_csr_e,
        inv_idx=inv_idx,
        packed_rows=packed_rows,
        packed_cols=packed_cols,
        csr_dest=csr_dest,
        cont_panel_off=cont_panel_off,
        cont_panel_ids=cont_panel_ids,
        super_run_cont=run_cont[_FAM_SUPER],
        quad_run_cont=run_cont[_FAM_QUAD],
        pair_run_cont=run_cont[_FAM_PAIR],
        group_run_cont=run_cont[_FAM_GROUP],
    )
