"""Hybrid structure plan for refined (AMR-carrying) grids.

Port of ``dccrg_tpu/hybrid.py``: its NumPy paths, and its native fast
paths (the batched level lookup, the in-place far/easy/hard table
writers and the stream merge of dccrg_tpu_torch/native), which write
the same tables bit for bit. The generic plan builder
streams ~26 neighbor entries per cell through the engine even when
almost all of the grid sits in uniform same-level blocks; this builder
rests on one observation: **a cell whose whole (symmetric)
neighborhood consists of same-level leaves resolves closed-form** — at
any level — because level-l ids are linear in the level-l lattice
coordinates (dccrg_mapping.hpp:154-209). Cells are classified per
level:

- level-0 cells away from any refined slot (box-dilated refined-root
  lattice) are *far*: their tables come from the level-0 lattice maps;
- level-l (l >= 1) cells whose neighbors at every symmetrized offset
  exist as level-l leaves are *easy*: neighbor positions come from
  level-l index arithmetic;
- everything else — the shell of cells near a level transition — is
  *hard* and runs through the generic engine
  (``neighbors.find_neighbors_of``), so engine cost scales with the
  refinement surface, not the grid.

All three classes merge into the row layout, ghost sets and
send/receive lists of the generic builder: on n partitions every
cross-partition edge makes both of its cells outer and gives each side
a ghost row of the other, found once per edge at its source's class.
Stencil tables are split: far/easy rows share a dense ``[n_dev, L, k]``
table whose offsets are per-slot constants scaled by a per-row cell
size, hard rows get their own compact ``[n_dev, H, S_hard]`` tables
with explicit offsets; stencils run the kernel over both and merge
(grid.py). The neighbors_to tables are built lazily on first use.
"""

from __future__ import annotations

import os
import time
import weakref

import numpy as np

from . import faults, telemetry

#: Optional phase-record sink: a list that every build appends
#: ``(label, seconds)`` tuples to (``chip_smoke.py``'s AMR phase
#: installs one to print per-phase timings).
_PHASE_SINK = None


def _phase_timer():
    """Phase-boundary logger: prints with ``DCCRG_TIMING=1``, records
    into :data:`_PHASE_SINK` when one is installed, and records each
    phase as a ``hybrid.<label>`` telemetry span when tracing is on."""
    sink = _PHASE_SINK
    echo = os.environ.get("DCCRG_TIMING") == "1"
    trace = telemetry.trace_enabled()
    if sink is None and not echo and not trace:
        return lambda label: None
    state = {"t": time.perf_counter()}

    def mark(label):
        now = time.perf_counter()
        dt = now - state["t"]
        if echo:
            print(f"[hybrid] {label}: {dt:.3f}s", flush=True)
        if sink is not None:
            sink.append((label, dt))
        if trace:
            telemetry.record_span("hybrid." + label.replace(" ", "_"), dt)
        state["t"] = now

    return mark


def _fill_chunked(view, value, chunk_bytes=64 << 20):
    """Fill a (possibly huge) array chunk-wise: same result as a full
    ``arr[:] = value``, each slice within one cache-friendly window."""
    flat = view.reshape(-1)
    step = max(1, chunk_bytes // max(1, flat.itemsize))
    for i in range(0, flat.size, step):
        flat[i:i + step] = value


class PlanArena:
    """Per-grid pool of the large plan-table buffers, reused across
    structure epochs, so a recommit writes warm pages instead of
    faulting in fresh ones.

    - :meth:`begin` opens a build and reclaims the buffers of every plan
      generation that is not *protected* (the live plan stays
      protected, so a build never scribbles on the tables in use);
    - :meth:`take` hands out a reclaimed-or-fresh buffer view, filled
      chunk-wise when a fill value is given;
    - :meth:`bind` transfers ownership of everything taken to the newly
      built plan. Lazy table thunks append to the same ownership list
      after the fact, so late-materialized to-tables are pooled too.
    """

    def __init__(self):
        self._free = {}      # dtype str -> [1-D raw buffers]
        self._owned = []     # [(weakref(plan), [buffers])]
        self._pending = []   # buffers taken by the in-flight build
        self.hits = 0        # takes served from the pool
        self.misses = 0      # takes that allocated fresh pages

    def begin(self, protect=()):
        """Open a build: reclaim every unprotected generation."""
        protected = {id(p) for p in protect if p is not None}
        survivors = []
        for ref, bufs in self._owned:
            plan = ref()
            if plan is not None and id(plan) in protected:
                survivors.append((ref, bufs))
            else:
                for b in bufs:
                    self._free.setdefault(b.dtype.str, []).append(b)
        self._owned = survivors
        for b in self._pending:
            self._free.setdefault(b.dtype.str, []).append(b)
        self._pending = []
        return self._pending

    def take(self, shape, dtype, fill=None, owner=None):
        """A ``shape``/``dtype`` array backed by a pooled buffer (the
        smallest free one that fits; a fresh power-of-two allocation
        otherwise). ``owner`` is the ownership list to register the
        buffer on (defaults to the current build's)."""
        dtype = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        pool = self._free.get(dtype.str, ())
        best = None
        for i, b in enumerate(pool):
            if b.size >= n and (best is None or b.size < pool[best].size):
                best = i
        if best is not None:
            buf = pool.pop(best)
            self.hits += 1
        else:
            # geometric growth: a drifting refined region re-allocates
            # O(log) times ever
            cap = max(1 << max(0, int(n - 1).bit_length()), 1)
            buf = np.empty(cap, dtype=dtype)
            self.misses += 1
        (self._pending if owner is None else owner).append(buf)
        view = buf[:n].reshape(shape)
        if fill is not None:
            _fill_chunked(view, fill)
        return view

    def current_owner(self):
        """The in-flight build's ownership list (lazy thunks register
        their takes on it)."""
        return self._pending

    def bind(self, plan):
        """Transfer the in-flight build's buffers to ``plan``; returns
        the ownership list so lazy thunks can keep appending to it."""
        owned = self._pending
        self._owned.append((weakref.ref(plan), owned))
        self._pending = []
        return owned

    def stats(self) -> dict:
        pooled = sum(b.nbytes for bufs in self._free.values() for b in bufs)
        owned = sum(b.nbytes for _r, bufs in self._owned for b in bufs)
        return {"hits": self.hits, "misses": self.misses,
                "free_bytes": int(pooled), "owned_bytes": int(owned)}


def _per_dim_radius(neighborhoods) -> np.ndarray:
    """Per-dimension max |offset| over all neighborhoods (x, y, z)."""
    rho = np.zeros(3, dtype=np.int64)
    for offs in neighborhoods.values():
        o = np.asarray(offs, dtype=np.int64).reshape(-1, 3)
        rho = np.maximum(rho, np.abs(o).max(axis=0))
    return rho


def _check_offsets(neighborhoods) -> np.ndarray:
    """The symmetrized union offset set {+-o} over all neighborhoods:
    easiness must be symmetric, so the lazy neighbors_to tables of an
    easy cell stay closed-form."""
    alls = [np.asarray(o, dtype=np.int64).reshape(-1, 3)
            for o in neighborhoods.values()]
    cat = np.concatenate(alls + [-a for a in alls])
    return np.unique(cat, axis=0)


class _LevelBlock:
    """Per-(refinement level >= 1) neighbor-position cache.

    For the contiguous block of level-l cells in the sorted cell list,
    ``lookup(offset)`` returns ``(pos, valid, exist)``: the position in
    the cell list of each cell's same-level neighbor at the given
    cell-unit offset, whether that neighbor slot is inside the grid,
    and whether it exists as a level-l leaf."""

    # level lattices above this are looked up by binary search instead
    # of a position lattice (NumPy path; the native batch switches
    # strategy at the larger _PLAT_MAX_NATIVE — its lattice lives in
    # the arena, so the fill cost is paid on warm pages)
    _PLAT_MAX = 1 << 25
    _PLAT_MAX_NATIVE = 1 << 27

    def __init__(self, mapping, periodic, cells, level, a, b, arena=None):
        self.a, self.b = a, b
        self.level = level
        self.cells = cells
        nx, ny, nz = (int(v) for v in mapping.length.get())
        self.dims = (nx << level, ny << level, nz << level)
        self.first = np.int64(mapping._level_first[level])
        self.size = 1 << (mapping.max_refinement_level - level)
        self.periodic = periodic
        self._arena = arena
        lin = (cells[a:b] - np.uint64(self.first)).astype(np.int64)
        self.lin = lin
        nxl, nyl, nzl = self.dims
        self.x = lin % nxl
        self.y = (lin // nxl) % nyl
        self.z = lin // (nxl * nyl)
        self._cache = {}
        self._batch = None  # (pos_all, valid_all, off key -> batch row)
        # all level-l cells are contiguous in the sorted cell array, so
        # a direct lin -> position lattice replaces the per-offset
        # binary search when the level lattice fits in memory (the
        # native batch of precompute builds its own)
        n_lat = nxl * nyl * nzl
        from . import native

        if native.lib() is None and n_lat <= self._PLAT_MAX:
            self._plat = np.full(n_lat, -1, dtype=np.int32)
            self._plat[lin] = np.arange(a, b, dtype=np.int32)
        else:
            self._plat = None

    def precompute(self, offs_batch):
        """Batched native lookup of the whole offset set in one call
        (one lattice build amortized over every offset, positions as
        int32); a no-op without the native engine — ``lookup`` then runs
        the per-offset NumPy path with identical plan-level results."""
        from . import native

        if native.lib() is None or self.b > 2**31 - 2:
            return
        offs_batch = np.ascontiguousarray(offs_batch,
                                          dtype=np.int64).reshape(-1, 3)
        kb, m = len(offs_batch), self.b - self.a
        take = (self._arena.take if self._arena is not None
                else lambda shape, dtype: np.empty(shape, dtype))
        pos = take((kb, m), np.int32)
        valid = take((kb, m), bool)
        exist = take((kb, m), bool)
        n_lat = int(np.prod(np.asarray(self.dims, dtype=np.int64)))
        plat = (take((n_lat,), np.int32)
                if n_lat <= self._PLAT_MAX_NATIVE else None)
        native.level_lookup(
            self.dims, self.periodic, self.lin, self.a, self.cells, self.b,
            self.first, offs_batch, plat, pos, valid, exist,
        )
        rows = {}
        for j, off in enumerate(offs_batch):
            key = (int(off[0]), int(off[1]), int(off[2]))
            self._cache[key] = (pos[j], valid[j], exist[j])
            rows[key] = j
        self._batch = (pos, valid, rows)

    def batch_rows(self, offs):
        """(pos_all, valid_all, sel) of the precomputed batch covering
        every offset in ``offs`` — the zero-copy form dn_easy_tables
        consumes — or None when no batch covers them."""
        if self._batch is None:
            return None
        pos, valid, rows = self._batch
        sel = np.empty(len(offs), dtype=np.int64)
        for j, o in enumerate(offs):
            row = rows.get((int(o[0]), int(o[1]), int(o[2])))
            if row is None:
                return None
            sel[j] = row
        return pos, valid, sel

    def lookup(self, off):
        key = (int(off[0]), int(off[1]), int(off[2]))
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        nxl, nyl, nzl = self.dims
        xs = self.x + key[0]
        ys = self.y + key[1]
        zs = self.z + key[2]
        valid = np.ones(len(xs), dtype=bool)
        for arr, nl, per in ((xs, nxl, self.periodic[0]),
                             (ys, nyl, self.periodic[1]),
                             (zs, nzl, self.periodic[2])):
            if per:
                arr %= nl
            else:
                valid &= (arr >= 0) & (arr < nl)
        lin_n = np.where(valid, xs + nxl * (ys + nyl * zs), 0)
        if self._plat is not None:
            p32 = self._plat[lin_n]
            exist = (p32 >= 0) & valid
            pos = np.where(exist, p32, 0).astype(np.int64)
        else:
            nid = (self.first + lin_n).astype(np.uint64)
            pos = np.minimum(np.searchsorted(self.cells, nid),
                             len(self.cells) - 1)
            exist = (self.cells[pos] == nid) & valid
            pos = pos.astype(np.int64)
        out = (pos, valid, exist)
        self._cache[key] = out
        return out


def _merge_streams(fresh, reused):
    """Merge two entry streams sorted by source position that share no
    source: a linear merge, within-source order kept piecewise."""
    spos, npos, off, item = fresh
    spos_b, npos_b, off_b, item_b = reused
    na, nb = len(spos), len(spos_b)
    at = np.searchsorted(spos_b, spos) + np.arange(na)
    bt = np.searchsorted(spos, spos_b) + np.arange(nb)
    out = []
    for a_arr, b_arr in ((spos, spos_b), (npos, npos_b), (off, off_b),
                         (item, item_b)):
        m = np.empty((na + nb,) + a_arr.shape[1:], dtype=a_arr.dtype)
        m[at] = a_arr
        m[bt] = b_arr
        out.append(m)
    return tuple(out)


def build_hybrid_plan(mapping, topology, neighborhoods, cells, owner, n_dev,
                      cap=None, reuse=None, arena=None, changed_hint=None):
    """All plan pieces for a refined grid on ``n_dev`` partitions.

    Returns ``(layout, hood_data)`` like uniform.build_uniform_plan:
    layout holds local_ids / ghost_ids / n_local / n_inner / L / R /
    row_of_pos / scale_rows; hood_data maps hood id -> dict with the
    split gather tables, a lazy neighbors_to thunk and the send/receive
    lists.

    ``arena`` is the grid's :class:`PlanArena` (opened with ``begin``
    by the caller). ``reuse`` is the grid's epoch-to-epoch cache of the
    hard shell's neighbor streams: a hard cell whose search box is
    untouched since the previous build keeps its stream, only its
    positions are remapped. ``changed_hint`` is ``(prev_cells,
    changed_ids)``: when ``prev_cells`` is the reuse cache's cell list
    (the same object), ``changed_ids`` replaces the set difference of
    the two epochs' cell lists (an owner-only rebuild, a balance, passes
    an empty set and reuses every stream).
    """
    from . import native
    from .amr import _box_dilate
    from .grid import DEFAULT_NEIGHBORHOOD_ID
    from .neighbors import find_neighbors_of
    from .uniform import _NeighborMaps, build_pair_tables

    mark = _phase_timer()
    if arena is None:
        arena = PlanArena()
        arena.begin()
    owned = arena.current_owner()

    dims = tuple(int(v) for v in mapping.length.get())
    nx, ny, nz = dims
    n0 = nx * ny * nz
    if n0 >= 2**31 - 2:
        raise ValueError(f"hybrid fast path limited to < 2^31 level-0 cells, got {n0}")
    size0 = 1 << mapping.max_refinement_level
    periodic = tuple(topology.is_periodic(d) for d in range(3))
    owner = np.asarray(owner, dtype=np.int32)
    cells = np.asarray(cells, dtype=np.uint64)
    n = len(cells)
    # the in-place table writers emit int32 position sentinels
    use_native = native.lib() is not None and n < 2**31 - 2
    multi = n_dev > 1

    # level-major ids: the level-0 subset is exactly the sorted prefix
    # of ids <= n0 (dccrg_mapping.hpp:154-209)
    n_lvl0 = int(np.searchsorted(cells, np.uint64(n0), side="right"))
    lvl0_gidx = cells[:n_lvl0].astype(np.int64) - 1
    present = arena.take((n0,), bool, fill=False)
    present[lvl0_gidx] = True
    pos0 = arena.take((n0,), np.int64, fill=-1)  # slot -> position in `cells`
    pos0[lvl0_gidx] = np.arange(n_lvl0)

    # --- level-0 classification: refined slots box-dilated ------------
    rho = _per_dim_radius(neighborhoods)
    lat = _box_dilate(
        (~present).reshape(nz, ny, nx),  # axis0=z, axis1=y, axis2=x
        (rho[2], rho[1], rho[0]),
        (periodic[2], periodic[1], periodic[0]),
    )
    hard_lat = lat.reshape(-1)
    far = present & ~hard_lat
    far_slots = np.nonzero(far)[0]
    hard0_slots = np.nonzero(present & hard_lat)[0]

    # owner per level-0 slot (refined slots hold garbage, only ever
    # indexed through far sources, whose windows are always present)
    owner0 = arena.take((n0,), np.int32, fill=0)
    owner0[lvl0_gidx] = owner[:n_lvl0]

    maps = _NeighborMaps(dims, periodic)

    # --- per-level (>= 1) classification: easy vs hard ----------------
    check_offs = _check_offsets(neighborhoods)
    blocks = []  # (_LevelBlock, easy bool array over the block)
    hard_parts = [pos0[hard0_slots]]
    max_lvl = mapping.max_refinement_level
    for l in range(1, max_lvl + 1):
        first = np.uint64(mapping._level_first[l])
        last = (np.uint64(mapping._level_first[l + 1]) if l < max_lvl
                else np.uint64(mapping.last_cell) + np.uint64(1))
        a = int(np.searchsorted(cells, first))
        b = int(np.searchsorted(cells, last))
        if a == b:
            continue
        blk = _LevelBlock(mapping, periodic, cells, l, a, b, arena=arena)
        # one native batch resolves every symmetrized offset for the
        # whole block (classification, easy tables, boundary edges and
        # the lazy to-tables all draw on this cache)
        blk.precompute(check_offs)
        easy = np.ones(b - a, dtype=bool)
        for off in check_offs:
            _pos, valid, exist = blk.lookup(off)
            easy &= exist | ~valid
        blocks.append((blk, easy))
        hard_parts.append(a + np.nonzero(~easy)[0])

    hard_pos = np.concatenate(hard_parts)
    hard_pos.sort(kind="stable")
    hard_cells = cells[hard_pos]
    mark(f"classify (hard {len(hard_pos)}/{n})")
    faults.fire("hybrid.recommit", phase="classified")

    # --- hard streams (generic engine on the hard shell) --------------
    # Epoch-to-epoch reuse: a hard cell whose whole search box is
    # untouched since the previous build has an IDENTICAL neighbor
    # stream — only the positions shift. The changed region is the set
    # difference of the two cell sets box-dilated by the search radius
    # + 1 on the level-0 lattice; only the dirty part of the hard shell
    # reruns the engine (the reference's incremental rebuild,
    # dccrg.hpp:10642-10690).
    size0_log2 = mapping.max_refinement_level
    hood_fp = tuple(sorted(
        (hid, offs.tobytes()) for hid, offs in neighborhoods.items()))

    def lvl0_gidx_of(ids):
        idx = np.asarray(mapping.get_indices(ids), dtype=np.int64) >> size0_log2
        return idx[:, 0] + nx * (idx[:, 1] + ny * idx[:, 2])

    reusable = None
    if reuse and reuse.get("fp") == (dims, hood_fp):
        prev_cells = reuse["cells"]
        if changed_hint is not None and changed_hint[0] is prev_cells:
            # the commit already knows which ids appeared/disappeared
            changed = np.asarray(changed_hint[1], dtype=np.uint64)
        else:
            changed = np.concatenate([
                np.setdiff1d(cells, prev_cells, assume_unique=True),
                np.setdiff1d(prev_cells, cells, assume_unique=True),
            ])
        if len(changed):
            lat_ch = np.zeros(n0, dtype=bool)
            lat_ch[lvl0_gidx_of(changed)] = True
            dirty = _box_dilate(
                lat_ch.reshape(nz, ny, nx),
                (int(rho[2]) + 1, int(rho[1]) + 1, int(rho[0]) + 1),
                (periodic[2], periodic[1], periodic[0]),
            ).reshape(-1)
        else:
            dirty = np.zeros(n0, dtype=bool)
        clean_hard = hard_cells[~dirty[lvl0_gidx_of(hard_cells)]]
        reusable = np.intersect1d(clean_hard, reuse["hard_ids"],
                                  assume_unique=True)
        if len(reusable) == 0:
            reusable = None

    streams = {}
    new_cache = {"fp": (dims, hood_fp), "cells": cells,
                 "hard_ids": hard_cells, "streams": {}}
    if reusable is None:
        fresh_hard, fresh_pos = hard_cells, hard_pos
    else:
        fm = ~np.isin(hard_cells, reusable, assume_unique=True)
        fresh_hard, fresh_pos = hard_cells[fm], hard_pos[fm]
        # one position remap for the whole epoch: old position -> new
        # position (every reused entry's source AND neighbor survive),
        # plus a reusable-source mask over old positions
        prev_cells = reuse["cells"]
        old2new = native.sorted_positions(cells, prev_cells)
        if old2new is None:
            old2new = np.searchsorted(cells, prev_cells)
        reus_old = np.zeros(len(prev_cells), dtype=bool)
        rpos = native.sorted_positions(prev_cells, reusable)
        if rpos is None:
            rpos = np.searchsorted(prev_cells, reusable)
        reus_old[rpos] = True
    for hid, offs in neighborhoods.items():
        src, nbr, off, item = find_neighbors_of(
            mapping, topology, cells, fresh_hard, offs
        )
        off = off.astype(np.int64)
        spos = fresh_pos[src]
        npos = np.searchsorted(cells, nbr)
        if reusable is not None:
            merged = native.stream_remap_merge(
                old2new, reus_old, reuse["streams"][hid],
                (spos, npos, off, item))
            if merged is None:
                ps_pos, pn_pos, po, pi = reuse["streams"][hid]
                keep = reus_old[ps_pos]
                merged = _merge_streams(
                    (spos, npos, off, item),
                    (old2new[ps_pos[keep]], old2new[pn_pos[keep]], po[keep],
                     pi[keep]))
            spos, npos, off, item = merged
        new_cache["streams"][hid] = (spos, npos, off, item)
        streams[hid] = (spos, npos, off, item)
    if reuse is not None:
        reuse.clear()
        reuse.update(new_cache)
    faults.fire("hybrid.recommit", phase="cached")
    mark(f"hard streams (reused {0 if reusable is None else len(reusable)}"
         f"/{len(hard_cells)})")

    # --- boundary classification + ghost sets -------------------------
    # every cross-partition of-edge (c -> v) makes both endpoints outer
    # (c via its of-list, v via its to-list) and creates two ghost
    # reads: partition(c) reads v, partition(v) reads c. Edges are
    # enumerated once, at their source's class (far lattice, easy block
    # or hard stream), which covers the full edge set.
    outer = np.zeros(n, dtype=bool)
    ghost_reader = [np.empty(0, np.int32)]
    ghost_pos = [np.empty(0, np.int64)]

    def note_cross(sp, npos, default):
        if default:
            outer[sp] = True
            outer[npos] = True
        ghost_reader.append(owner[sp])
        ghost_pos.append(npos)
        ghost_reader.append(owner[npos])
        ghost_pos.append(sp)

    if multi:
        for hid, offs in neighborhoods.items():
            default = hid == DEFAULT_NEIGHBORHOOD_ID
            for o in np.asarray(offs, dtype=np.int64).reshape(-1, 3):
                ng, valid = maps.shift(o)
                m = far & valid
                cross = np.nonzero(m & (owner0[ng] != owner0))[0]
                if len(cross):
                    note_cross(pos0[cross], pos0[ng[cross]], default)
                for blk, easy in blocks:
                    pos_n, _valid, exist = blk.lookup(o)
                    sel = np.nonzero(
                        easy & exist & (owner[pos_n] != owner[blk.a:blk.b])
                    )[0]
                    if len(sel):
                        note_cross(blk.a + sel, pos_n[sel], default)
            s_p, s_n, _, _ = streams[hid]
            cm = np.nonzero(owner[s_p] != owner[s_n])[0]
            if len(cm):
                note_cross(s_p[cm], s_n[cm], default)
    mark("classification")
    g_r = np.concatenate(ghost_reader)
    g_p = np.concatenate(ghost_pos)

    # --- row layout: [inner | outer] local rows, then ghost rows -------
    local_ids, ghost_ids, ghost_pos_sorted = [], [], []
    n_inner = np.zeros(n_dev, np.int64)
    for d in range(n_dev):
        mine = owner == d
        inner = cells[mine & ~outer]
        outerc = cells[mine & outer]
        local_ids.append(np.concatenate([inner, outerc]))
        n_inner[d] = len(inner)
        gp = np.unique(g_p[g_r == d])
        ghost_pos_sorted.append(gp)
        ghost_ids.append(cells[gp])

    from .grid import bucket_capacity

    if cap is None:
        cap = lambda name, needed: bucket_capacity(needed)
    n_local = np.array([len(x) for x in local_ids], dtype=np.int64)
    n_ghost = np.array([len(x) for x in ghost_ids], dtype=np.int64)
    L = cap("L", max(1, int(n_local.max())))
    G = int(n_ghost.max()) if multi else 0
    G = cap("G", G) if G else 0
    R = L + G + 1  # final row = permanent zero pad

    # every cell is local to exactly one partition, so the scatter below
    # writes every entry
    row_of_pos = arena.take((n,), np.int32)
    for d in range(n_dev):
        lpos = np.searchsorted(cells, local_ids[d])
        row_of_pos[lpos] = np.arange(len(local_ids[d]), dtype=np.int32)

    def resolve_rows(pos_arr, dev_arr):
        """Row of each cell (by position) on the given reader
        partition: its local row when the reader owns it, its ghost row
        otherwise."""
        pos_arr = np.asarray(pos_arr, dtype=np.int64)
        dev_arr = np.asarray(dev_arr)
        rows = np.empty(len(pos_arr), dtype=np.int32)
        loc = owner[pos_arr] == dev_arr
        rows[loc] = row_of_pos[pos_arr[loc]]
        rm = np.nonzero(~loc)[0]
        for d in np.unique(dev_arr[rm]):
            mm = rm[dev_arr[rm] == d]
            gps = ghost_pos_sorted[d]
            gi = np.minimum(np.searchsorted(gps, pos_arr[mm]),
                            max(len(gps) - 1, 0))
            if len(mm) and (len(gps) == 0 or np.any(gps[gi] != pos_arr[mm])):
                raise AssertionError(
                    "ghost coverage bug: neighbor without a row on its "
                    "reader's partition")
            rows[mm] = (L + gi).astype(np.int32)
        return rows

    far_pos = pos0[far_slots]
    far_dev = owner[far_pos].astype(np.int64)
    far_rowidx = far_dev * L + row_of_pos[far_pos]
    if use_native:
        # level-0 slot -> row on its owner, for the native far-row writer
        row_of_pos0 = arena.take((n0,), np.int32, fill=0)
        row_of_pos0[lvl0_gidx] = row_of_pos[:n_lvl0]

    # per-row cell size in index units (far/easy rows; hard rows get
    # explicit offsets, pad rows never pass a mask)
    scale_rows = arena.take((n_dev * L,), np.int32, fill=0)
    scale_rows[far_rowidx] = size0
    easy_rowidx = {}
    for blk, easy in blocks:
        ei = np.nonzero(easy)[0]
        ridx = owner[blk.a + ei].astype(np.int64) * L + row_of_pos[blk.a + ei]
        easy_rowidx[blk.level] = (ei, ridx)
        scale_rows[ridx] = blk.size
    mark("row layout")

    # --- gather tables per hood (split far+easy / hard) ---------------
    hood_data = {}
    # rows covered by the far/easy full-width writes below: the pad
    # fill only needs the complement (hard + pad rows)
    covered = arena.take((n_dev * L,), bool, fill=False)
    covered[far_rowidx] = True
    for _blk_c, _easy_c in blocks:
        covered[easy_rowidx[_blk_c.level][1]] = True
    uncovered_rows = np.nonzero(~covered)[0]
    del covered

    for hid, offs_in in neighborhoods.items():
        offs = np.asarray(offs_in, dtype=np.int64).reshape(-1, 3)
        k = len(offs)
        s_p, s_n, s_off, s_item = streams[hid]
        nE = len(s_p)

        # far + easy + uncovered partition the rows, so every entry is
        # written below — no full-table pre-fill pass
        rows_t = arena.take((n_dev * L, k), np.int32)
        mask_t = arena.take((n_dev * L, k), bool)
        rows_t[uncovered_rows] = R - 1
        mask_t[uncovered_rows] = False

        # far rows: the level-0 lattice maps, written straight into the
        # table by the native writer when it is on; an entry whose
        # neighbour another partition owns comes back as a ``-2 - slot``
        # sentinel and is resolved to its ghost row here
        if use_native:
            fix = native.far_tables(dims, periodic, offs, far_slots, far_rowidx,
                                    row_of_pos0, owner0 if multi else None,
                                    R - 1, rows_t, mask_t)
            if len(fix):
                ci, cj = fix // k, fix % k
                nslot = (-2 - rows_t[far_rowidx[ci], cj]).astype(np.int64)
                rows_t[far_rowidx[ci], cj] = resolve_rows(
                    pos0[nslot], far_dev[ci])
            mark(f"tables[{hid}]: far direct ({len(fix)} fixups)")
        else:
            fr = np.empty((len(far_slots), k), dtype=np.int32)
            fm = np.empty((len(far_slots), k), dtype=bool)
            for j, o in enumerate(offs):
                ng, valid = maps.shift(o)
                vf = valid[far_slots]
                rows = np.full(len(far_slots), R - 1, dtype=np.int32)
                vv = np.nonzero(vf)[0]
                rows[vv] = resolve_rows(pos0[ng[far_slots][vv]], far_dev[vv])
                fr[:, j] = rows
                fm[:, j] = vf
            rows_t[far_rowidx] = fr
            mask_t[far_rowidx] = fm
            del fr, fm
            mark(f"tables[{hid}]: far scatter")

        # easy rows: level-l index arithmetic, all offsets batched
        for blk, easy in blocks:
            ei, ridx = easy_rowidx[blk.level]
            E = len(ei)
            if E == 0:
                continue
            batch = blk.batch_rows(offs) if use_native else None
            if batch is not None:
                pos_all, valid_all, sel = batch
                edev32 = (np.ascontiguousarray(owner[blk.a + ei])
                          if multi else None)
                fix = native.easy_tables(
                    ei, ridx, sel, pos_all, valid_all, blk.b - blk.a,
                    row_of_pos, owner if multi else None, edev32,
                    R - 1, rows_t, mask_t,
                )
                if len(fix):
                    ce, cj = fix // k, fix % k
                    p = (-2 - rows_t[ridx[ce], cj]).astype(np.int64)
                    rows_t[ridx[ce], cj] = resolve_rows(
                        p, owner[blk.a + ei[ce]].astype(np.int64))
                mark(f"tables[{hid}]: easy block l{blk.level} "
                     f"({len(fix)} fixups)")
                continue
            edev = owner[blk.a + ei].astype(np.int64)
            posm = np.empty((E, k), dtype=np.int64)
            validm = np.empty((E, k), dtype=bool)
            for j, o in enumerate(offs):
                pos_n, valid, _exist = blk.lookup(o)
                posm[:, j] = pos_n[ei]
                validm[:, j] = valid[ei]
            rows = np.full(E * k, R - 1, dtype=np.int32)
            vv = np.nonzero(validm.reshape(-1))[0]
            if len(vv):
                rows[vv] = resolve_rows(posm.reshape(-1)[vv],
                                        np.repeat(edev, k)[vv])
            rows_t[ridx] = rows.reshape(E, k)
            mask_t[ridx] = validm
            mark(f"tables[{hid}]: easy block l{blk.level}")

        # hard rows: compact per-partition tables from the stream,
        # grouped by source
        hard_rows_dev = hard_nbr_dev = hard_offs_dev = hard_mask_dev = None
        if nE and use_native:
            # fused native writer: shape probe, then grouping + entry
            # scatter + pad fill in one sequential pass — every table
            # byte written exactly once
            _nG, s_need, counts = native.hard_counts(
                s_p, owner if multi else None, n_dev)
            S_hard = cap(("S_hard", hid), max(1, int(s_need)))
            Hmax = cap(("Hmax", hid), max(1, int(counts.max())))
            mark(f"tables[{hid}]: hard grouping (H {int(counts.max())}"
                 f"/{Hmax}, S {int(s_need)}/{S_hard})")
            hard_rows_dev = arena.take((n_dev, Hmax), np.int32)
            hard_nbr_dev = arena.take((n_dev, Hmax, S_hard), np.int32)
            hard_offs_dev = arena.take((n_dev, Hmax, S_hard, 3), np.int32)
            hard_mask_dev = arena.take((n_dev, Hmax, S_hard), bool)
            fix = native.hard_fill(
                s_p, s_n, s_off, owner if multi else None, row_of_pos,
                n_dev, Hmax, S_hard, L, R - 1,
                hard_rows_dev, hard_nbr_dev, hard_offs_dev, hard_mask_dev,
            )
            if len(fix):
                flat = hard_nbr_dev.reshape(-1)
                rdev = fix // (Hmax * S_hard)  # reader partition of the entry
                p = (-2 - flat[fix]).astype(np.int64)
                flat[fix] = resolve_rows(p, rdev)
            mark(f"tables[{hid}]: hard assembly ({len(fix)} fixups)")
        elif nE:
            # slot = rank within the (contiguous, source-sorted) group
            changed = np.empty(nE, dtype=bool)
            changed[0] = True
            changed[1:] = s_p[1:] != s_p[:-1]
            gstart = np.maximum.accumulate(np.where(changed, np.arange(nE), 0))
            slot = np.arange(nE) - gstart
            S_hard = cap(("S_hard", hid), max(1, int(slot.max()) + 1))
            grp = np.cumsum(changed) - 1  # entry -> group [0, nG)
            gsel = np.nonzero(changed)[0]  # one entry per source cell
            g_dev = owner[s_p[gsel]].astype(np.int64)
            g_row = row_of_pos[s_p[gsel]]
            counts = np.bincount(g_dev, minlength=n_dev)
            # dense position per partition: consecutive in stream
            # (= cell id) order
            gorder = np.argsort(g_dev, kind="stable")
            dense_idx = np.empty(len(gsel), dtype=np.int64)
            dev_first = np.concatenate([[0], np.cumsum(counts)[:-1]])
            dense_idx[gorder] = np.arange(len(gsel)) - dev_first[g_dev[gorder]]
            Hmax = cap(("Hmax", hid), max(1, int(counts.max())))
            hard_rows_dev = arena.take((n_dev, Hmax), np.int32,
                                       fill=L)  # pad=L: dropped
            hard_nbr_dev = arena.take((n_dev, Hmax, S_hard), np.int32,
                                      fill=R - 1)
            hard_offs_dev = arena.take((n_dev, Hmax, S_hard, 3), np.int32,
                                       fill=0)
            hard_mask_dev = arena.take((n_dev, Hmax, S_hard), bool,
                                       fill=False)
            hard_rows_dev[g_dev, dense_idx] = g_row.astype(np.int32)
            e_dev = g_dev[grp]
            e_pos = dense_idx[grp]
            hard_nbr_dev[e_dev, e_pos, slot] = resolve_rows(s_n, owner[s_p])
            hard_offs_dev[e_dev, e_pos, slot] = s_off.astype(np.int32)
            hard_mask_dev[e_dev, e_pos, slot] = True
            mark(f"tables[{hid}]: hard assembly")

        offs_const = offs.astype(np.int32)  # [k, 3], CELL units (x scale_rows)

        def offs_thunk(mask_t=mask_t, offs_const=offs_const, k=k):
            # far/easy per-slot offsets (hard rows carry theirs in the
            # compact hard tables); runs after bind, so the take lands
            # on the plan's owned list
            out = arena.take((n_dev * L, k, 3), np.int32, owner=owned)
            np.multiply(mask_t[:, :, None], offs_const[None, :, :], out=out)
            out *= scale_rows[:, None, None]
            return out.reshape(n_dev, L, k, 3)

        hood_data[hid] = {
            "nbr_rows": rows_t.reshape(n_dev, L, k),
            "nbr_offs": offs_thunk,
            "offs_const": offs_const,
            "nbr_mask": mask_t.reshape(n_dev, L, k),
            "hard_rows": hard_rows_dev,
            "hard_nbr_rows": hard_nbr_dev,
            "hard_offs": hard_offs_dev,
            "hard_mask": hard_mask_dev,
        }
        mark(f"tables hood {hid}")

    faults.fire("hybrid.recommit", phase="tables")

    # --- send / receive lists -----------------------------------------
    pair_compact = build_pair_tables(
        ghost_pos_sorted, n_dev,
        lambda keys: owner[keys],
        lambda p_s, keys: row_of_pos[keys],
        lambda q_s, keys, gpos: (L + gpos).astype(np.int32),
        lambda needed: cap(("M", "hybrid"), needed),
    )
    for hid in neighborhoods:
        hood_data[hid]["pair_compact"] = pair_compact
    mark("send/recv lists")

    # --- lazy neighbors_to tables -------------------------------------
    is_hard_target = np.zeros(n, dtype=bool)
    is_hard_target[hard_pos] = True
    lvl_of_pos = np.zeros(n, dtype=np.int64)
    for blk, _easy in blocks:
        lvl_of_pos[blk.a:blk.b] = blk.level

    def make_to_thunk(hid, offs_in):
        offs = np.asarray(offs_in, dtype=np.int64).reshape(-1, 3)
        k = len(offs)

        def thunk():
            s_p, s_n, s_off, s_item = streams[hid]
            # inverted hard entries: keep when the TARGET is hard, or
            # when source and target levels differ (a same-level source
            # of a far/easy target is covered closed-form below)
            keep = is_hard_target[s_n] | (lvl_of_pos[s_p] != lvl_of_pos[s_n])
            tv, tc = s_n[keep], s_p[keep]
            toff = -s_off[keep]
            titem = s_item[keep]
            # same-level sources of hard targets that are far/easy
            # (enumerated from the target side)
            ex_v, ex_c, ex_off, ex_item = [], [], [], []
            if len(hard0_slots):
                for j, o in enumerate(offs):
                    ng, valid = maps.shift((-int(o[0]), -int(o[1]), -int(o[2])))
                    cslot = ng[hard0_slots]
                    ok = valid[hard0_slots] & far[cslot]
                    if ok.any():
                        hs = hard0_slots[ok]
                        ex_v.append(pos0[hs])
                        ex_c.append(pos0[cslot[ok]])
                        ex_off.append(
                            np.broadcast_to(
                                (-o * size0).astype(np.int64), (int(ok.sum()), 3)
                            )
                        )
                        ex_item.append(np.full(int(ok.sum()), j, dtype=np.int64))
            for blk, easy in blocks:
                hi = np.nonzero(~easy)[0]  # hard level-l targets
                if len(hi) == 0:
                    continue
                src_is_easy = np.zeros(len(cells), dtype=bool)
                src_is_easy[blk.a + np.nonzero(easy)[0]] = True
                for j, o in enumerate(offs):
                    pos_n, valid, exist = blk.lookup((-int(o[0]), -int(o[1]), -int(o[2])))
                    # source must exist as an easy level-l leaf
                    src_pos = pos_n[hi]
                    ok = exist[hi] & src_is_easy[src_pos]
                    if ok.any():
                        ex_v.append(blk.a + hi[ok])
                        ex_c.append(src_pos[ok])
                        ex_off.append(
                            np.broadcast_to(
                                (-o * blk.size).astype(np.int64), (int(ok.sum()), 3)
                            )
                        )
                        ex_item.append(np.full(int(ok.sum()), j, dtype=np.int64))
            if ex_v:
                tv = np.concatenate([tv] + ex_v)
                tc = np.concatenate([tc] + ex_c)
                toff = np.concatenate([toff] + ex_off)
                titem = np.concatenate([titem] + ex_item)
            # compact per target row, ordered by (source pos, item).
            # Hard target rows start at slot 0; far/easy target rows
            # hold closed-form same-level entries in slots [0, k), so
            # their (cross-level) entries start at slot k.
            order = np.lexsort((titem, tc, tv))
            tv, tc, toff = tv[order], tc[order], toff[order]
            nT = len(tv)
            if nT:
                changed = np.empty(nT, dtype=bool)
                changed[0] = True
                changed[1:] = tv[1:] != tv[:-1]
                gstart = np.maximum.accumulate(np.where(changed, np.arange(nT), 0))
                tslot = np.arange(nT) - gstart
                tslot += np.where(is_hard_target[tv], 0, k)
                T_hard = cap(("T_hard", hid), int(tslot.max()) + 1)
            else:
                tslot = np.empty(0, dtype=np.int64)
                T_hard = 0
            T = max(k, T_hard, 1)
            to_rows = arena.take((n_dev * L, T), np.int32, fill=R - 1,
                                 owner=owned)
            to_offs = arena.take((n_dev * L, T, 3), np.int32, fill=0,
                                 owner=owned)
            to_mask = arena.take((n_dev * L, T), bool, fill=False,
                                 owner=owned)
            # far rows: to-neighbor at slot j is the level-0 cell at -o
            for j, o in enumerate(offs):
                ng, valid = maps.shift((-int(o[0]), -int(o[1]), -int(o[2])))
                vf = valid[far_slots]
                vv = np.nonzero(vf)[0]
                if len(vv):
                    rw = resolve_rows(pos0[ng[far_slots][vv]], far_dev[vv])
                    to_rows[far_rowidx[vv], j] = rw
                    to_mask[far_rowidx[vv], j] = True
                    to_offs[far_rowidx[vv], j] = (-o * size0).astype(np.int32)
            # easy rows: to-neighbor at slot j is the level-l cell at -o
            for blk, easy in blocks:
                ei, ridx = easy_rowidx[blk.level]
                edev = owner[blk.a + ei].astype(np.int64)
                for j, o in enumerate(offs):
                    pos_n, valid, exist = blk.lookup((-int(o[0]), -int(o[1]), -int(o[2])))
                    vv = np.nonzero(valid[ei])[0]
                    if len(vv):
                        rw = resolve_rows(pos_n[ei[vv]], edev[vv])
                        to_rows[ridx[vv], j] = rw
                        to_mask[ridx[vv], j] = True
                        to_offs[ridx[vv], j] = (-o * blk.size).astype(np.int32)
            if nT:
                vdev = owner[tv].astype(np.int64)
                vrow = vdev * L + row_of_pos[tv]
                to_rows[vrow, tslot] = resolve_rows(tc, owner[tv])
                to_mask[vrow, tslot] = True
                to_offs[vrow, tslot] = toff.astype(np.int32)
            return (
                to_rows.reshape(n_dev, L, T),
                to_offs.reshape(n_dev, L, T, 3),
                to_mask.reshape(n_dev, L, T),
            )

        return thunk

    for hid, offs_in in neighborhoods.items():
        hood_data[hid]["to_thunk"] = make_to_thunk(hid, offs_in)

    layout = dict(
        local_ids=local_ids, ghost_ids=ghost_ids, n_local=n_local,
        n_inner=n_inner, L=L, R=R, row_of_pos=row_of_pos,
        scale_rows=scale_rows.reshape(n_dev, L),
    )
    return layout, hood_data
