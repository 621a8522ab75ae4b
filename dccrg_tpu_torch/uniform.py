"""Closed-form structure plan for all-level-0 grids.

When every cell sits at refinement level 0 (fresh init), neighbor
resolution is closed-form index arithmetic. On one device the plan is
fully CLOSED-FORM: rows are grid order (``flat = x + nx*(y + ny*z)``),
neighbor gathers are rolls whose shifts and periodic-wrap fixup sets
come from index arithmetic, and the validity mask is synthesized on the
device from the row index. Dense gather tables exist only as lazy
thunks for host introspection.

On several partitions (the reference's multi-device branch,
dccrg_tpu/uniform.py:350-583) each partition's rows are ``[inner |
outer | pad | ghost | zero row]``: the boundary classification sorts
the owned cells into inner (no neighbor on another partition) and
outer, the ghost sets list the remote cells each partition reads, and
the send/receive pair record says which rows move in a halo exchange.
A partition contiguous in cell-id order (``block``) keeps a closed
form: a flat roll per slot plus exact fixup bands
(:func:`_closed_form_hoods`), never the ``[n_dev, L, S]`` tables; any
other partition gets the dense tables.

Semantics match the reference's find_neighbors_of (dccrg.hpp:4375-4716,
restricted to the level-0 case): each neighborhood item resolves to the
same-level cell at ``ijk + offset`` with periodic wrap, and offsets are
recorded in smallest-cell index units (``offset * 2^max_refinement_level``).
Item ``j`` lives in slot ``j``; kernels are mask-driven.

``DCCRG_FORCE_TABLES=1`` builds the dense tables on every partition
count (the reference's cross-check path); the native engine writes them
in one pass when it is on, with cross-partition sentinels fixed up to
ghost rows. The neighbors_to tables are a lazy thunk throughout.
``build_pair_tables`` and ``dense_pair_tables`` are the halo
send/receive lists' construction, shared with the hybrid plan.

``_PHASE_SINK`` (a list, when set) collects ``(phase, seconds)`` of each
partitioned build; ``DCCRG_TIMING=1`` prints them.
"""

from __future__ import annotations

import os
import time

import numpy as np

#: ``(phase, seconds)`` of each partitioned plan build, when a list.
_PHASE_SINK = None


def _phase_timer():
    """Phase-boundary logger of a partitioned build: records into
    :data:`_PHASE_SINK` when one is installed and prints with
    ``DCCRG_TIMING=1``."""
    sink = _PHASE_SINK
    echo = os.environ.get("DCCRG_TIMING") == "1"
    if sink is None and not echo:
        return lambda label: None
    state = {"t": time.perf_counter()}

    def mark(label):
        now = time.perf_counter()
        if echo:
            print(f"[uniform] {label}: {now - state['t']:.3f}s", flush=True)
        if sink is not None:
            sink.append((label, now - state["t"]))
        state["t"] = now

    return mark


def is_uniform(cells: np.ndarray, n0: int) -> bool:
    """True when ``cells`` is exactly the full level-0 cell set 1..n0."""
    return len(cells) == n0 and int(cells[-1]) == n0


class _NeighborMaps:
    """Per-offset neighbor maps over the full level-0 grid.

    ``shift(off)`` returns ``(ngidx, valid)`` flat views: the grid
    index of each cell's neighbor at cell-unit offset ``off`` (periodic
    wrap applied) and whether that neighbor exists. The map is a
    ``np.roll`` of the identity-index array — a plain strided copy.
    """

    def __init__(self, dims, periodic):
        self.dims = dims
        self.periodic = periodic
        nx, ny, nz = dims
        self.n0 = nx * ny * nz
        self._g3 = np.arange(self.n0, dtype=np.int32).reshape(nz, ny, nx)

    def shift(self, off):
        nx, ny, nz = self.dims
        ox, oy, oz = int(off[0]), int(off[1]), int(off[2])
        ng = np.roll(self._g3, shift=(-oz, -oy, -ox), axis=(0, 1, 2))
        valid = np.ones((nz, ny, nx), dtype=bool)
        for axis, (o, n, per) in enumerate(
            ((oz, nz, self.periodic[2]), (oy, ny, self.periodic[1]),
             (ox, nx, self.periodic[0]))
        ):
            if per or o == 0:
                continue
            sl = [slice(None)] * 3
            if abs(o) >= n:
                valid[:] = False
                continue
            sl[axis] = slice(n - o, None) if o > 0 else slice(None, -o)
            valid[tuple(sl)] = False
        return ng.reshape(-1), valid.reshape(-1)


def build_pair_tables(ghost_lists, n_dev, owner_of_key, send_row_of,
                      recv_row_of, cap):
    """COMPACT halo send/receive lists from per-receiver ghost lists —
    the shared lexsort-grouping construction (no n_dev^2 Python loop;
    the reference builds the equivalent per-peer lists at
    dccrg.hpp:8729-8891).

    ``ghost_lists[q]`` is the SORTED array of ghost keys device q
    reads (cell ids, lattice indices or positions — whatever the
    caller's row resolvers understand). ``owner_of_key(keys)`` maps
    keys to their owning (sending) device; ``send_row_of(p_s, keys)``
    and ``recv_row_of(q_s, keys, gpos)`` resolve sender rows and
    receiver ghost rows, where ``gpos`` is each key's position within
    its receiver's sorted list. Entries within one (sender, receiver)
    pair are ordered by key (the reference sorts by id for tag
    assignment).

    Returns a compact dict — O(total ghosts) memory, NOT the dense
    ``[n_dev, n_dev, M]`` arrays (those are quadratic in devices and
    only materialized lazily for the all_to_all fallback and host
    introspection; see grid._HoodPlan.send_rows):
      ``n_dev, M`` — device count and the capped max pair width;
      ``p, q, pos, srow, rrow`` — per-entry sender, receiver, slot
      within the pair, sender row, receiver ghost row, sorted by
      (sender, receiver, key)."""
    g_all = (np.concatenate(ghost_lists) if n_dev
             else np.empty(0, np.int64))
    q_all = np.repeat(np.arange(n_dev), [len(g) for g in ghost_lists])
    total = len(g_all)
    if total == 0:
        return empty_pair_compact(n_dev, cap(1))
    p_all = np.asarray(owner_of_key(g_all))
    order = np.lexsort((g_all, q_all, p_all))
    p_s, q_s, g_s = p_all[order], q_all[order], g_all[order]
    # position of each ghost within its (sender, receiver) group
    pq = p_s.astype(np.int64) * n_dev + q_s
    starts = np.r_[0, np.flatnonzero(np.diff(pq)) + 1]
    lens = np.diff(np.r_[starts, total])
    pos = np.arange(total, dtype=np.int64) - np.repeat(starts, lens)
    M = cap(max(1, int(lens.max())))
    # g_all concatenates the receivers' sorted lists, so each key's
    # in-list position is its index minus its list's start
    lens_q = np.array([len(g) for g in ghost_lists], dtype=np.int64)
    q_starts = np.cumsum(lens_q) - lens_q
    gpos = (np.arange(total, dtype=np.int64) - q_starts[q_all])[order]
    return {
        "n_dev": n_dev, "M": M,
        "p": p_s.astype(np.int64), "q": q_s.astype(np.int64), "pos": pos,
        "srow": np.asarray(send_row_of(p_s, g_s), dtype=np.int32),
        "rrow": np.asarray(recv_row_of(q_s, g_s, gpos), dtype=np.int32),
    }


def empty_pair_compact(n_dev, M):
    """A compact pair record with no entries (single-device plans)."""
    e = np.empty(0, np.int64)
    return {"n_dev": n_dev, "M": M, "p": e, "q": e, "pos": e,
            "srow": np.empty(0, np.int32), "rrow": np.empty(0, np.int32)}


def dense_pair_tables(compact):
    """Materialize the dense ``[n_dev, n_dev, M]`` send/recv arrays
    from a compact pair record (all_to_all fallback + introspection;
    O(n_dev^2 M) memory — never built on the per-delta ppermute
    path)."""
    n_dev, M = compact["n_dev"], compact["M"]
    send_rows = np.full((n_dev, n_dev, M), -1, dtype=np.int32)
    recv_rows = np.full((n_dev, n_dev, M), -1, dtype=np.int32)
    p, q, pos = compact["p"], compact["q"], compact["pos"]
    send_rows[p, q, pos] = compact["srow"]
    recv_rows[q, p, pos] = compact["rrow"]
    return send_rows, recv_rows


def _wrap_band(dims, o):
    """Sorted grid indices of cells whose neighbor at cell offset ``o``
    crosses a grid boundary in some dimension — the only cells besides
    partition-boundary bands whose flat neighbor index differs from
    ``gidx + flat_delta``. Periodicity doesn't matter here: a periodic
    wrap changes the flat index and a non-periodic crossing must be
    masked, so both land in the band. ~O(surface) cells."""
    nx, ny, nz = dims
    bands = []
    for d, (ov, nd) in enumerate(((int(o[0]), nx), (int(o[1]), ny),
                                  (int(o[2]), nz))):
        if ov == 0:
            continue
        if ov > 0:
            lo, hi = max(nd - ov, 0), nd
        else:
            lo, hi = 0, min(-ov, nd)
        coord = np.arange(lo, hi, dtype=np.int64)
        other = [np.arange(dims[e], dtype=np.int64) for e in range(3)]
        other[d] = coord
        gx, gy, gz = np.meshgrid(other[0], other[1], other[2], indexing="ij")
        bands.append((gx + nx * (gy + ny * gz)).reshape(-1))
    if not bands:
        return np.empty(0, np.int64)
    return np.unique(np.concatenate(bands))


def _closed_form_hoods(hoods, dims, periodic, size, n_dev, owner,
                       local_ids, ghost_gidx, n_inner, L, R,
                       row_of_pos, pair_compact, cap, dense_tables,
                       maps, reader_rows, perm):
    """Closed-form hood data for a multi-device partition contiguous in
    cell-id order (block slabs, incl. weighted cuts).

    Rows are [inner|outer] per device, but for a contiguous partition
    the outer cells cluster in bands at the slab ends (plus wrap
    bands), so every cell OUTSIDE the candidate bands has an affine
    row: row(c) = c - slab_start - n_head_outer, and its same-slab
    unwrapped neighbor satisfies row(n) = row(c) + flat_delta. The
    roll decomposition (grid._make_nbr_gather) therefore only needs
    exact fixups for the candidate bands — computed here in
    O(bands * k), never materializing the [n_dev, L, S] tables the
    dense path builds (the validity mask is synthesized ON DEVICE from
    the row-id array, grid._synth_mask). Dense tables remain available
    as memoized thunks for host query paths."""
    nx, ny, nz = dims
    n0 = nx * ny * nz
    nxy = nx * ny
    a = np.searchsorted(owner, np.arange(n_dev)).astype(np.int64)
    b = np.append(a[1:], n0).astype(np.int64)
    # mid-region bounds from the ACTUAL outer sets: everything outside
    # [head_end, tail_start) is re-checked exactly, so a pathological
    # outer cell in the middle just widens the candidate set
    head_end, tail_start = a.copy(), b.copy()
    for d in range(n_dev):
        og = local_ids[d][n_inner[d]:].astype(np.int64) - 1
        if len(og):
            mid = (a[d] + b[d]) // 2
            h, t = og[og < mid], og[og >= mid]
            head_end[d] = (h.max() + 1) if len(h) else a[d]
            tail_start[d] = t.min() if len(t) else b[d]

    _memo = {}

    def dense_memo(hid, offs):
        if hid not in _memo:
            _memo[hid] = dense_tables(offs)
        return _memo[hid]

    hood_data = {}
    for hid, offs in hoods.items():
        k = len(offs)
        shifts = (offs[:, 0] + nx * (offs[:, 1] + ny * offs[:, 2])
                  ).astype(np.int64)
        maxD = int(np.abs(shifts).max()) if k else 0
        bands = [_wrap_band(dims, o) for o in offs]
        wrong_per = [[None] * k for _ in range(n_dev)]
        W = 1
        for d in range(n_dev):
            lo, hi = int(a[d]), int(b[d])
            he = min(int(head_end[d]) + maxD, hi)
            ts = max(int(tail_start[d]) - maxD, lo)
            endcands = np.concatenate([
                np.arange(lo, he, dtype=np.int64),
                np.arange(max(ts, he), hi, dtype=np.int64),
            ])
            for j, o in enumerate(offs):
                bj = bands[j]
                cand = np.unique(np.concatenate(
                    [endcands, bj[(bj >= lo) & (bj < hi)]]
                ))
                if len(cand) == 0:
                    wrong_per[d][j] = (np.empty(0, np.int32),
                                       np.empty(0, np.int32))
                    continue
                x = cand % nx
                y = (cand // nx) % ny
                z = cand // nxy
                tx, ty, tz = x + int(o[0]), y + int(o[1]), z + int(o[2])
                valid = np.ones(len(cand), dtype=bool)
                for coord, ndim, per in ((tx, nx, periodic[0]),
                                         (ty, ny, periodic[1]),
                                         (tz, nz, periodic[2])):
                    if per:
                        coord %= ndim
                    else:
                        valid &= (coord >= 0) & (coord < ndim)
                cv = cand[valid]
                ngi = (tx + nx * (ty + ny * tz))[valid]
                row_c = row_of_pos[cv].astype(np.int64)
                row_n = np.empty(len(ngi), dtype=np.int64)
                loc = owner[ngi] == d
                row_n[loc] = row_of_pos[ngi[loc]]
                if (~loc).any():
                    row_n[~loc] = L + np.searchsorted(
                        ghost_gidx[d], ngi[~loc]
                    )
                # ghost reads must always go through the fixup even if
                # the shift coincidentally matches (the roll never
                # reaches rows >= L)
                wrong = (row_n != row_c + shifts[j]) | (row_n >= L)
                wrong_per[d][j] = (row_c[wrong].astype(np.int32),
                                   row_n[wrong].astype(np.int32))
                W = max(W, int(wrong.sum()))
        Wc = cap(("rollW", hid), W)
        wrong_rows = np.full((n_dev, k, Wc), L, dtype=np.int32)
        wrong_src = np.zeros((n_dev, k, Wc), dtype=np.int32)
        for d in range(n_dev):
            for j in range(k):
                wr, ws = wrong_per[d][j]
                wrong_rows[d, j, : len(wr)] = wr
                wrong_src[d, j, : len(ws)] = ws
        offs_const = (offs * size).astype(np.int32)

        def tables_thunk(hid=hid, offs=offs, k=k):
            rows_t, mask_t = dense_memo(hid, offs)
            return rows_t.reshape(n_dev, L, k), mask_t.reshape(n_dev, L, k)

        def offs_thunk(hid=hid, offs=offs, k=k, offs_const=offs_const):
            _rows, mask_t = dense_memo(hid, offs)
            out = (mask_t.reshape(n_dev * L, k)[:, :, None]
                   * offs_const[None, :, :]).astype(np.int32)
            return out.reshape(n_dev, L, k, 3)

        def make_to_thunk(offs=offs):
            def thunk():
                return _build_to_tables(
                    maps, offs, size, owner, reader_rows, perm, n_dev, L, R
                )

            return thunk

        hood_data[hid] = {
            "closed_form": {"dims": dims, "periodic": periodic, "n0": n0,
                            "offsets": offs.copy(), "multi": True},
            "roll_plan": (shifts, wrong_rows, wrong_src),
            "tables_thunk": tables_thunk,
            "nbr_offs": offs_thunk,
            "offs_const": offs_const,
            "pair_compact": pair_compact,
            "to_thunk": make_to_thunk(),
        }
    return hood_data


def build_uniform_plan(mapping, topology, neighborhoods, cells, owner, n_dev,
                       cap=None):
    """All plan pieces for a level-0-only grid on ``n_dev``
    partitions (``owner`` per cell).

    Returns ``(layout, hood_data)`` where layout is a dict with
    local_ids / ghost_ids / n_local / n_inner / L / R / row_of_pos, and
    hood_data maps hood id -> dict with the closed-form roll plan or the
    dense gather tables, a lazy neighbors_to thunk, and the halo
    send/receive pair record.
    """
    from .grid import DEFAULT_NEIGHBORHOOD_ID

    dims = tuple(int(v) for v in mapping.length.get())
    n0 = dims[0] * dims[1] * dims[2]
    if n0 >= 2**31 - 2:
        # int32 grid indices throughout (native AND numpy builders):
        # callers must use the generic builder beyond 2^31 cells
        raise ValueError(f"uniform fast path limited to < 2^31 cells, got {n0}")
    size = 1 << mapping.max_refinement_level  # index units per cell
    periodic = tuple(topology.is_periodic(d) for d in range(3))
    owner = np.asarray(owner, dtype=np.int32)

    hoods = {hid: np.asarray(offs, dtype=np.int64).reshape(-1, 3)
             for hid, offs in neighborhoods.items()}

    if n_dev == 1 and os.environ.get("DCCRG_FORCE_TABLES") != "1":
        # closed-form: no lattice map, no tables (DCCRG_FORCE_TABLES=1
        # falls through to the dense builder — the bench's roll-vs-
        # table A/B leg and the cross-check path)
        return _build_single_device_plan(
            mapping, hoods, cells, dims, periodic, size, cap)

    mark = _phase_timer()
    maps = _NeighborMaps(dims, periodic)

    # -- phase 1: boundary classification + ghost edges -------------
    outer_flag = np.zeros(n0, dtype=bool)
    ghost_src_dev = []  # device that reads
    ghost_nbr = []  # gidx read remotely
    for hid, offs in hoods.items():
        seen = set()
        for o in offs:
            for sign in (1, -1):  # of-reads and to-reads (inverse offsets)
                key = (sign * int(o[0]), sign * int(o[1]), sign * int(o[2]))
                if key in seen:
                    continue
                seen.add(key)
                if n_dev == 1:
                    continue
                ng, valid = maps.shift(key)
                cross = valid & (owner[ng] != owner)
                if hid == DEFAULT_NEIGHBORHOOD_ID:
                    outer_flag |= cross
                if cross.any():
                    ghost_src_dev.append(owner[cross])
                    ghost_nbr.append(ng[cross])

    if ghost_nbr:
        gdev = np.concatenate(ghost_src_dev)
        gnbr = np.concatenate(ghost_nbr)
    else:
        gdev = np.empty(0, np.int32)
        gnbr = np.empty(0, np.int32)

    local_ids, ghost_ids, ghost_gidx = [], [], []
    n_inner = np.zeros(n_dev, np.int64)
    for d in range(n_dev):
        mine = owner == d
        inner = cells[mine & ~outer_flag]
        outer = cells[mine & outer_flag]
        local_ids.append(np.concatenate([inner, outer]))
        n_inner[d] = len(inner)
        gg = np.unique(gnbr[gdev == d]) if n_dev > 1 else np.empty(0, np.int32)
        ghost_gidx.append(gg.astype(np.int64))
        ghost_ids.append((gg.astype(np.uint64) + 1))
    mark("classify")

    from .grid import bucket_capacity

    if cap is None:
        cap = lambda name, needed: bucket_capacity(needed)
    n_local = np.array([len(x) for x in local_ids], dtype=np.int64)
    n_ghost = np.array([len(x) for x in ghost_ids], dtype=np.int64)
    L = cap("L", max(1, int(n_local.max())))
    G = int(n_ghost.max()) if n_dev > 1 else 0
    G = cap("G", G) if G else 0
    R = L + G + 1  # final row = permanent zero pad

    row_of_pos = np.full(n0, -1, dtype=np.int32)
    local_gidx = []
    for d in range(n_dev):
        lg = local_ids[d].astype(np.int64) - 1
        local_gidx.append(lg)
        row_of_pos[lg] = np.arange(len(lg), dtype=np.int32)
    mark("layout")

    # row of each cell's neighbor ON THE READER'S device: start from the
    # owner-device row (valid when reader == owner) and fix up the
    # cross-device entries with ghost rows, per reading device
    def reader_rows(ng, valid):
        rows = np.where(valid, row_of_pos[ng], R - 1).astype(np.int32)
        cross = valid & (owner[ng] != owner)
        ci = np.nonzero(cross)[0]
        if len(ci):
            cd = owner[ci]
            cn = ng[ci].astype(np.int64)
            for d in np.unique(cd):
                m = cd == d
                gpos = np.searchsorted(ghost_gidx[d], cn[m])
                rows[ci[m]] = (L + gpos).astype(np.int32)
        return rows

    # scatter permutation: flat table slot of cell c = owner*L + row
    perm = owner.astype(np.int64) * L + row_of_pos

    # pair lists for halo exchange (same construction as the generic
    # path: receive every ghost, sender = owner, sorted by id) — one
    # lexsort-grouping over the concatenated ghosts, no n_dev^2 loop
    pair_compact = build_pair_tables(
        ghost_gidx, n_dev,
        lambda keys: owner[keys],
        lambda p_s, keys: row_of_pos[keys],
        lambda q_s, keys, gpos: (L + gpos).astype(np.int32),
        lambda needed: cap(("M", "uniform"), needed),
    )
    mark("pairs")

    # pad rows (beyond each device's local count) need explicit init
    # since the permutation pass only covers real cells
    pad_rows = np.concatenate([
        d * L + np.arange(n_local[d], L, dtype=np.int64) for d in range(n_dev)
    ]) if n_dev * L > n0 else np.empty(0, np.int64)
    identity_perm = n_dev == 1  # single device: rows are gidx order

    def to_row_order(glob):
        """[k, n0] (contiguous per offset) -> [n_dev*L, k] row order.
        Cache-blocked transpose; the permutation pass is skipped when
        rows are already in grid order."""
        k = glob.shape[0]
        out = np.empty((n_dev * L, k), dtype=glob.dtype)
        tgt = out if identity_perm else np.empty((n0, k), dtype=glob.dtype)
        B = 1 << 20
        for i in range(0, n0, B):
            end = min(i + B, n0)  # L may exceed n0 (bucketed capacity)
            tgt[i:end] = glob[:, i:end].T
        if not identity_perm:
            out[perm] = tgt
        return out

    def fixup_sentinels(rows):
        """Replace the native path's cross-device sentinels
        (-2 - neighbor_gidx) with ghost rows on the reader device.
        ``rows`` is in grid-index order, so the reader of entry
        (i, j) is owner[i]."""
        ci, cj = np.nonzero(rows < -1)
        if len(ci) == 0:
            return rows
        cn = (-2 - rows[ci, cj]).astype(np.int64)
        cd = owner[ci]
        for d in np.unique(cd):
            m = cd == d
            rows[ci[m], cj[m]] = (
                L + np.searchsorted(ghost_gidx[d], cn[m])
            ).astype(np.int32)
        return rows

    # -- phase 2: gather tables ------------------------------------
    from . import native

    def dense_tables(offs):
        """[n_dev*L, k] (rows, mask) in row order — the dense build."""
        k = len(offs)
        nat = (native.uniform_tables(
            dims, periodic, offs, row_of_pos,
            owner if n_dev > 1 else None, R - 1,
        ) if n0 < 2**31 - 2 else None)
        if nat is not None:
            grows, gmask = nat  # [n0, k] grid-index order
            if n_dev > 1:  # single device emits no cross sentinels
                grows = fixup_sentinels(grows)
            if identity_perm:
                # rows are gidx order, but L may exceed n0 (bucketed
                # capacity): place the lattice block, pad the rest
                rows_t = np.full((n_dev * L, k), R - 1, dtype=np.int32)
                mask_t = np.zeros((n_dev * L, k), dtype=bool)
                rows_t[:n0] = grows
                mask_t[:n0] = gmask
                del grows, gmask
            else:
                rows_t = np.empty((n_dev * L, k), dtype=np.int32)
                mask_t = np.empty((n_dev * L, k), dtype=bool)
                rows_t[perm] = grows
                mask_t[perm] = gmask
                del grows, gmask
        else:
            glob_rows = np.empty((k, n0), dtype=np.int32)
            glob_mask = np.empty((k, n0), dtype=bool)
            for j, o in enumerate(offs):
                ng, valid = maps.shift(o)
                glob_rows[j] = reader_rows(ng, valid)
                glob_mask[j] = valid
            rows_t = to_row_order(glob_rows)
            mask_t = to_row_order(glob_mask)
            del glob_rows, glob_mask
        if len(pad_rows):
            rows_t[pad_rows] = R - 1
            mask_t[pad_rows] = False
        return rows_t, mask_t

    # a partition contiguous in cell-id order (block, incl. weighted)
    # takes the closed-form path: rows are piecewise-affine in the grid
    # index, so roll shifts + fixup sets come from candidate bands and
    # NO [n_dev, L, S] table is materialized
    contiguous = bool(np.all(owner[1:] >= owner[:-1])) if len(owner) else True
    if contiguous and os.environ.get("DCCRG_FORCE_TABLES") != "1":
        hood_data = _closed_form_hoods(
            hoods, dims, periodic, size, n_dev, owner,
            local_ids, ghost_gidx, n_inner, L, R,
            row_of_pos, pair_compact, cap, dense_tables,
            maps, reader_rows, perm,
        )
        mark("hoods")
        layout = dict(
            local_ids=local_ids, ghost_ids=ghost_ids, n_local=n_local,
            n_inner=n_inner, L=L, R=R, row_of_pos=row_of_pos,
        )
        return layout, hood_data

    hood_data = {}
    for hid, offs in hoods.items():
        k = len(offs)
        rows_t, mask_t = dense_tables(offs)
        # offsets are per-slot constants (offset * cell size in index
        # units): stencils synthesize them on device from the mask, so
        # no [n_dev, L, k, 3] array is built here (offs_thunk serves
        # host-side queries/tests)
        offs_const = (offs * size).astype(np.int32)  # [k, 3]

        def offs_thunk(mask_t=mask_t, offs_const=offs_const, k=k):
            out = np.empty((n_dev * L, k, 3), dtype=np.int32)
            for j in range(k):
                np.multiply(
                    mask_t[:, j, None], offs_const[j][None, :], out=out[:, j, :]
                )
            return out.reshape(n_dev, L, k, 3)

        hood_data[hid] = {
            "nbr_rows": rows_t.reshape(n_dev, L, k),
            "nbr_offs": offs_thunk,
            "offs_const": offs_const,
            "nbr_mask": mask_t.reshape(n_dev, L, k),
            "pair_compact": pair_compact,
        }

    def make_to_thunk(offs):
        def thunk():
            return _build_to_tables(
                maps, offs, size, owner, reader_rows, perm, n_dev, L, R
            )

        return thunk

    for hid, offs in hoods.items():
        hood_data[hid]["to_thunk"] = make_to_thunk(offs)
    mark("tables")

    layout = dict(
        local_ids=local_ids, ghost_ids=ghost_ids, n_local=n_local,
        n_inner=n_inner, L=L, R=R, row_of_pos=row_of_pos,
    )
    return layout, hood_data


def _build_to_tables(maps, offs, size, owner, reader_rows, perm, n_dev, L, R):
    """neighbors_to gather tables: cell v is a to-neighbor of c when
    c = v + offset, i.e. the inverse relation at offset -o with the
    offset recorded negated (build_neighbor_lists, neighbors.py). Slot
    order within a row is (neighbor gidx, item) — any mask-consistent
    padding is equivalent for kernels."""
    k = len(offs)
    n0 = maps.n0
    ng_all = np.empty((n0, k), dtype=np.int32)
    valid_all = np.empty((n0, k), dtype=bool)
    for j, o in enumerate(offs):
        ng, valid = maps.shift((-int(o[0]), -int(o[1]), -int(o[2])))
        ng_all[:, j] = ng
        valid_all[:, j] = valid
    # order slots by (neighbor gidx, item), invalid entries last —
    # matches the generic stream's (source-sorted, stable) layout
    key = np.where(valid_all, ng_all.astype(np.int64) * k,
                   np.iinfo(np.int64).max - k)
    key = key + np.arange(k, dtype=np.int64)[None, :]
    order = np.argsort(key, axis=1, kind="stable")
    ng_s = np.take_along_axis(ng_all, order, axis=1)
    valid_s = np.take_along_axis(valid_all, order, axis=1)
    to_rows = np.full((n_dev * L, k), R - 1, dtype=np.int32)
    to_mask = np.zeros((n_dev * L, k), dtype=bool)
    for j in range(k):
        to_rows[perm, j] = reader_rows(ng_s[:, j], valid_s[:, j])
        to_mask[perm, j] = valid_s[:, j]
    o_arr = (-np.asarray(offs, dtype=np.int64) * size).astype(np.int32)  # [k,3]
    offs_s = o_arr[order]  # [n0, k, 3]
    to_offs = np.zeros((n_dev * L, k, 3), dtype=np.int32)
    to_offs[perm] = np.where(valid_s[..., None], offs_s, 0)
    return (
        to_rows.reshape(n_dev, L, k),
        to_offs.reshape(n_dev, L, k, 3),
        to_mask.reshape(n_dev, L, k),
    )


def _build_single_device_plan(mapping, hoods, cells, dims, periodic, size, cap):
    """Closed-form plan for a single-device uniform grid: NO gather
    tables are materialized. Rows are grid order; neighbor gathers
    lower to rolls whose shifts and wrap-fixup sets are computed
    arithmetically (read through _HoodPlan.roll_plan), and the validity
    mask is synthesized on device from the row index (closed_form
    metadata). The full tables exist as a lazy thunk for host query /
    introspection paths."""
    from .grid import bucket_capacity

    if cap is None:
        cap = lambda name, needed: bucket_capacity(needed)
    nx, ny, nz = dims
    n0 = nx * ny * nz
    L = cap("L", n0)
    R = L + 1
    row_of_pos = np.arange(n0, dtype=np.int32)
    _lazy = {}

    def get_maps():
        # the n0-sized lattice map exists only if an introspection
        # thunk actually fires
        if "maps" not in _lazy:
            _lazy["maps"] = _NeighborMaps(dims, periodic)
        return _lazy["maps"]

    def band_rows(o):
        """(wrong rows, true src rows) for one offset: the rows whose
        flat roll crosses a periodic wrap (non-periodic edges are
        masked invalid instead)."""
        ox, oy, oz = int(o[0]), int(o[1]), int(o[2])
        bands = []
        for d, (ov, nd) in enumerate(((ox, nx), (oy, ny), (oz, nz))):
            if ov == 0:
                continue
            # rows whose dim-d coordinate steps outside [0, nd); with
            # |offset| >= nd every row wraps (tiny periodic dims)
            if ov > 0:
                lo, hi = max(nd - ov, 0), nd
            else:
                lo, hi = 0, min(-ov, nd)
            coord = np.arange(lo, hi, dtype=np.int64)
            other = [np.arange(dims[e], dtype=np.int64) for e in range(3)]
            other[d] = coord
            gx, gy, gz = np.meshgrid(other[0], other[1], other[2],
                                     indexing="ij")
            bands.append((gx + nx * (gy + ny * gz)).reshape(-1))
        if not bands:
            return (np.empty(0, np.int64),) * 2
        rows = np.unique(np.concatenate(bands))
        # validity: non-periodic crossings are masked, not fixed up
        x = rows % nx
        y = (rows // nx) % ny
        z = rows // (nx * ny)
        tx, valid = x + ox, np.ones(len(rows), dtype=bool)
        ty, tz = y + oy, z + oz
        for coord, nd, per in ((tx, nx, periodic[0]), (ty, ny, periodic[1]),
                               (tz, nz, periodic[2])):
            if per:
                coord %= nd
            else:
                valid &= (coord >= 0) & (coord < nd)
        rows, tx, ty, tz = rows[valid], tx[valid], ty[valid], tz[valid]
        true_flat = tx + nx * (ty + ny * tz)
        # only rows where the plain roll would be wrong need fixing
        roll_val = (rows + (ox + nx * (oy + ny * oz))) % L
        wrong = roll_val != true_flat
        return rows[wrong], true_flat[wrong]

    hood_data = {}
    for hid, offs in hoods.items():
        k = len(offs)
        shifts = (offs[:, 0] + nx * (offs[:, 1] + ny * offs[:, 2])).astype(np.int64)
        wrongs = [band_rows(o) for o in offs]
        W = cap(("rollW", hid), max(1, max(len(w) for w, _ in wrongs)))
        wrong_rows = np.full((1, k, W), L, dtype=np.int32)
        wrong_src = np.zeros((1, k, W), dtype=np.int32)
        for j, (w, s) in enumerate(wrongs):
            wrong_rows[0, j, : len(w)] = w
            wrong_src[0, j, : len(w)] = s

        def tables_thunk(offs=offs, k=k, hid=hid):
            """Materialize the dense [1, L, k] tables on demand (host
            query / introspection paths only); memoized so nbr_rows,
            nbr_mask and nbr_offs consumers share one build."""
            key = ("tables", hid)
            if key in _lazy:
                return _lazy[key]
            rows_t = np.full((L, k), R - 1, dtype=np.int32)
            mask_t = np.zeros((L, k), dtype=bool)
            for j, o in enumerate(offs):
                ng, valid = get_maps().shift(o)
                rows_t[:n0, j] = np.where(valid, ng, R - 1)
                mask_t[:n0, j] = valid
            _lazy[key] = (rows_t.reshape(1, L, k), mask_t.reshape(1, L, k))
            return _lazy[key]

        offs_const = (offs * size).astype(np.int32)

        def offs_thunk(thunk=tables_thunk, offs_const=offs_const, k=k):
            _rows, mask_t = thunk()
            out = (mask_t.reshape(L, k)[:, :, None]
                   * offs_const[None, :, :]).astype(np.int32)
            return out.reshape(1, L, k, 3)

        def reader_rows(ng, valid):
            return np.where(valid, ng.astype(np.int32), R - 1).astype(np.int32)

        def to_thunk(offs=offs):
            owner = np.zeros(n0, dtype=np.int32)
            perm = row_of_pos.astype(np.int64)
            return _build_to_tables(
                get_maps(), offs, size, owner, reader_rows, perm, 1, L, R)

        hood_data[hid] = {
            "closed_form": {"dims": dims, "periodic": periodic, "n0": n0,
                            "offsets": offs.copy()},
            "roll_plan": (shifts, wrong_rows, wrong_src),
            "tables_thunk": tables_thunk,
            "nbr_offs": offs_thunk,
            "offs_const": offs_const,
            "pair_compact": empty_pair_compact(1, 16),
            "to_thunk": to_thunk,
        }

    layout = dict(
        local_ids=[cells], ghost_ids=[np.empty(0, np.uint64)],
        n_local=np.array([n0], dtype=np.int64),
        n_inner=np.array([n0], dtype=np.int64),
        L=L, R=R, row_of_pos=row_of_pos,
    )
    return layout, hood_data
