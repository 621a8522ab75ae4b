"""Closed-form structure plan for all-level-0 single-device grids.

When every cell sits at refinement level 0 (fresh init), neighbor
resolution is closed-form index arithmetic. On one device the plan is
fully CLOSED-FORM: rows are grid order (``flat = x + nx*(y + ny*z)``),
neighbor gathers are rolls whose shifts and periodic-wrap fixup sets
come from index arithmetic, and the validity mask is synthesized on the
device from the row index. Dense gather tables exist only as lazy
thunks for host introspection.

Semantics match the reference's find_neighbors_of (dccrg.hpp:4375-4716,
restricted to the level-0 case): each neighborhood item resolves to the
same-level cell at ``ijk + offset`` with periodic wrap, and offsets are
recorded in smallest-cell index units (``offset * 2^max_refinement_level``).
Item ``j`` lives in slot ``j``; kernels are mask-driven.

``DCCRG_FORCE_TABLES=1`` builds the dense ``[1, L, k]`` gather tables
instead (the reference's cross-check path, dccrg_tpu/uniform.py:343):
same rows, a table gather in place of the rolls; the native engine
writes them in one pass when it is on. The neighbors_to
tables are a lazy thunk on both. ``build_pair_tables`` and
``dense_pair_tables`` are the halo send/receive lists' construction,
shared with the hybrid plan; on one device they are empty.

Multi-device partitions and ghost rows are not part of this
single-device slice.
"""

from __future__ import annotations

import os

import numpy as np


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


def build_uniform_plan(mapping, topology, neighborhoods, cells, owner, n_dev,
                       cap=None):
    """All plan pieces for a level-0-only single-device grid.

    Returns ``(layout, hood_data)`` where layout is a dict with
    local_ids / ghost_ids / n_local / n_inner / L / R / row_of_pos, and
    hood_data maps hood id -> dict with the closed-form metadata, the
    roll plan and the lazy dense-table thunks.
    """
    dims = tuple(int(v) for v in mapping.length.get())
    n0 = dims[0] * dims[1] * dims[2]
    if n0 >= 2**31 - 2:
        # int32 grid indices throughout
        raise ValueError(f"uniform fast path limited to < 2^31 cells, got {n0}")
    if n_dev != 1:
        raise NotImplementedError(
            "multi-device uniform plans are not ported yet (single device only)")
    size = 1 << mapping.max_refinement_level  # index units per cell
    periodic = tuple(topology.is_periodic(d) for d in range(3))
    hoods = {hid: np.asarray(offs, dtype=np.int64).reshape(-1, 3)
             for hid, offs in neighborhoods.items()}
    if os.environ.get("DCCRG_FORCE_TABLES") != "1":
        return _build_single_device_plan(
            mapping, hoods, cells, dims, periodic, size, cap)
    return _build_dense_plan(hoods, cells, dims, periodic, size, cap)


def _build_dense_plan(hoods, cells, dims, periodic, size, cap):
    """The dense-table single-device plan (``DCCRG_FORCE_TABLES=1``,
    the ``n_dev == 1`` case of the reference's dense builder,
    dccrg_tpu/uniform.py:350-561): rows are grid order, every hood gets
    ``[1, L, k]`` rows and mask with item ``j`` in slot ``j`` (pad rows
    point at the zero row ``R - 1``), offsets are the per-slot
    constants, and the neighbors_to tables are a lazy thunk."""
    from . import native
    from .grid import bucket_capacity

    if cap is None:
        cap = lambda name, needed: bucket_capacity(needed)
    nx, ny, nz = dims
    n0 = nx * ny * nz
    maps = _NeighborMaps(dims, periodic)
    L = cap("L", max(1, n0))
    R = L + 1  # one device: no ghost rows, final row = zero pad
    row_of_pos = np.arange(n0, dtype=np.int32)
    owner = np.zeros(n0, dtype=np.int32)
    perm = row_of_pos.astype(np.int64)  # flat table slot of each cell

    def reader_rows(ng, valid):
        return np.where(valid, row_of_pos[ng], R - 1).astype(np.int32)

    # no ghosts: the empty record, its width from the same capacity name
    pair_compact = build_pair_tables(
        [np.empty(0, np.int64)], 1, None, None, None,
        lambda needed: cap(("M", "uniform"), needed))

    def dense_tables(offs):
        """[L, k] (rows, mask) in row order (rows ARE grid order): one
        native pass when the engine is on, per-offset lattice maps
        otherwise."""
        k = len(offs)
        rows_t = np.full((L, k), R - 1, dtype=np.int32)
        mask_t = np.zeros((L, k), dtype=bool)
        nat = (native.uniform_tables(dims, periodic, offs, row_of_pos, None,
                                     R - 1)
               if n0 < 2**31 - 2 else None)
        if nat is not None:
            # one device emits no cross-device sentinels; L may exceed
            # n0 (bucketed capacity), the tail keeps the pad
            rows_t[:n0], mask_t[:n0] = nat
            return rows_t, mask_t
        for j, o in enumerate(offs):
            ng, valid = maps.shift(o)
            rows_t[:n0, j] = reader_rows(ng, valid)
            mask_t[:n0, j] = valid
        return rows_t, mask_t

    hood_data = {}
    for hid, offs in hoods.items():
        k = len(offs)
        rows_t, mask_t = dense_tables(offs)
        offs_const = (offs * size).astype(np.int32)  # [k, 3]

        def offs_thunk(mask_t=mask_t, offs_const=offs_const, k=k):
            out = np.empty((L, k, 3), dtype=np.int32)
            for j in range(k):
                np.multiply(
                    mask_t[:, j, None], offs_const[j][None, :], out=out[:, j, :]
                )
            return out.reshape(1, L, k, 3)

        def to_thunk(offs=offs):
            return _build_to_tables(
                maps, offs, size, owner, reader_rows, perm, 1, L, R)

        hood_data[hid] = {
            "nbr_rows": rows_t.reshape(1, L, k),
            "nbr_offs": offs_thunk,
            "offs_const": offs_const,
            "nbr_mask": mask_t.reshape(1, L, k),
            "pair_compact": pair_compact,
            "to_thunk": to_thunk,
        }

    layout = dict(
        local_ids=[cells], ghost_ids=[np.empty(0, np.uint64)],
        n_local=np.array([n0], dtype=np.int64),
        n_inner=np.array([n0], dtype=np.int64),
        L=L, R=R, row_of_pos=row_of_pos,
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
