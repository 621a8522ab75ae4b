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

Multi-device partitions, ghost rows and the neighbors_to tables are
not part of this single-device slice.
"""

from __future__ import annotations

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


def empty_pair_compact(n_dev, M):
    """A compact pair record with no entries (single-device plans)."""
    e = np.empty(0, np.int64)
    return {"n_dev": n_dev, "M": M, "p": e, "q": e, "pos": e,
            "srow": np.empty(0, np.int32), "rrow": np.empty(0, np.int32)}


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
    return _build_single_device_plan(
        mapping, hoods, cells, dims, periodic, size, cap)


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

        hood_data[hid] = {
            "closed_form": {"dims": dims, "periodic": periodic, "n0": n0,
                            "offsets": offs.copy()},
            "roll_plan": (shifts, wrong_rows, wrong_src),
            "tables_thunk": tables_thunk,
            "nbr_offs": offs_thunk,
            "offs_const": offs_const,
            "pair_compact": empty_pair_compact(1, 16),
        }

    layout = dict(
        local_ids=[cells], ghost_ids=[np.empty(0, np.uint64)],
        n_local=np.array([n0], dtype=np.int64),
        n_inner=np.array([n0], dtype=np.int64),
        L=L, R=R, row_of_pos=row_of_pos,
    )
    return layout, hood_data
