"""DEBUG-style invariant verifiers.

Port of ``dccrg_tpu/verify.py``, reading the port's own plan: its
``[n_dev, R]`` row layout (``local_ids``, ``ghost_ids``, ``row_of_pos``,
the zero row ``R - 1``), its dense send and receive rows (built from the
compact pair record) and its neighbour lists. Equivalents of the
reference's ``#ifdef DEBUG`` checkers
(dccrg.hpp:12454-13036): each function recomputes a piece of derived
grid structure from first principles and compares it with what the
``Grid`` is actually using, raising ``VerificationError`` on the first
mismatch. They are pure host-side checks — safe to call at any point
between operations:

- ``is_consistent``       — replicated structure sanity (dccrg.hpp:12454-12510)
- ``verify_neighbors``    — recompute-and-compare neighbor lists, incl.
                            the <=1 refinement-level-difference invariant
                            (dccrg.hpp:12516-12750)
- ``verify_remote_neighbor_info`` — boundary classification and halo
                            send/receive list symmetry (dccrg.hpp:12759-12978)
- ``verify_user_data``    — field storage layout (dccrg.hpp:12984-13011)
- ``pin_requests_succeeded`` — pinned cells sit on their device (dccrg.hpp:13017-13035)
- ``verify_refinement_balance`` — the 2:1 invariant recomputed over
                            FACE adjacency only, independently of the
                            stored neighbor lists
- ``verify_neighbor_symmetry`` — of/to mutual consistency recomputed
                            with two independent engines (forward
                            of-engine vs direct to-subset query)
- ``verify_partition_coverage`` — every cell owned exactly once across
                            the per-device row sets
- ``verify_all``          — everything above
- ``find_nonfinite_cells`` — locate NaN/Inf per field (the resilience
                            watchdog's diagnostic pass: the cheap
                            device-side probe in resilience.py only
                            says *that* something blew up; this names
                            the field and cells for the bundle)

Every failure raises :class:`VerificationError`, whose ``cells``
attribute names the offending cell ids when the check can identify
them (the transactional layer in txn.py propagates them into its
:class:`~dccrg_tpu_torch.txn.GridInvariantError`).

Setting ``DCCRG_DEBUG=1`` makes ``Grid`` run the verifiers after every
structure rebuild (init, AMR commit, load balance) AND ``verify_all``
at every transactional mutation boundary (txn.py) — the reference's
DEBUG builds do the same continuous self-checking.
"""

from __future__ import annotations

import numpy as np

from .neighbors import (_dedup_entries, _find_neighbors_of_numpy,
                        find_neighbors_to_subset, verify_tiling)

# parity with grid.DEFAULT_NEIGHBORHOOD_ID (import would be circular)
_DEFAULT_HOOD = -0xDCC


def format_cells(cells, limit: int = 8) -> str:
    """``" [cells a, b, ..., +n more]"`` suffix for error messages
    (shared by VerificationError, txn.MutationError, fuzz.FuzzFailure);
    empty string when no cells are named."""
    cells = tuple(cells)
    if not cells:
        return ""
    shown = ", ".join(str(c) for c in cells[:limit])
    more = "" if len(cells) <= limit else f", +{len(cells) - limit} more"
    return f" [cells {shown}{more}]"


class VerificationError(AssertionError):
    """A grid invariant does not hold. ``cells`` carries the offending
    cell ids when the failed check can name them (empty otherwise)."""

    def __init__(self, msg: str, cells=()):
        if np.size(cells):
            self.cells = tuple(
                int(c) for c in np.atleast_1d(np.asarray(cells, dtype=np.uint64))
            )
        else:
            self.cells = ()
        super().__init__(msg + format_cells(self.cells))


def _fail(msg: str, cells=()):
    raise VerificationError(msg, cells=cells)


def is_consistent(grid) -> None:
    """Replicated structure sanity: sorted unique leaf cells that tile
    the grid, owners in range, and the device row layout matching the
    replicated cell->owner map."""
    plan = grid.plan
    cells, owner = plan.cells, plan.owner
    # comparison, not np.diff: uint64 differences wrap, so a swapped
    # (decreasing) pair would yield a huge positive and slip through
    ordered = cells[1:] > cells[:-1]
    if len(cells) > 1 and not np.all(ordered):
        _fail("cell list is not strictly sorted", cells=cells[:-1][~ordered])
    verify_tiling(grid.mapping, cells)
    if len(owner) != len(cells):
        _fail("owner array length mismatch")
    if np.any((owner < 0) | (owner >= plan.n_dev)):
        _fail("cell owner out of device range",
              cells=cells[(owner < 0) | (owner >= plan.n_dev)])

    # row layout: each device's local rows hold exactly its cells
    for d in range(plan.n_dev):
        mine = np.sort(cells[owner == d])
        rows = np.sort(plan.local_ids[d])
        if not np.array_equal(mine, rows):
            _fail(f"device {d}: local row ids do not match owned cells",
                  cells=np.setxor1d(mine, rows))
        if plan.n_local[d] != len(plan.local_ids[d]):
            _fail(f"device {d}: n_local does not match row count")
        if len(plan.local_ids[d]) > plan.L:
            _fail(f"device {d}: local rows exceed capacity L")
        # ghost rows hold only existing, remote cells
        gids = plan.ghost_ids[d]
        pos = np.searchsorted(cells, gids)
        if len(gids) and (
            np.any(pos >= len(cells)) or np.any(cells[pos] != gids)
        ):
            missing = gids[(pos >= len(cells))
                           | (cells[np.minimum(pos, len(cells) - 1)] != gids)]
            _fail(f"device {d}: ghost id not an existing cell",
                  cells=missing)
        if len(gids) and np.any(owner[pos] == d):
            _fail(f"device {d}: ghost row holds a locally-owned cell",
                  cells=gids[owner[pos] == d])
        # row lookup agrees with the row arrays
        lpos = np.searchsorted(cells, plan.local_ids[d])
        if len(lpos) and not np.array_equal(
            plan.row_of_pos[lpos], np.arange(len(lpos), dtype=plan.row_of_pos.dtype)
        ):
            _fail(f"device {d}: row lookup mismatch in local rows")


def _recompute_of_streams(grid) -> dict:
    """{hood id: dedup'd (src, nbr, off, item)} recomputed from scratch
    with the NumPy reference engine — the shared input of
    verify_neighbors and verify_neighbor_symmetry (verify_all computes
    it once; standalone calls recompute)."""
    cells = grid.plan.cells
    return {
        hid: _dedup_entries(grid.mapping, cells, *_find_neighbors_of_numpy(
            grid.mapping, grid.topology, cells, cells, offsets
        ))
        for hid, offsets in grid.neighborhoods.items()
    }


def verify_neighbors(grid, of_streams: dict | None = None) -> None:
    """Recompute every neighborhood's neighbors_of/neighbors_to with the
    NumPy reference engine and compare with the lists the plan was built
    from; check the <=1 refinement-level-difference invariant."""
    plan = grid.plan
    cells = plan.cells
    if of_streams is None:
        of_streams = _recompute_of_streams(grid)
    for hid in grid.neighborhoods:
        nl = plan.hoods[hid].lists
        src, nbr, off, item = of_streams[hid]
        if not (
            np.array_equal(src, nl.of_source)
            and np.array_equal(nbr, nl.of_neighbor)
            and np.array_equal(off, nl.of_offset)
            and np.array_equal(item, nl.of_item)
        ):
            # name the sources whose entries diverge (comparable only
            # when the streams kept the same length)
            bad = np.empty(0, np.uint64)
            if len(src) == len(nl.of_source):
                m = ((src != nl.of_source) | (nbr != nl.of_neighbor)
                     | np.any(off != nl.of_offset, axis=1)
                     | (item != nl.of_item))
                bad = np.unique(cells[src[m]])
            _fail(f"neighborhood {hid}: stored neighbors_of != recomputed",
                  cells=bad)
        # inversion consistency: to-lists are exactly the inverse relation
        inv = np.lexsort((np.arange(len(src)), np.searchsorted(cells, nbr)))
        if not (
            np.array_equal(np.searchsorted(cells, nbr)[inv], nl.to_source)
            and np.array_equal(cells[src][inv], nl.to_neighbor)
            and np.array_equal(-off[inv], nl.to_offset)
        ):
            _fail(f"neighborhood {hid}: neighbors_to is not the inverse of neighbors_of")
        # refinement-level jumps (dccrg.hpp:12729-12747)
        lvl_src = grid.mapping.get_refinement_level(cells[src])
        lvl_nbr = grid.mapping.get_refinement_level(nbr)
        if np.any(np.abs(lvl_src - lvl_nbr) > 1):
            bad = np.argmax(np.abs(lvl_src - lvl_nbr) > 1)
            _fail(
                f"neighborhood {hid}: cells {cells[src[bad]]} and {nbr[bad]} "
                f"differ by more than one refinement level",
                cells=(cells[src[bad]], nbr[bad]),
            )


def verify_remote_neighbor_info(grid) -> None:
    """Boundary (inner/outer) classification and halo-exchange list
    symmetry: device p's send list to q names the same cells, in the
    same order, as q's receive list from p; ghost rows are exactly the
    cells some local cell reads remotely."""
    plan = grid.plan
    cells, owner = plan.cells, plan.owner
    nl = plan.hoods[_DEFAULT_HOOD].lists

    # recompute outer flags: a local cell is outer iff it has a remote
    # neighbor in its of- or to-lists (dccrg.hpp:9377-9409)
    nbr_owner = owner[np.searchsorted(cells, nl.of_neighbor)]
    to_owner = owner[np.searchsorted(cells, nl.to_neighbor)]
    outer = np.zeros(len(cells), dtype=bool)
    np.add.at(outer, nl.of_source[owner[nl.of_source] != nbr_owner], True)
    np.add.at(outer, nl.to_source[owner[nl.to_source] != to_owner], True)

    for d in range(plan.n_dev):
        n_inner = int(plan.hoods[_DEFAULT_HOOD].n_inner[d])
        ids = plan.local_ids[d]
        pos = np.searchsorted(cells, ids)
        got_outer = outer[pos]
        if np.any(got_outer[:n_inner]):
            _fail(f"device {d}: an inner row has a remote neighbor",
                  cells=ids[:n_inner][got_outer[:n_inner]])
        if np.any(~got_outer[n_inner:len(ids)]):
            _fail(f"device {d}: an outer row has no remote neighbor",
                  cells=ids[n_inner:][~got_outer[n_inner:len(ids)]])

    # send/receive symmetry per neighborhood, slot by slot in numpy;
    # the first offending slot is reported as the reference's loop does
    for hid, hp in plan.hoods.items():
        send_rows, recv_rows = hp.send_rows, hp.recv_rows
        for p in range(plan.n_dev):
            for q in range(plan.n_dev):
                srows = np.asarray(send_rows[p, q])
                rrows = np.asarray(recv_rows[q, p])
                if np.sum(srows >= 0) != np.sum(rrows >= 0):
                    _fail(f"hood {hid}: send/recv count mismatch {p}->{q}")
                pad_bad = np.flatnonzero((srows >= 0) != (rrows >= 0))
                live = np.flatnonzero((srows >= 0) & (rrows >= 0))
                sid = plan.local_ids[p][srows[live]]
                rid = plan.ghost_ids[q][rrows[live] - plan.L]
                id_bad = live[sid != rid]
                first_pad = pad_bad[0] if len(pad_bad) else len(srows)
                first_id = id_bad[0] if len(id_bad) else len(srows)
                if first_pad <= first_id and len(pad_bad):
                    _fail(f"hood {hid}: send/recv padding mismatch "
                          f"{p}->{q}@{first_pad}")
                if first_id < len(srows):
                    k = int(np.searchsorted(live, first_id))
                    _fail(
                        f"hood {hid}: transfer {p}->{q} slot {first_id} sends "
                        f"cell {sid[k]} into ghost row of cell {rid[k]}",
                        cells=(sid[k], rid[k]),
                    )


def verify_user_data(grid) -> None:
    """Field tensors have the planned ``[n_dev, R, ...]`` layout and the
    permanent zero pad row really is zero (stencil gathers rely on it)."""
    plan = grid.plan
    for name, (shape, dtype) in grid.fields.items():
        arr = grid.data.get(name)
        if arr is None:
            _fail(f"field {name!r} missing from grid.data")
        want = (plan.n_dev, plan.R) + shape
        if tuple(arr.shape) != want:
            _fail(f"field {name!r}: shape {tuple(arr.shape)} != planned {want}")
        if arr.dtype != dtype:
            _fail(f"field {name!r}: dtype {arr.dtype} != declared {dtype}")
        if bool((arr[:, plan.R - 1] != 0).any()):
            _fail(f"field {name!r}: zero pad row has been written to")


def pin_requests_succeeded(grid) -> None:
    """Every granted pin request placed its cell (dccrg.hpp:13017)."""
    plan = grid.plan
    for cid, dev in grid._pins.items():
        pos = np.searchsorted(plan.cells, np.uint64(cid))
        if pos >= len(plan.cells) or plan.cells[pos] != np.uint64(cid):
            continue  # pinned cell no longer exists (refined away)
        if plan.owner[pos] != dev:
            _fail(f"pinned cell {cid} is on device {plan.owner[pos]}, "
                  f"not {dev}", cells=(cid,))


def verify_refinement_balance(grid) -> None:
    """The 2:1 invariant recomputed over FACE adjacency from pure
    index arithmetic — no neighbor engine involved (the engines assume
    <=1-level jumps and cannot even resolve a violating grid), no
    stored lists trusted. For every cell, probe one smallest-index
    unit across each of its 6 faces at the cell's min corner: the leaf
    containing that probe face-touches the cell, and — because aligned
    boxes >=4x larger fully cover a smaller face they touch — every
    violating coarse/fine face pair is seen from its fine side's
    corner probe. |level difference| > 1 fails, naming both cells
    (dccrg.hpp:9730-9906 guarantees the invariant after every
    commit)."""
    mapping = grid.mapping
    cells = grid.plan.cells
    n = len(cells)
    if n == 0:
        return
    idx = mapping.get_indices(cells).astype(np.int64)  # [n, 3] min corner
    lvl = mapping.get_refinement_level(cells).astype(np.int64)
    size = (1 << (mapping.max_refinement_level - lvl)).astype(np.int64)
    ilen = mapping.get_index_length().astype(np.int64)
    periodic = np.array([grid.topology.is_periodic(d) for d in range(3)])

    for d in range(3):
        for sign in (-1, 1):
            probe = idx.copy()
            probe[:, d] = idx[:, d] + (size if sign > 0 else -1)
            if periodic[d]:
                probe[:, d] %= ilen[d]
                valid = np.ones(n, dtype=bool)
            else:
                valid = (probe[:, d] >= 0) & (probe[:, d] < ilen[d])
            if not valid.any():
                continue
            # finest-first descent: the leaf containing each probe
            nbr_id = np.zeros(n, dtype=np.uint64)
            nbr_lvl = np.full(n, -1, dtype=np.int64)
            todo = valid.copy()
            for L in range(mapping.max_refinement_level, -1, -1):
                if not todo.any():
                    break
                cand = np.asarray(mapping.get_cell_from_indices(
                    probe[todo], L))
                pos = np.minimum(np.searchsorted(cells, cand), n - 1)
                hit = cells[pos] == cand
                ti = np.nonzero(todo)[0][hit]
                nbr_id[ti] = cand[hit]
                nbr_lvl[ti] = L
                todo[ti] = False
            found = valid & (nbr_lvl >= 0)
            bad = found & (np.abs(lvl - nbr_lvl) > 1)
            if bad.any():
                offenders = np.unique(np.concatenate(
                    [cells[bad], nbr_id[bad]]))
                _fail(
                    f"2:1 refinement balance violated across "
                    f"{int(bad.sum())} face pair(s) (direction "
                    f"{'+-'[sign < 0]}{'xyz'[d]})", cells=offenders,
                )


def verify_neighbor_symmetry(grid, of_streams: dict | None = None) -> None:
    """of/to mutual consistency, recomputed with two INDEPENDENT
    engines: the forward of-engine (window resolution per source) and
    the direct to-subset query (candidate-source enumeration per
    target) must describe the exact same relation — if B is in A's
    neighbors_of, then A must be reported as a to-neighbor of B, and
    vice versa. A divergence means one engine resolved an edge the
    other missed (the bug class the reference's DEBUG builds catch by
    comparing both directions, dccrg.hpp:12516-12750)."""
    cells = grid.plan.cells
    n = len(cells)
    if of_streams is None:
        of_streams = _recompute_of_streams(grid)
    for hid, offsets in grid.neighborhoods.items():
        src, nbr, _off, _item = of_streams[hid]
        qi, to_src, _off2 = find_neighbors_to_subset(
            grid.mapping, grid.topology, cells, cells, offsets
        )
        fwd = np.unique(src.astype(np.int64) * n
                        + np.searchsorted(cells, nbr))
        rev = np.unique(np.searchsorted(cells, to_src) * n
                        + qi.astype(np.int64))
        if not np.array_equal(fwd, rev):
            odd = np.setxor1d(fwd, rev)
            offenders = np.unique(np.concatenate(
                [cells[odd // n], cells[odd % n]]
            ))
            _fail(
                f"neighborhood {hid}: forward and inverse neighbor "
                f"engines disagree on {len(odd)} edge(s)", cells=offenders,
            )


def verify_partition_coverage(grid) -> None:
    """Every cell is owned exactly once: the per-device local row sets
    are pairwise disjoint and their union is exactly the cell list —
    the global complement of is_consistent's per-device checks (a cell
    silently dropped from every device, or claimed by two, is caught
    here by the totals)."""
    plan = grid.plan
    all_local = (np.concatenate(plan.local_ids) if plan.n_dev
                 else np.empty(0, np.uint64))
    s = np.sort(all_local)
    dup = np.unique(s[:-1][s[:-1] == s[1:]]) if len(s) > 1 else s[:0]
    if len(dup):
        _fail("cells owned by more than one device", cells=dup)
    missing = np.setdiff1d(plan.cells, s, assume_unique=False)
    if len(missing):
        _fail("cells owned by no device", cells=missing)
    extra = np.setdiff1d(s, plan.cells, assume_unique=False)
    if len(extra):
        _fail("device rows hold ids outside the cell list", cells=extra)


def find_nonfinite_cells(grid, fields=None) -> dict:
    """Locate non-finite values: ``{field: cell ids}`` (id-sorted) for
    every watched inexact field holding a NaN/Inf in a LOCAL row (ghost
    copies mirror some other partition's local row, so local rows cover
    every real offender). Run it only after the cheap probe
    (resilience.check_finite) has tripped, to name the offenders in the
    diagnostic bundle. The rows are found on the grid's device and only
    the offending rows' ids are looked up on the host (each partition's
    ``plan.local_ids``), so a trip on a large grid costs one pass over
    each field, not a host copy of it."""
    import torch

    out = {}
    names = list(fields) if fields is not None else list(grid.fields)
    for name in names:
        dtype = grid.fields[name][1]
        if not (dtype.is_floating_point or dtype.is_complex):
            continue
        hits = []
        for p in range(grid.n_dev):
            bad = ~torch.isfinite(
                grid.data[name][p, :int(grid.plan.n_local[p])])
            if bad.dim() > 1:
                bad = bad.reshape(bad.shape[0], -1).any(dim=1)
            rows = torch.nonzero(bad).flatten().cpu().numpy()
            if len(rows):
                hits.append(np.asarray(grid.plan.local_ids[p])[rows])
        if hits:
            out[name] = np.sort(np.concatenate(hits))
    return out


def verify_all(grid, check_pins: bool = True) -> None:
    """Every invariant above. ``check_pins=False`` skips
    pin_requests_succeeded — a pin is a REQUEST until the next
    balance_load applies it, so mutation boundaries that don't apply
    pins (adapt commits) legitimately hold unplaced pins."""
    is_consistent(grid)
    verify_partition_coverage(grid)
    # one forward-engine recompute feeds both neighbor checks; the
    # symmetry check's independence comes from the to-subset engine
    of_streams = _recompute_of_streams(grid)
    verify_neighbors(grid, of_streams)
    verify_neighbor_symmetry(grid, of_streams)
    verify_refinement_balance(grid)
    verify_remote_neighbor_info(grid)
    verify_user_data(grid)
    if check_pins:
        pin_requests_succeeded(grid)
