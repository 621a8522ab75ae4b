"""Host-side neighbor resolution, level 0 and under AMR.

Port of ``dccrg_tpu/neighbors.py`` (its NumPy engine, and dispatch to
the native engine of dccrg_tpu_torch/native, which returns the same
entries): the semantics of the
reference's ``find_neighbors_of`` / ``find_neighbors_to``
(dccrg.hpp:4236-4897), vectorized over (cells x neighborhood items) by
binary search in the sorted cell list.

- A neighborhood is a list of integer offset triples in units of the
  cell's own edge length; offset (hx,hy,hz) denotes the window of the
  cell's own size at that displacement.
- Per window the neighbor is the same-level cell occupying it, or the
  coarser cell containing it, or the 8 finer cells inside it in
  z-order (x fastest).
- Exact duplicate (neighbor, offset) entries from a coarser neighbor
  covering several windows are collapsed (``_dedup_entries``).
- Offsets are the displacement of the neighbor's min corner from the
  cell's, in smallest-cell index units, logical (not wrapped) across
  periodic boundaries; ``neighbors_to`` is the exact inverse.

On a complete level-0 grid ``build_neighbor_lists`` computes the lists
arithmetically (same entries, same order); any other cell set goes
through the engine.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .mapping import Mapping
from .topology import GridTopology

# Maximum addressable index extent for the vectorized engine: signed
# 63-bit arithmetic is used for offset windows.
_MAX_INDEX = 2**62


def face_masks(cell_ilen, nbr_ilen, offs, mask):
    """Per-dimension (plus, minus) face masks for gathered stencil
    blocks — the reference's face-detection offset arithmetic
    (tests/advection/solve.hpp:76-120): a neighbor at logical offset
    ``o`` with index length ``nl`` is a face neighbor in dimension d
    when ``o_d`` equals the cell's index length (+d side) or ``-nl``
    (-d side) and the windows overlap in both other dimensions.

    Works on [L, S]-shaped device blocks (torch) and on flat [E]-shaped
    host arrays (numpy) alike: ``cell_ilen`` broadcastable against
    ``nbr_ilen``, ``offs[..., 3]``, boolean ``mask``."""
    ci = cell_ilen
    overlap = [(offs[..., d] < ci) & (offs[..., d] > -nbr_ilen) for d in range(3)]
    faces = []
    for d in range(3):
        others = [overlap[e] for e in range(3) if e != d]
        both = others[0] & others[1] & mask
        faces.append(((offs[..., d] == ci) & both,
                      (offs[..., d] == -nbr_ilen) & both))
    return faces


def make_neighborhood(length: int) -> np.ndarray:
    """Default neighborhood offsets (dccrg.hpp:8017-8076): the 6 face
    offsets for length 0 (-z, -y, -x, +x, +y, +z order), else the full
    cube of radius ``length`` without (0,0,0), z-major x-fastest."""
    if length < 0:
        raise ValueError(f"neighborhood length must be >= 0, got {length}")
    if length == 0:
        return np.array(
            [[0, 0, -1], [0, -1, 0], [-1, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
            dtype=np.int64,
        )
    r = np.arange(-length, length + 1, dtype=np.int64)
    z, y, x = np.meshgrid(r, r, r, indexing="ij")
    items = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    return items[np.any(items != 0, axis=1)]


def validate_neighborhood(offsets: np.ndarray, default_length: int) -> np.ndarray:
    """User-neighborhood validation (dccrg.hpp:6573-6606): offsets must
    be unique, nonzero, and within the default neighborhood radius."""
    offsets = np.asarray(offsets, dtype=np.int64).reshape(-1, 3)
    if len(offsets) == 0:
        raise ValueError("neighborhood must contain at least one offset")
    if np.any(np.all(offsets == 0, axis=1)):
        raise ValueError("neighborhood must not contain the (0,0,0) offset")
    limit = max(default_length, 1)
    if np.any(np.abs(offsets) > limit):
        raise ValueError(
            f"neighborhood offsets must be within the default neighborhood "
            f"(max |offset| {limit}), got {offsets[np.any(np.abs(offsets) > limit, axis=1)][0]}"
        )
    if len(np.unique(offsets, axis=0)) != len(offsets):
        raise ValueError("neighborhood offsets must be unique")
    return offsets


@dataclass
class NeighborLists:
    """Flat ragged neighbors_of / neighbors_to for a cell set.

    ``of_*`` arrays: one entry per (cell, neighborhood item, neighbor).
    ``of_source`` indexes the queried cell array; ``of_neighbor`` holds
    neighbor cell ids; ``of_offset`` the [n,3] int64 logical offsets;
    ``of_item`` which neighborhood item produced the entry.
    ``to_*`` arrays: the inverted relation (cells that consider a cell
    their neighbor), in the reference's order.
    """

    of_source: np.ndarray
    of_neighbor: np.ndarray
    of_offset: np.ndarray
    of_item: np.ndarray
    to_source: np.ndarray
    to_neighbor: np.ndarray
    to_offset: np.ndarray


class StructureError(RuntimeError):
    """The cell set violates grid invariants (gap, overlap, or a
    refinement-level jump > 1 inside a neighborhood)."""


def find_neighbors_of(
    mapping: Mapping,
    topology: GridTopology,
    all_cells_sorted: np.ndarray,
    query_cells: np.ndarray,
    neighborhood: np.ndarray,
):
    """neighbors_of for ``query_cells`` against the complete cell set.

    Returns flat arrays (source_index, neighbor_id, offset[ n,3 ],
    item_index) sorted by (source, item, z-order sibling rank).

    ``all_cells_sorted`` must be the complete sorted leaf-cell set of
    the grid (replicated structure).

    Dispatches to the native engine (dccrg_tpu_torch/native) when it is
    on; the NumPy implementation below gives the same entries and is the
    fallback.
    """
    from . import native

    if native.lib() is not None and len(np.atleast_1d(query_cells)) > 0:
        index_length = mapping.get_index_length().astype(np.int64)
        if not np.any(index_length >= _MAX_INDEX):
            out = native.find_neighbors_of(
                mapping, topology, all_cells_sorted, query_cells, neighborhood
            )
            return _dedup_entries(mapping, query_cells, *out)
    return _dedup_entries(mapping, query_cells, *_find_neighbors_of_numpy(
        mapping, topology, all_cells_sorted, query_cells, neighborhood
    ))


def _dedup_entries(mapping, query_cells, src, nbr, off, item):
    """Collapse exact-duplicate (source, neighbor, offset) entries.

    A neighbor one level coarser than the queried cell covers up to 4
    neighborhood windows, and every one of those items records it with
    the same min-corner offset. Stencil kernels must see each physical
    neighbor relation once (the reference's advection DEBUG check
    asserts face-detected neighbors match the unique
    get_face_neighbors_of set, tests/advection/solve.hpp:236-266), so
    the first entry — lowest item index — is kept. A neighbor CAN
    legitimately recur with different offsets (periodic wrap-around
    self-neighbors), which is preserved.

    Only entries whose neighbor is COARSER than the source can be
    exact duplicates (same-level and finer neighbors are unique per
    window, and wrap-around recurrences differ in offset), so the
    uniqueness pass runs on that usually-tiny subset."""
    if len(src) == 0:
        return src, nbr, off, item
    query_cells = np.atleast_1d(np.asarray(query_cells, dtype=np.uint64))
    src_lvl = mapping.get_refinement_level(query_cells)
    nbr_lvl = mapping.get_refinement_level(nbr)
    cand = nbr_lvl < src_lvl[src]
    if not cand.any():
        return src, nbr, off, item
    ci = np.nonzero(cand)[0]
    key = np.stack(
        [src[ci].astype(np.int64), nbr[ci].astype(np.int64),
         off[ci, 0], off[ci, 1], off[ci, 2]], axis=1,
    )
    _, first = np.unique(key, axis=0, return_index=True)
    keep = np.ones(len(src), dtype=bool)
    keep[ci] = False
    keep[ci[first]] = True
    idx = np.nonzero(keep)[0]
    return src[idx], nbr[idx], off[idx], item[idx]


def _find_neighbors_of_numpy(
    mapping: Mapping,
    topology: GridTopology,
    all_cells_sorted: np.ndarray,
    query_cells: np.ndarray,
    neighborhood: np.ndarray,
):
    """Pure-NumPy neighbor resolution (reference implementation)."""
    query_cells = np.asarray(query_cells, dtype=np.uint64)
    neighborhood = np.asarray(neighborhood, dtype=np.int64).reshape(-1, 3)
    n, k = len(query_cells), len(neighborhood)
    if n == 0 or k == 0:
        empty = np.empty(0, dtype=np.int64)
        return empty, np.empty(0, dtype=np.uint64), np.empty((0, 3), dtype=np.int64), empty

    index_length = mapping.get_index_length().astype(np.int64)
    if np.any(index_length >= _MAX_INDEX):
        raise StructureError("grid index space too large for the vectorized engine")

    lvl = mapping.get_refinement_level(query_cells)  # [n]
    if np.any(lvl < 0):
        raise ValueError("invalid cell id in query")
    size = (1 << (mapping.max_refinement_level - lvl)).astype(np.int64)  # [n]
    base = mapping.get_indices(query_cells).astype(np.int64)  # [n,3]

    periodic = np.array([topology.is_periodic(d) for d in range(3)])

    # window min corners, logical: [n, k, 3]
    win = base[:, None, :] + neighborhood[None, :, :] * size[:, None, None]
    # wrap / validity
    inside = np.ones((n, k), dtype=bool)
    wrapped = win.copy()
    for d in range(3):
        if periodic[d]:
            wrapped[:, :, d] = np.mod(win[:, :, d], index_length[d])
        else:
            inside &= (win[:, :, d] >= 0) & (win[:, :, d] < index_length[d])
    wrapped = np.where(inside[:, :, None], wrapped, 0)

    exists = lambda ids: all_cells_sorted[
        np.minimum(np.searchsorted(all_cells_sorted, ids), len(all_cells_sorted) - 1)
    ] == ids if len(all_cells_sorted) else np.zeros(ids.shape, bool)

    lvl_b = np.broadcast_to(lvl[:, None], (n, k))
    # same-level slot cell at the window min corner
    slot = mapping.get_cell_from_indices(
        wrapped.reshape(-1, 3).astype(np.uint64), lvl_b.reshape(-1)
    ).reshape(n, k)
    have_same = exists(slot) & inside

    # coarser (level-1) cell containing the window
    lvl_up = np.maximum(lvl_b - 1, 0)
    coarse = mapping.get_cell_from_indices(
        wrapped.reshape(-1, 3).astype(np.uint64), lvl_up.reshape(-1)
    ).reshape(n, k)
    have_coarse = exists(coarse) & inside & ~have_same & (lvl_b > 0)

    # finer: the 8 children of the slot cell
    need_fine = inside & ~have_same & ~have_coarse
    if np.any(need_fine & (lvl_b >= mapping.max_refinement_level)):
        bad = np.argwhere(need_fine & (lvl_b >= mapping.max_refinement_level))[0]
        raise StructureError(
            f"no neighbor found for cell {query_cells[bad[0]]} at offset "
            f"{neighborhood[bad[1]]}: grid does not tile the domain"
        )

    src_i, item_i = np.nonzero(have_same)
    out_src = [src_i]
    out_nbr = [slot[have_same]]
    out_off = [(neighborhood[item_i] * size[src_i, None])]
    out_item = [item_i]

    if np.any(have_coarse):
        src_i, item_i = np.nonzero(have_coarse)
        csize = 2 * size[src_i]
        # coarse cell min corner (aligned down), relative to window min
        cmin = (wrapped[src_i, item_i] // csize[:, None]) * csize[:, None]
        rel = cmin - wrapped[src_i, item_i]  # components in {-s, 0}
        out_src.append(src_i)
        out_nbr.append(coarse[have_coarse])
        out_off.append(neighborhood[item_i] * size[src_i, None] + rel)
        out_item.append(item_i)

    if np.any(need_fine):
        src_i, item_i = np.nonzero(need_fine)
        half = size[src_i] // 2  # child edge length
        kk = np.arange(8, dtype=np.int64)
        dx = (kk & 1)[None, :] * half[:, None]
        dy = ((kk >> 1) & 1)[None, :] * half[:, None]
        dz = ((kk >> 2) & 1)[None, :] * half[:, None]
        child_rel = np.stack([dx, dy, dz], axis=-1)  # [m, 8, 3]
        child_idx = wrapped[src_i, item_i][:, None, :] + child_rel
        children = mapping.get_cell_from_indices(
            child_idx.reshape(-1, 3).astype(np.uint64),
            np.repeat(lvl[src_i] + 1, 8),
        ).reshape(-1, 8)
        ok = exists(children)
        if not np.all(ok):
            bad = np.argwhere(~ok)[0]
            raise StructureError(
                f"cell {query_cells[src_i[bad[0]]]} offset {neighborhood[item_i[bad[0]]]}: "
                f"window neither tiled by level {lvl[src_i[bad[0]]] + 1} cells nor coarser "
                f"(2:1 balance violated or grid has gaps)"
            )
        out_src.append(np.repeat(src_i, 8))
        out_nbr.append(children.reshape(-1))
        base_off = neighborhood[item_i] * size[src_i, None]
        out_off.append((base_off[:, None, :] + child_rel).reshape(-1, 3))
        out_item.append(np.repeat(item_i, 8))

    src = np.concatenate(out_src)
    nbr = np.concatenate(out_nbr)
    off = np.concatenate(out_off)
    item = np.concatenate(out_item)

    # order: by (source, neighborhood item, z-order within item)
    order = np.lexsort((np.arange(len(src)), item, src))
    return src[order], nbr[order], off[order], item[order]


def find_neighbors_to_subset(
    mapping: Mapping,
    topology: GridTopology,
    all_cells_sorted: np.ndarray,
    query_cells: np.ndarray,
    neighborhood: np.ndarray,
):
    """neighbors_to for a SUBSET of cells without building (and
    inverting) the full neighbors_of stream: for each query cell ``v``,
    the cells ``c`` with ``v`` in their neighbors_of.

    Direct enumeration: ``v`` is in c's window at item ``o`` iff
    ``c`` exists as a leaf, levels differ by <= 1, and v's box
    intersects the window ``[c.base + o*size_c, +size_c)``.
    (Intersection is sufficient: window resolution — same-level cell,
    containing coarser cell, or contained finer cells,
    dccrg.hpp:4744-4897 — then necessarily yields ``v`` because boxes
    at these sizes are aligned and ``v`` is a leaf.) Candidate window
    bases are the <= 3-per-dimension size_c-aligned positions
    overlapping v's box, enumerated per (item, source level).

    Returns ``(src_index, source_id, offset)`` flat arrays where
    ``src_index`` indexes ``query_cells``, ``offset`` is the recorded
    to-offset (``-of_offset``), ordered per query cell by (source
    position, item) — the order produced by inverting the full stream.
    Exact (source, offset) duplicates from a coarser source covering
    several windows are collapsed to the lowest item, mirroring
    _dedup_entries.
    """
    query_cells = np.atleast_1d(np.asarray(query_cells, dtype=np.uint64))
    neighborhood = np.asarray(neighborhood, dtype=np.int64).reshape(-1, 3)
    m = len(query_cells)
    empty = (np.empty(0, np.int64), np.empty(0, np.uint64),
             np.empty((0, 3), np.int64))
    if m == 0 or len(neighborhood) == 0 or len(all_cells_sorted) == 0:
        return empty

    index_length = mapping.get_index_length().astype(np.int64)
    if np.any(index_length >= _MAX_INDEX):
        raise StructureError("grid index space too large for the vectorized engine")
    periodic = np.array([topology.is_periodic(d) for d in range(3)])

    v_lvl = mapping.get_refinement_level(query_cells)
    if np.any(v_lvl < 0):
        raise ValueError("invalid cell id in query")
    v_size = (1 << (mapping.max_refinement_level - v_lvl)).astype(np.int64)
    v_base = mapping.get_indices(query_cells).astype(np.int64)

    exists = lambda ids: all_cells_sorted[
        np.minimum(np.searchsorted(all_cells_sorted, ids), len(all_cells_sorted) - 1)
    ] == ids

    # fast path: a query cell is "easy" when every possible to-source
    # is provably same-level; its to-list is then closed-form (the cell
    # at -o per item, offset -o*size). Finer sources reach at most the
    # +-hood slots, so a level-0 cell (no coarser cells exist) is easy
    # when its same-level neighbor exists at every valid +-offset. A
    # deeper cell can additionally have a COARSER source out to twice
    # the hood radius (the source's windows scale with ITS edge
    # length), so it must pass the same test over the doubled box —
    # any coarser leaf in that box would cover one of its slots.
    def same_level_at(off_arr):
        """(ids, valid, exist) of the same-level cells at v + off*size."""
        tgt = v_base + off_arr * v_size[:, None]
        ok = np.ones(m, dtype=bool)
        wrapped = tgt.copy()
        for d in range(3):
            if periodic[d]:
                wrapped[:, d] = np.mod(tgt[:, d], index_length[d])
            else:
                ok &= (tgt[:, d] >= 0) & (tgt[:, d] < index_length[d])
        ids = mapping.get_cell_from_indices(
            np.where(ok[:, None], wrapped, 0).astype(np.uint64), v_lvl
        )
        return ids, ok, exists(ids) & ok

    # the probe must cover every slot a source's window can originate
    # from — the FULL box of per-dim radius rho, not just the listed
    # offsets: for a sparse hood like [[2,0,0]] a finer source's
    # half-size windows reach the query from the unprobed +-1 slot.
    rho = np.abs(neighborhood).max(axis=0)

    def box_test(radius_scale, restrict):
        nonlocal easy
        box = [np.arange(-radius_scale * r, radius_scale * r + 1, dtype=np.int64)
               for r in rho]
        if np.prod([float(len(b)) for b in box]) > 360:
            easy &= ~restrict  # huge hood: fall back to full enumeration
            return
        for ox in box[0]:
            for oy in box[1]:
                for oz in box[2]:
                    if ox == oy == oz == 0:
                        continue
                    if not easy[restrict].any():
                        return
                    _ids, ok, ex = same_level_at(
                        np.array([[ox, oy, oz]], dtype=np.int64)
                    )
                    easy &= ~(restrict & ~(ex | ~ok))

    easy = np.ones(m, dtype=bool)
    box_test(1, np.ones(m, dtype=bool))
    deep = v_lvl > 0
    if deep.any():
        # deeper cells: a COARSER source's windows scale with its own
        # (doubled) edge length, reaching out to twice the hood radius
        box_test(2, deep)
    out_q, out_src, out_off, out_item = [], [], [], []
    if easy.any():
        for j, o in enumerate(neighborhood):
            ids, ok, ex = same_level_at(-o[None, :])
            sel = np.nonzero(easy & ex)[0]
            if len(sel):
                out_q.append(sel)
                out_src.append(ids[sel])
                out_off.append(-o[None, :] * v_size[sel, None])
                out_item.append(np.full(len(sel), j, dtype=np.int64))
    if easy.all():
        if not out_q:
            return empty
        q = np.concatenate(out_q)
        src = np.concatenate(out_src)
        off = np.concatenate(out_off)
        item = np.concatenate(out_item)
        src_pos = np.searchsorted(all_cells_sorted, src)
        order = np.lexsort((item, src_pos, q))
        return q[order], src[order], off[order]

    # hard queries: candidate-window enumeration — the native engine
    # when it is on, the NumPy loop below otherwise (identical raw
    # entries)
    from . import native

    hard_idx = np.nonzero(~easy)[0]
    if native.lib() is not None and len(hard_idx):
        hq, hsrc, hoff, hitem = native.find_neighbors_to_subset_raw(
            mapping, topology, all_cells_sorted, query_cells[hard_idx],
            neighborhood,
        )
        out_q.append(hard_idx[hq])
        out_src.append(hsrc)
        out_off.append(hoff)
        out_item.append(hitem)
        easy = np.ones(m, dtype=bool)  # skip the NumPy enumeration below
    for j, o in enumerate(neighborhood):
        for dlvl in (-1, 0, 1):
            c_lvl = v_lvl + dlvl
            # easy queries were answered closed-form above
            sel = (c_lvl >= 0) & (c_lvl <= mapping.max_refinement_level) & ~easy
            if not sel.any():
                continue
            qi = np.nonzero(sel)[0]
            sc = (1 << (mapping.max_refinement_level - c_lvl[qi])).astype(np.int64)
            vb, sv = v_base[qi], v_size[qi]
            # per-dim aligned window bases overlapping [vb, vb+sv):
            # w in [vb - sc + 1, vb + sv - 1], w % sc == 0
            w_lo = -(-(vb - sc[:, None] + 1) // sc[:, None]) * sc[:, None]
            counts = (vb + sv[:, None] - 1 - w_lo) // sc[:, None] + 1  # [q,3] >= 0
            cmax = int(counts.max(initial=0))
            if cmax <= 0:
                continue
            # expand the per-dim candidate grids
            steps = np.arange(cmax, dtype=np.int64)
            w_d = [w_lo[:, d, None] + steps[None, :] * sc[:, None] for d in range(3)]
            ok_d = [steps[None, :] < counts[:, d, None] for d in range(3)]
            # cartesian product via broadcasting: [q, cx, cy, cz]
            okm = (ok_d[0][:, :, None, None] & ok_d[1][:, None, :, None]
                   & ok_d[2][:, None, None, :])
            qq, ix, iy, iz = np.nonzero(okm)
            if len(qq) == 0:
                continue
            w = np.stack([w_d[0][qq, ix], w_d[1][qq, iy], w_d[2][qq, iz]], axis=1)
            scq = sc[qq]
            c_base = w - o[None, :] * scq[:, None]  # logical
            # wrap / validity of the SOURCE cell position
            ok = np.ones(len(qq), dtype=bool)
            c_wrapped = c_base.copy()
            for d in range(3):
                if periodic[d]:
                    c_wrapped[:, d] = np.mod(c_base[:, d], index_length[d])
                else:
                    ok &= (c_base[:, d] >= 0) & (c_base[:, d] + scq < index_length[d] + 1)
            # the window itself must be inside the grid for non-periodic
            for d in range(3):
                if not periodic[d]:
                    ok &= (w[:, d] >= 0) & (w[:, d] < index_length[d])
            if not ok.any():
                continue
            qq, w, scq, c_wrapped = qq[ok], w[ok], scq[ok], c_wrapped[ok]
            cl = c_lvl[qi][qq]
            c_ids = mapping.get_cell_from_indices(
                c_wrapped.astype(np.uint64), cl
            )
            # source must exist as a leaf (a wrap-around source CAN be
            # the query cell itself: the stream keeps self entries on
            # tiny periodic dims)
            ex = exists(c_ids)
            if not ex.any():
                continue
            qq, w, scq, c_ids = qq[ex], w[ex], scq[ex], c_ids[ex]
            # recorded of_offset = v.min - c.min in c's logical frame:
            # v.base - c_base_logical = v.base - (w - o*sc)
            of_off = v_base[qi][qq] - w + o[None, :] * scq[:, None]
            out_q.append(qi[qq])
            out_src.append(c_ids)
            out_off.append(-of_off)
            out_item.append(np.full(len(qq), j, dtype=np.int64))

    if not out_q:
        return empty
    q = np.concatenate(out_q)
    src = np.concatenate(out_src)
    off = np.concatenate(out_off)
    item = np.concatenate(out_item)
    # dedup exact (query, source, offset) repeats, keep lowest item
    key = np.stack([q, src.astype(np.int64), off[:, 0], off[:, 1], off[:, 2]], axis=1)
    order0 = np.lexsort((item, key[:, 4], key[:, 3], key[:, 2], key[:, 1], key[:, 0]))
    ks = key[order0]
    first = np.ones(len(ks), dtype=bool)
    first[1:] = np.any(ks[1:] != ks[:-1], axis=1)
    keep = order0[first]
    q, src, off, item = q[keep], src[keep], off[keep], item[keep]
    # order per query cell by (source position, item) — stream parity
    src_pos = np.searchsorted(all_cells_sorted, src)
    order = np.lexsort((item, src_pos, q))
    return q[order], src[order], off[order]


def build_neighbor_lists(mapping, topology, all_cells_sorted,
                         neighborhood) -> NeighborLists:
    """neighbors_of for every cell of a complete level-0 grid, plus the
    inverted neighbors_to relation (dccrg_tpu/neighbors.py:558).

    Item ``j`` of cell ``c`` resolves to the level-0 cell at
    ``ijk(c) + neighborhood[j]``, wrapped on periodic axes and absent
    where it leaves a non-periodic axis. Offsets are logical (not
    wrapped) in smallest-cell index units (``neighborhood[j] *
    2^max_refinement_level``). Entries are sorted by (source, item), as
    the reference's engine sorts them; a level-0 grid has no coarser
    neighbors, so nothing is deduplicated. Any other cell set goes
    through ``find_neighbors_of`` and is inverted the same way."""
    cells = np.asarray(all_cells_sorted, dtype=np.uint64)
    dims = tuple(int(v) for v in mapping.length.get())
    nx, ny, nz = dims
    n0 = nx * ny * nz
    if len(cells) != n0 or (n0 and int(cells[-1]) != n0):
        return _invert(cells, *find_neighbors_of(
            mapping, topology, cells, cells, neighborhood)[:4])
    neighborhood = np.asarray(neighborhood, dtype=np.int64).reshape(-1, 3)
    k = len(neighborhood)
    size = np.int64(1) << np.int64(mapping.max_refinement_level)
    gidx = np.arange(n0, dtype=np.int64)
    coords = (gidx % nx, (gidx // nx) % ny, gidx // (nx * ny))
    valid = np.ones((n0, k), dtype=bool)
    nbr_g = np.zeros((n0, k), dtype=np.int64)
    stride = 1
    for d in range(3):
        t = coords[d][:, None] + neighborhood[None, :, d]
        if topology.is_periodic(d):
            t = np.mod(t, dims[d])
        else:
            valid &= (t >= 0) & (t < dims[d])
        nbr_g += t * stride
        stride *= dims[d]
    src, item = np.nonzero(valid)  # row-major: (source, item) order
    nbr = cells[nbr_g[src, item]]
    off = neighborhood[item] * size
    return _invert(cells, src, nbr, off, item)


def _invert(cells, src, nbr, off, item) -> NeighborLists:
    """The flat lists from a neighbors_of stream: v in neighbors_of(c)
    with offset o  =>  c in neighbors_to(v) with offset -o
    (displacement of c's min corner from v's)."""
    to_src = np.searchsorted(cells, nbr)
    to_nbr = cells[src]
    to_off = -off
    order = np.lexsort((np.arange(len(to_src)), to_src))
    return NeighborLists(
        of_source=src,
        of_neighbor=nbr,
        of_offset=off,
        of_item=item,
        to_source=to_src[order],
        to_neighbor=to_nbr[order],
        to_offset=to_off[order],
    )


def verify_tiling(mapping: Mapping, all_cells_sorted: np.ndarray) -> None:
    """DEBUG-style invariant check (cf. dccrg.hpp:12516-12750): the cell
    set exactly tiles the index space — total volume matches and no two
    cells overlap (sufficient together with uniqueness)."""
    cells = np.asarray(all_cells_sorted, dtype=np.uint64)
    if len(cells) > 1 and np.all(cells[1:] >= cells[:-1]):
        dup = bool(np.any(cells[1:] == cells[:-1]))
    else:
        dup = len(np.unique(cells)) != len(cells)
    if dup:
        raise StructureError("duplicate cell ids")
    lvl = mapping.get_refinement_level(cells)
    if np.any(lvl < 0):
        raise StructureError("invalid cell id in cell set")
    # volume in index units, per-level counts summed as Python ints
    # (exact for any grid size)
    max_lvl = mapping.max_refinement_level
    per_level = np.bincount(lvl, minlength=max_lvl + 1)
    total = sum(int(c) << (3 * (max_lvl - lv))
                for lv, c in enumerate(per_level))
    expect = int(np.prod(mapping.get_index_length().astype(object)))
    if total != expect:
        raise StructureError(f"cells cover volume {total}, grid volume is {expect}")
    # overlap check: no cell's ancestor may also be present
    for up in range(1, mapping.max_refinement_level + 1):
        sub = cells[lvl >= up]
        if len(sub) == 0:
            continue
        anc = sub
        for _ in range(up):
            anc = mapping.get_parent(anc)
        pos = np.searchsorted(cells, anc)
        pos = np.minimum(pos, len(cells) - 1)
        if np.any(cells[pos] == anc):
            raise StructureError("overlapping cells: an ancestor of a cell is also present")
