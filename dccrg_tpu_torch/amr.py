"""Adaptive mesh refinement: the request/commit algorithms.

Port of ``dccrg_tpu/amr.py`` (NumPy, unchanged but for the reference's
fault-injection sites, which the port has not taken yet).

Host-side equivalents of the reference's AMR commit pipeline
(dccrg.hpp:3483-3507 ``stop_refining`` = override_refines ->
induce_refines -> override_unrefines -> execute_refines,
:9730-10693). The reference runs iterated global collectives until
quiescence because each rank only sees parts of the structure; here
structure is replicated, so the same fixpoints run as vectorized numpy
set iterations over the full neighbor lists.

Semantics preserved:

- Refining a cell forces every coarser cell in its neighborhood (both
  directions of the neighbor relation) to refine too — induced
  refinement, iterated to a fixpoint (dccrg.hpp:9730-9906).
- ``dont_refine`` spreads: a cell that must not refine blocks the
  refinement of finer neighbors, recursively (dccrg.hpp:10130-10233).
- Unrefinement applies to whole sibling groups; it is cancelled when a
  sibling is refined, marked dont_unrefine, or when a cell too fine to
  be the parent's neighbor exists nearby, evaluated against
  post-refinement levels (dccrg.hpp:9935-10124).
- New children live on their parent's device, inheriting pins and
  weights; an unrefined parent lands on the owner of the first child
  (dccrg.hpp:10362-10399, :10437).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import faults
from .mapping import Mapping
from .topology import GridTopology


@dataclass
class AmrResult:
    """Outcome of an AMR commit."""

    cells: np.ndarray  # new sorted cell list
    owner: np.ndarray  # owners aligned with cells
    new_cells: np.ndarray  # created children (sorted)
    removed_cells: np.ndarray  # removed leaves (children of unrefined groups)
    refined_parents: np.ndarray  # cells that were replaced by children
    unrefined_parents: np.ndarray  # cells created by unrefinement

    @property
    def changed_cells(self) -> np.ndarray:
        """Every id in exactly one of the pre/post cell lists — the
        commit's exact dirty seed. stop_refining hands this to the
        hybrid plan rebuild, which dilates it by the search radius on
        the level-0 lattice instead of recomputing the symmetric
        difference of two full cell lists (hybrid.build_hybrid_plan's
        reuse branch)."""
        return np.concatenate([
            np.asarray(self.new_cells, dtype=np.uint64),
            np.asarray(self.removed_cells, dtype=np.uint64),
            np.asarray(self.refined_parents, dtype=np.uint64),
            np.asarray(self.unrefined_parents, dtype=np.uint64),
        ])


# bins above which the vectorized-lattice unrefine check falls back to
# the per-parent loop (deeply refined grids have huge fine lattices)
_LATTICE_MAX_BINS = 1 << 24


def _shift_bool(a: np.ndarray, shift: int, axis: int, periodic: bool) -> np.ndarray:
    """Boolean array shifted along ``axis``; wraps when periodic, else
    shifts in zeros."""
    if periodic:
        return np.roll(a, shift, axis=axis)
    out = np.zeros_like(a)
    n = a.shape[axis]
    if abs(shift) >= n:
        return out
    src = [slice(None)] * 3
    dst = [slice(None)] * 3
    if shift > 0:
        src[axis] = slice(0, n - shift)
        dst[axis] = slice(shift, n)
    else:
        src[axis] = slice(-shift, n)
        dst[axis] = slice(0, n + shift)
    out[tuple(dst)] = a[tuple(src)]
    return out


def _box_dilate(a: np.ndarray, radius, periodic) -> np.ndarray:
    """Chebyshev-ball (box) dilation of a 3-D bool lattice, separable
    per axis. ``radius`` is a scalar or a per-axis sequence; ``periodic``
    a per-axis sequence (both in the array's axis order)."""
    if np.isscalar(radius):
        radius = (radius,) * 3
    for d in range(3):
        acc = a.copy()
        for s in range(1, int(radius[d]) + 1):
            acc |= _shift_bool(a, s, d, periodic[d])
            acc |= _shift_bool(a, -s, d, periodic[d])
        a = acc
    return a


class _FrontierEdges:
    """Incrementally discovered neighbor edges for the commit fixpoints.

    The reference's override/induce phases propagate flags along
    neighbor links, iterated to a global fixpoint (dccrg.hpp:9730-10233).
    Propagation only ever leaves *flagged* cells, so instead of building
    the full O(all cells) of/to streams, edges are fetched on demand for
    the flagged frontier: neighbors_of via the generic engine,
    neighbors_to via the direct subset query — O(touched cells), not
    O(grid)."""

    def __init__(self, mapping, topology, cells, offsets):
        self.mapping = mapping
        self.topology = topology
        self.cells = cells
        self.offsets = offsets
        n = len(cells)
        self._expanded = np.zeros(n, dtype=bool)
        self.src = np.empty(0, dtype=np.int64)
        self.nbr = np.empty(0, dtype=np.int64)

    def expand(self, flag: np.ndarray) -> None:
        """Ensure edges of every flagged position are loaded."""
        from .neighbors import find_neighbors_of, find_neighbors_to_subset

        new = np.nonzero(flag & ~self._expanded)[0]
        if len(new) == 0:
            return
        self._expanded[new] = True
        q = self.cells[new]
        src, nbr, _off, _item = find_neighbors_of(
            self.mapping, self.topology, self.cells, q, self.offsets
        )
        qi, to_src, _off2 = find_neighbors_to_subset(
            self.mapping, self.topology, self.cells, q, self.offsets
        )
        self.src = np.concatenate([
            self.src, new[src], new[qi]
        ])
        self.nbr = np.concatenate([
            self.nbr,
            np.searchsorted(self.cells, nbr),
            np.searchsorted(self.cells, to_src),
        ])


def resolve_adaptation(
    mapping: Mapping,
    cells: np.ndarray,
    owner: np.ndarray,
    offsets: np.ndarray,
    refines: set,
    unrefines: set,
    dont_refines: set,
    dont_unrefines: set,
    pins: dict | None = None,
    weights: dict | None = None,
    topology=None,
    hood_len: int = 1,
) -> AmrResult:
    """Run the full commit pipeline on the replicated structure.

    ``offsets`` is the default neighborhood's offset list (the
    reference's commit propagates along the default neighborhood,
    dccrg.hpp:9730-9906)."""
    n = len(cells)
    lvl = mapping.get_refinement_level(cells)
    if topology is None:
        topology = GridTopology((False, False, False))

    def positions(id_set):
        """Positions of the ids that exist in the cell list."""
        if not id_set:
            return np.empty(0, dtype=np.int64)
        ids = np.fromiter((int(c) for c in id_set), dtype=np.uint64,
                          count=len(id_set))
        pos = np.minimum(np.searchsorted(cells, ids), n - 1)
        return pos[cells[pos] == ids].astype(np.int64)

    edges = _FrontierEdges(mapping, topology, cells, offsets)

    refine_flag = np.zeros(n, dtype=bool)
    rp = positions(refines)
    refine_flag[rp[lvl[rp] < mapping.max_refinement_level]] = True

    # --- override_refines: spread dont_refine to finer neighbors ------
    # (dccrg.hpp:10130-10233) a blocked cell also blocks the refinement
    # of any strictly finer neighbor, recursively.
    blocked = np.zeros(n, dtype=bool)
    blocked[positions(dont_refines)] = True
    while True:
        edges.expand(blocked)
        # finer neighbors of blocked cells become blocked
        m = blocked[edges.src] & (lvl[edges.nbr] > lvl[edges.src])
        new = np.zeros(n, dtype=bool)
        new[edges.nbr[m]] = True
        new &= ~blocked
        if not new.any():
            break
        blocked |= new
    refine_flag &= ~blocked

    # --- induce_refines (dccrg.hpp:9730-9906) --------------------------
    # refining a cell forces every coarser neighbor to refine
    while True:
        edges.expand(refine_flag)
        m = refine_flag[edges.src] & (lvl[edges.nbr] < lvl[edges.src])
        cand = np.zeros(n, dtype=bool)
        cand[edges.nbr[m]] = True
        cand &= ~refine_flag & ~blocked & (lvl < mapping.max_refinement_level)
        # note: a coarser cell that is blocked cannot be forced; the
        # reference guarantees this cannot happen because the spread
        # phase already removed the inducing refine. Keep the guard for
        # safety (blocked cells simply don't refine).
        if not cand.any():
            break
        refine_flag |= cand

    final_lvl = lvl + refine_flag.astype(np.int64)

    # --- unrefines: expand to sibling groups ---------------------------
    up = positions(unrefines)
    up = up[lvl[up] > 0]
    unref_parent = (
        np.unique(mapping.get_parent(cells[up])) if len(up)
        else np.empty(0, np.uint64)
    )

    dont_unref = np.zeros(n, dtype=bool)
    dont_unref[positions(dont_unrefines)] = True

    # --- override_unrefines (dccrg.hpp:9935-10124) ---------------------
    # The reference walks the neighborhood AROUND THE PARENT (BFS over
    # neighbors_, :10019-10124): the parent's neighborhood window has
    # the parent's own edge length as its radius unit — twice the
    # children's — so a cell just outside the children's windows can
    # still violate the <=1-level rule against the new parent. Check
    # cells intersecting the parent's would-be window directly: the
    # window is exactly the (2r+1)^3 parent-size-aligned bins around
    # the parent, so the check vectorizes as a box-dilated occupancy
    # lattice of too-fine cells (per-parent interval loop as fallback
    # for deeply refined grids whose bin lattice would be huge).
    accepted_parents = np.empty(0, np.uint64)
    cand_parents = np.empty(0, np.uint64)
    cand_kpos = np.empty((0, 8), np.int64)
    if len(unref_parent):
        idx_all = mapping.get_indices(cells).astype(np.int64)
        size_all = (1 << (mapping.max_refinement_level - lvl)).astype(np.int64)
        index_length = mapping.get_index_length().astype(np.int64)
        radius = max(int(hood_len), 1)
        periodic = np.array([topology.is_periodic(d) for d in range(3)])

        # sibling-group screening, vectorized over candidates: all 8
        # children must be leaves, none refining or marked dont_unrefine
        kids = mapping.get_all_children(unref_parent)  # [P, 8]
        kpos = np.minimum(np.searchsorted(cells, kids), n - 1)
        kid_ok = cells[kpos] == kids
        group_ok = kid_ok.all(axis=1)
        group_ok &= ~(refine_flag[kpos] & kid_ok).any(axis=1)
        group_ok &= ~(dont_unref[kpos] & kid_ok).any(axis=1)
        cand_parents = unref_parent[group_ok]
        cand_kpos = kpos[group_ok].astype(np.int64)

    if len(cand_parents):
        child_lvls = lvl[cand_kpos[:, 0]]
        accepted = np.zeros(len(cand_parents), dtype=bool)
        for child_lvl in np.unique(child_lvls):
            sel = np.nonzero(child_lvls == child_lvl)[0]
            s_c = 1 << (mapping.max_refinement_level - int(child_lvl))
            s_p = 2 * s_c  # parent size; divides the extent (child_lvl >= 1)
            fine = final_lvl > child_lvl
            # parent min corner = first child's
            parent_base = idx_all[cand_kpos[sel, 0]]
            if not fine.any():
                accepted[sel] = True
                continue
            bins = index_length // s_p
            if float(np.prod(bins.astype(np.float64))) <= _LATTICE_MAX_BINS:
                # too-fine cells (size < s_p, aligned) occupy exactly
                # one s_p bin each; a parent is rejected iff any lies
                # within Chebyshev radius of its window
                occ = np.zeros(tuple(bins), dtype=bool)
                fb = idx_all[fine] // s_p
                occ[fb[:, 0], fb[:, 1], fb[:, 2]] = True
                occ = _box_dilate(occ, radius, periodic)
                pb = parent_base // s_p
                accepted[sel] = ~occ[pb[:, 0], pb[:, 1], pb[:, 2]]
            else:
                fi, fs = idx_all[fine], size_all[fine]
                for k, base in zip(sel, parent_base):
                    lo = base - radius * s_p
                    hi = base + (radius + 1) * s_p  # exclusive
                    hit = np.ones(len(fi), dtype=bool)
                    for d in range(3):
                        if periodic[d]:
                            span = index_length[d]
                            h = np.zeros(len(fi), dtype=bool)
                            for shift in (-span, 0, span):
                                h |= (fi[:, d] + shift < hi[d]) & (
                                    fi[:, d] + fs + shift > lo[d]
                                )
                            hit &= h
                        else:
                            hit &= (fi[:, d] < hi[d]) & (fi[:, d] + fs > lo[d])
                    accepted[k] = not hit.any()
        accepted_parents = cand_parents[accepted]
        accepted_kpos = cand_kpos[accepted]

    # --- execute (dccrg.hpp:10243-10693) -------------------------------
    refined_idx = np.nonzero(refine_flag)[0]
    refined_parents = cells[refined_idx]
    children = (
        mapping.get_all_children(refined_parents).reshape(-1)
        if len(refined_idx)
        else np.empty(0, np.uint64)
    )
    child_owner = np.repeat(owner[refined_idx], 8) if len(refined_idx) else np.empty(0, np.int32)

    if len(accepted_parents):
        removed = mapping.get_all_children(accepted_parents).reshape(-1)
        new_parents = accepted_parents
        # parent owned by owner of first child (dccrg.hpp:10437)
        new_parent_owner = owner[accepted_kpos[:, 0]].astype(np.int32)
    else:
        removed = np.empty(0, np.uint64)
        new_parents = np.empty(0, np.uint64)
        new_parent_owner = np.empty(0, np.int32)

    # assemble the new cell list
    drop = np.zeros(n, dtype=bool)
    drop[refined_idx] = True
    drop[np.searchsorted(cells, removed)] = True
    keep_cells = cells[~drop]
    keep_owner = owner[~drop]
    new_cells_all = np.concatenate([keep_cells, children, new_parents])
    new_owner_all = np.concatenate([keep_owner, child_owner, new_parent_owner])
    order = np.argsort(new_cells_all, kind="stable")

    # inherit pins and weights (dccrg.hpp:10379-10399)
    if pins is not None:
        for p, ch in zip(refined_parents, np.reshape(children, (-1, 8)) if len(children) else []):
            if int(p) in pins:
                dest = pins.pop(int(p))
                for k in ch:
                    pins[int(k)] = dest
        for parent, kids0 in zip(new_parents, removed.reshape(-1, 8) if len(removed) else []):
            for k in kids0:
                pins.pop(int(k), None)
    if weights is not None:
        for p, ch in zip(refined_parents, np.reshape(children, (-1, 8)) if len(children) else []):
            if int(p) in weights:
                w = weights.pop(int(p))
                for k in ch:
                    weights[int(k)] = w
        for kids0 in removed.reshape(-1, 8) if len(removed) else []:
            for k in kids0:
                weights.pop(int(k), None)

    # the pins/weights dicts were just changed in place (inheritance);
    # the port has no transaction to restore them on a fault here
    faults.fire("adapt.resolve", phase="pins")

    return AmrResult(
        cells=new_cells_all[order],
        owner=new_owner_all[order],
        new_cells=np.sort(children),
        removed_cells=np.sort(removed),
        refined_parents=np.sort(refined_parents),
        unrefined_parents=np.sort(new_parents),
    )


def frontier_induced_refines(
    mapping: Mapping,
    cells: np.ndarray,
    owner: np.ndarray,
    offsets: np.ndarray,
    refines: set,
    local_devs,
    topology=None,
) -> np.ndarray:
    """The FIRST induction wave a rank's local refines push across its
    ownership boundary: every refinable coarser neighbor of a directly
    requested refine that is NOT owned by ``local_devs``.

    This is the partial-view half of the distributed commit
    (dccrg_tpu/distamr.py): each rank declares this wave in its sealed
    proposal, computed from nothing but its OWN request set and the
    replicated structure. Because the wave depends only on (requests,
    structure), every peer can recompute it from the proposal against
    its own replicated structure — a mismatch convicts the proposer of
    resolving against a DIFFERENT structure epoch (a zombie whose plan
    is stale, a torn-but-CRC-passing payload) before any merge
    happens. It is deliberately ONE wave, not the fixpoint: the merged
    :func:`resolve_adaptation` runs the real fixpoint over the union
    of requests, and its digest is what the ranks compare at the
    resolve barrier; the frontier is the per-proposal integrity check
    that makes a bad proposal fail CLOSED at collect time."""
    n = len(cells)
    if topology is None:
        topology = GridTopology((False, False, False))
    lvl = mapping.get_refinement_level(cells)

    flag = np.zeros(n, dtype=bool)
    if refines:
        ids = np.fromiter((int(c) for c in refines), dtype=np.uint64,
                          count=len(refines))
        pos = np.minimum(np.searchsorted(cells, ids), n - 1)
        pos = pos[cells[pos] == ids].astype(np.int64)
        flag[pos[lvl[pos] < mapping.max_refinement_level]] = True
    if not flag.any():
        return np.empty(0, dtype=np.uint64)

    edges = _FrontierEdges(mapping, topology, cells, offsets)
    edges.expand(flag)
    m = flag[edges.src] & (lvl[edges.nbr] < lvl[edges.src])
    cand = np.zeros(n, dtype=bool)
    cand[edges.nbr[m]] = True
    cand &= ~flag & (lvl < mapping.max_refinement_level)
    local = np.isin(owner, np.asarray(sorted(int(d) for d in local_devs),
                                      dtype=np.asarray(owner).dtype))
    return np.sort(cells[cand & ~local].astype(np.uint64))
