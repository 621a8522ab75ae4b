"""Cell-to-device partitioning: the Zoltan replacement.

Counterpart of ``dccrg_tpu/partition.py``; owners come out bit for bit
the reference's. The original library delegates partitioning to Zoltan (RCB / RIB / HSFC /
graph / hypergraph, dccrg.hpp:8482-8720) plus optional Hilbert-SFC
initial placement (dccrg.hpp:8147-8220). Here the partition maps
cells to the grid's partitions; the methods are:

- ``block``  — contiguous equal-count ranges of cell-id order (the
  reference's default initial placement, dccrg.hpp:8089-8146),
- ``morton`` / ``hilbert`` — space-filling-curve order for locality
  (the HSFC/USE_SFC equivalent; Hilbert via the classic transpose
  algorithm),
- ``rcb`` — recursive coordinate bisection (Zoltan RCB),
- ``cut`` — connectivity-aware: RCB boxes refined by a greedy
  majority-neighbor sweep over the real neighbor edges (the role of
  Zoltan PHG's ``PHG_CUT_OBJECTIVE=CONNECTIVITY``, the reference's
  hierarchical default, dccrg.hpp:7834-7842),
- optional per-cell weights (``set_cell_weight`` semantics,
  dccrg.hpp:6318-6380): cuts equalize total weight instead of count,
- pin requests (``pin()`` semantics, dccrg.hpp:5913-6139): forced
  placements applied after the automatic partition.

All functions are host-side numpy; they run at structure-change events
only.
"""

from __future__ import annotations

import numpy as np

from . import faults
from .mapping import Mapping

PARTITION_METHODS = ("block", "morton", "hilbert", "rcb", "cut")


def refine_cut(owner, w, src, dst, n_parts, rounds=8, tol=1.1):
    """Greedy connectivity refinement (the role of Zoltan PHG's
    ``PHG_CUT_OBJECTIVE=CONNECTIVITY``, the reference's hierarchical
    default, dccrg.hpp:7834-7842): sweep cells whose neighbors are
    majority-remote to the device owning the majority, highest gain
    first, while every destination stays under ``tol`` x the balanced
    load; a source whose load has fallen to the ``(2 - tol)`` x floor
    stops being pulled from (loads update between destination sweeps,
    so the floor is respected to within one destination's headroom).
    ``src``/``dst`` are cell positions of the neighbor edges (both
    directions counted as given). Each sweep is vectorized over the
    boundary set only — O(cut surface x n_parts) memory, never
    O(grid x n_parts)."""
    owner = np.asarray(owner, dtype=np.int32).copy()
    n = len(owner)
    if n == 0 or len(src) == 0 or n_parts == 1:
        return owner
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    w = np.asarray(w, dtype=np.float64)
    target = w.sum() / n_parts
    hi_cap, lo_cap = target * tol, target * (2.0 - tol)
    for _ in range(rounds):
        # only cells with at least one cross-part edge can gain: the
        # per-part neighbor counts are built over that boundary set, so
        # memory is O(cut surface x n_parts), never O(grid x n_parts)
        cross = owner[src] != owner[dst]
        comp = np.full(n, -1, dtype=np.int64)
        cidx = np.unique(src[cross])
        if len(cidx) == 0:
            break
        comp[cidx] = np.arange(len(cidx))
        esel = comp[src] >= 0
        cm = np.bincount(
            comp[src[esel]] * n_parts + owner[dst[esel]],
            minlength=len(cidx) * n_parts,
        ).reshape(len(cidx), n_parts)
        ar = np.arange(len(cidx))
        best = np.argmax(cm, axis=1).astype(np.int32)
        gain = cm[ar, best] - cm[ar, owner[cidx]]
        load = np.bincount(owner, weights=w, minlength=n_parts)
        keep = (gain > 0) & (best != owner[cidx])
        cand = cidx[keep]
        cbest = best[keep]
        cgain = gain[keep]
        if len(cand) == 0:
            break
        order = np.argsort(-cgain, kind="stable")
        cand, cbest = cand[order], cbest[order]
        moved = 0
        for d in range(n_parts):
            sel = cand[cbest == d]
            if len(sel) == 0:
                continue
            # loads are updated between destinations, so a source
            # pulled from by several destinations in one sweep still
            # respects the (2 - tol) floor
            sel = sel[load[owner[sel]] > lo_cap]
            room = hi_cap - load[d]
            if room <= 0 or len(sel) == 0:
                continue
            take = sel[: np.searchsorted(np.cumsum(w[sel]), room, "right")]
            if len(take):
                np.subtract.at(load, owner[take], w[take])
                load[d] += w[take].sum()
                owner[take] = d
                moved += len(take)
        if moved == 0:
            break
    return _swap_pass(owner, w, src, dst, n_parts, hi_cap, lo_cap)


def _swap_pass(owner, w, src, dst, n_parts, hi_cap, lo_cap, rounds=4,
               max_swaps=50000):
    """KL-style boundary exchange after the greedy sweep (the tail of
    Zoltan PHG's refinement, dccrg.hpp:7834-7842): the greedy pass only
    MOVES cells with strict-majority gain, so tied boundaries — e.g. a
    jagged interface where each cell individually gains nothing — stay
    put. Swapping a cross-edge PAIR (a in p, b in q -> a in q, b in p)
    keeps loads balanced to |w[b] - w[a]| and can still reduce the cut:
    pair gain = gain(a->q) + gain(b->p) - 2 x (a,b multiplicity), the
    classic Kernighan-Lin correction. Gains are exact at the start of
    each round; within a round a used-mask keeps swapped cells (whose
    neighbors' gains went stale) from moving twice, and a round that
    fails to reduce the total cut is reverted, so the pass can never
    hand back a worse partition."""
    n = len(owner)
    if n == 0 or len(src) == 0 or n_parts == 1:
        return owner
    for _ in range(rounds):
        cross = owner[src] != owner[dst]
        cut_before = int(cross.sum())
        if cut_before == 0:
            break
        comp = np.full(n, -1, dtype=np.int64)
        cidx = np.unique(src[cross])  # both directions present
        comp[cidx] = np.arange(len(cidx))
        esel = comp[src] >= 0
        cm = np.bincount(
            comp[src[esel]] * n_parts + owner[dst[esel]],
            minlength=len(cidx) * n_parts,
        ).reshape(len(cidx), n_parts)
        # undirected cross pairs with (directed) multiplicity
        a, b = src[cross], dst[cross]
        key = np.minimum(a, b) * n + np.maximum(a, b)
        uk, mult = np.unique(key, return_counts=True)
        ua, ub = uk // n, uk % n
        m_dir = mult // 2  # each undirected adjacency is listed twice
        p, q = owner[ua], owner[ub]
        g = ((cm[comp[ua], q] - cm[comp[ua], p])
             + (cm[comp[ub], p] - cm[comp[ub], q])
             - 2 * m_dir)
        sel = g > 0
        if not sel.any():
            break
        ua, ub, g = ua[sel], ub[sel], g[sel]
        order = np.argsort(-g, kind="stable")[:max_swaps]
        prev_owner = owner.copy()
        load = np.bincount(owner, weights=w, minlength=n_parts)
        used = np.zeros(n, dtype=bool)
        swapped = 0
        for i in order:
            A, B = ua[i], ub[i]
            if used[A] or used[B]:
                continue
            pp, qq = owner[A], owner[B]
            if pp == qq:
                continue
            dl = w[B] - w[A]
            # equal-weight swaps never change the balance, so they are
            # legal even when a load already sits outside the band
            if dl != 0 and not (lo_cap <= load[pp] + dl <= hi_cap
                                and lo_cap <= load[qq] - dl <= hi_cap):
                continue
            owner[A], owner[B] = qq, pp
            load[pp] += dl
            load[qq] -= dl
            used[A] = used[B] = True
            swapped += 1
        if swapped == 0:
            break
        if int((owner[src] != owner[dst]).sum()) >= cut_before:
            # stale-gain conflicts made the round a wash: revert
            owner = prev_owner
            break
    return owner


def _index_centers(mapping: Mapping, cells: np.ndarray) -> np.ndarray:
    """Cell centers in smallest-cell index units (geometry-free: RCB
    cuts in index space, which is affine to any of the geometries'
    physical space per dimension)."""
    idx = np.atleast_2d(mapping.get_indices(np.asarray(cells, dtype=np.uint64)))
    size = np.atleast_1d(mapping.get_cell_length_in_indices(np.asarray(cells, dtype=np.uint64)))
    return idx.astype(np.float64) + size.astype(np.float64)[:, None] / 2


def _rcb_assign(centers: np.ndarray, shares, w: np.ndarray):
    """Recursive coordinate bisection (Zoltan's RCB, the cut-minimizing
    geometric partitioner the reference exposes via LB_METHOD=RCB,
    dccrg.hpp:5629-5880): recursively split at the weighted median of
    the widest extent, producing compact boxes whose surface — the
    halo traffic — stays near-minimal on refined grids too.

    Returns the part index (into ``shares``) per row of ``centers``."""
    out = np.zeros(len(centers), dtype=np.int64)
    shares = np.asarray(shares, dtype=np.float64)

    def rec(sel, lo, hi):
        if hi - lo == 1 or len(sel) == 0:
            out[sel] = lo
            return
        mid = (lo + hi) // 2
        span = shares[lo:hi].sum()
        frac = shares[lo:mid].sum() / span if span > 0 else 0.5
        c = centers[sel]
        d = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, d], kind="stable")
        ww = w[sel][order]
        if ww.sum() <= 0:
            ww = np.ones(len(ww), dtype=np.float64)
        cum = np.cumsum(ww)
        k = int(np.searchsorted(cum - ww / 2, frac * cum[-1], side="left"))
        rec(sel[order[:k]], lo, mid)
        rec(sel[order[k:]], mid, hi)

    rec(np.arange(len(centers)), 0, len(shares))
    return out


def morton_key(mapping: Mapping, cells: np.ndarray) -> np.ndarray:
    """Morton (z-order) key of each cell's min corner, bit-interleaved
    at smallest-cell resolution. Keys of nested cells sort adjacently,
    so contiguous key ranges are compact blocks."""
    idx = np.atleast_2d(mapping.get_indices(np.asarray(cells, dtype=np.uint64)))
    bits = max(int(x).bit_length() for x in mapping.get_index_length())
    if 3 * bits > 63:
        raise ValueError("grid too large for 63-bit Morton keys")
    from . import native

    if native.lib() is not None:
        return native.sfc_keys(idx, bits, "morton")
    key = np.zeros(len(idx), dtype=np.uint64)
    for b in range(bits):
        for d in range(3):
            key |= ((idx[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + d)
    return key


def hilbert_key(mapping: Mapping, cells: np.ndarray) -> np.ndarray:
    """Hilbert-curve key of each cell's min corner (3-D, transpose
    algorithm), the locality-preserving order the reference gets from
    the optional sfc++ library (dccrg.hpp:62-64, 8147-8220)."""
    idx = np.atleast_2d(mapping.get_indices(np.asarray(cells, dtype=np.uint64))).astype(np.uint64)
    bits = max(int(x).bit_length() for x in mapping.get_index_length())
    if 3 * bits > 63:
        raise ValueError("grid too large for 63-bit Hilbert keys")
    from . import native

    if native.lib() is not None:
        return native.sfc_keys(idx, bits, "hilbert")
    x = idx.copy()  # [n, 3] "transpose" form, modified in place
    n = np.uint64(1) << np.uint64(bits)
    # Gray-decode: inverse undo excess work (Skilling's algorithm)
    m = n >> np.uint64(1)
    q = np.uint64(m)
    while q > 1:
        p = np.uint64(q - 1)
        for i in range(3):
            has = (x[:, i] & q) != 0
            # invert low bits of x[0] where bit set
            x[:, 0] = np.where(has, x[:, 0] ^ p, x[:, 0])
            # exchange low bits of x[i] and x[0] where bit unset
            tt = np.where(~has, (x[:, 0] ^ x[:, i]) & p, np.uint64(0))
            x[:, 0] ^= tt
            x[:, i] ^= tt
        q >>= np.uint64(1)
    # Gray encode
    for i in range(1, 3):
        x[:, i] ^= x[:, i - 1]
    t = np.zeros(len(x), dtype=np.uint64)
    q = np.uint64(m)
    while q > 1:
        has = (x[:, 2] & q) != 0
        t = np.where(has, t ^ np.uint64(q - 1), t)
        q >>= np.uint64(1)
    for i in range(3):
        x[:, i] ^= t
    # interleave transpose-form coordinates into the key (MSB first,
    # dimension 0 contributes the highest bit of each group)
    key = np.zeros(len(x), dtype=np.uint64)
    for b in range(bits - 1, -1, -1):
        for d in range(3):
            key = (key << np.uint64(1)) | ((x[:, d] >> np.uint64(b)) & np.uint64(1))
    return key


def _split_by_weight(order, w, shares):
    """Cut ``order`` (cell positions in curve order) into len(shares)
    contiguous runs with cumulative weight proportional to ``shares``
    (device counts per part). Returns the part index per position in
    ``order``."""
    n = len(order)
    part = np.zeros(n, dtype=np.int64)
    if n == 0 or len(shares) <= 1:
        return part
    wo = w[order]
    if wo.sum() <= 0:  # all-zero weights: fall back to equal counts
        wo = np.ones(n, dtype=np.float64)
    cum = np.cumsum(wo)
    total = cum[-1]
    bounds = np.cumsum(np.asarray(shares, dtype=np.float64))
    bounds = bounds / bounds[-1] * max(total, 1e-300)
    mid = cum - wo / 2
    part = np.searchsorted(bounds, mid, side="right")
    return np.minimum(part, len(shares) - 1)


def partition_cells_hierarchical(
    mapping: Mapping,
    cells: np.ndarray,
    n_parts: int,
    levels,
    weights: np.ndarray | None = None,
    pins: dict | None = None,
    edges=None,
) -> np.ndarray:
    """Hierarchical partition (Zoltan hierarchical replacement,
    dccrg.hpp:5629-5880): each level splits every current device group
    into sub-groups of ``processes`` devices using that level's curve
    method. A natural hierarchy is (host, card): e.g. levels
    ``[{"processes": 4, "method": "block"}, {"processes": 1, "method":
    "hilbert"}]`` first cuts coarse blocks across hosts, then
    Hilbert-orders within each host's cards.

    ``levels``: list of dicts with keys ``processes`` (devices per part
    after this level's split) and optional ``method``.
    """
    cells = np.asarray(cells, dtype=np.uint64)
    n = len(cells)
    if weights is None:
        w = np.ones(n, dtype=np.float64)
    else:
        w = np.asarray(weights, dtype=np.float64)

    # groups: list of (device_lo, device_hi, cell positions array)
    groups = [(0, n_parts, np.arange(n))]
    plan_levels = [dict(lv) for lv in levels]
    if not plan_levels or int(plan_levels[-1].get("processes", 1)) != 1:
        plan_levels.append({"processes": 1})  # finish at single devices

    for lv in plan_levels:
        per = max(1, int(lv.get("processes", 1)))
        method = lv.get("method", "morton")
        if method not in PARTITION_METHODS:
            raise ValueError(f"unknown partition method {method!r}")
        next_groups = []
        for lo, hi, pos in groups:
            span = hi - lo
            if span <= per:
                next_groups.append((lo, hi, pos))
                continue
            shares = [per] * (span // per) + ([span % per] if span % per else [])
            sub = cells[pos]
            if method in ("rcb", "cut"):
                assign = _rcb_assign(_index_centers(mapping, sub), shares, w[pos])
                if (method == "cut" and edges is not None and len(pos) > 1
                        and len(set(shares)) == 1):
                    # refine within this group over the edges whose
                    # both endpoints belong to it (local positions via
                    # the sorted group index); refine_cut balances to
                    # equal targets, so only equal device shares refine
                    sp = np.sort(pos)
                    at = np.searchsorted(sp, pos)
                    loc_s = np.searchsorted(sp, edges[0])
                    loc_d = np.searchsorted(sp, edges[1])
                    loc_s_c = np.minimum(loc_s, len(sp) - 1)
                    loc_d_c = np.minimum(loc_d, len(sp) - 1)
                    m = (sp[loc_s_c] == edges[0]) & (sp[loc_d_c] == edges[1])
                    a_sorted = np.empty(len(sp), dtype=np.int32)
                    a_sorted[at] = assign.astype(np.int32)
                    refined = refine_cut(a_sorted, w[sp], loc_s_c[m],
                                         loc_d_c[m], len(shares))
                    assign = refined[at]
                parts = [pos[assign == pi] for pi in range(len(shares))]
            else:
                if method == "block":
                    curve = np.argsort(sub, kind="stable")
                elif method == "morton":
                    curve = np.argsort(morton_key(mapping, sub), kind="stable")
                else:
                    curve = np.argsort(hilbert_key(mapping, sub), kind="stable")
                part_in_order = _split_by_weight(pos[curve], w, shares)
                parts = [pos[curve[part_in_order == pi]] for pi in range(len(shares))]
            dev_lo = lo
            for pi, share in enumerate(shares):
                next_groups.append((dev_lo, dev_lo + share, parts[pi]))
                dev_lo += share
        groups = next_groups

    owner = np.empty(n, dtype=np.int32)
    for lo, hi, pos in groups:
        owner[pos] = lo  # hi == lo + 1 after the final level
    if pins:
        for cid, dest in pins.items():
            p = np.searchsorted(cells, np.uint64(cid))
            if p < n and cells[p] == np.uint64(cid):
                if not 0 <= int(dest) < n_parts:
                    raise ValueError(f"pin of cell {cid} to invalid device {dest}")
                owner[p] = int(dest)
    return owner


def partition_cells(
    mapping: Mapping,
    cells: np.ndarray,
    n_parts: int,
    method: str = "morton",
    weights: np.ndarray | None = None,
    pins: dict | None = None,
    edges=None,
) -> np.ndarray:
    """Owner (device index) for each cell.

    Contiguous ranges in the chosen order, cut at equal cumulative
    weight; ``pins`` (cell id -> device) override afterwards, matching
    the reference's pin-after-Zoltan merge (dccrg.hpp:8552-8576).

    ``method="cut"`` is the connectivity-aware option (Zoltan
    graph/hypergraph role): RCB compact boxes refined by
    :func:`refine_cut` over the neighbor ``edges`` — a ``(src_pos,
    dst_pos)`` pair of cell-position arrays, supplied by the grid from
    its existing neighbor lists at balance time. Without edges (fresh
    initialize, before any neighbor engine ran) it degrades to plain
    RCB.
    """
    cells = np.asarray(cells, dtype=np.uint64)
    n = len(cells)
    if method not in PARTITION_METHODS:
        raise ValueError(f"unknown partition method {method!r}, have {PARTITION_METHODS}")
    faults.fire("partition.compute", mode=method)

    if weights is not None:
        w = np.asarray(weights, dtype=np.float64)
        if w.shape != (n,):
            raise ValueError(f"weights must have shape ({n},), got {w.shape}")
        if np.any(w < 0):
            raise ValueError("cell weights must be >= 0")

    if n_parts == 1:
        return np.zeros(n, dtype=np.int32)  # nothing to order or cut
    if weights is None:
        w = np.ones(n, dtype=np.float64)

    if method in ("rcb", "cut"):
        centers = _index_centers(mapping, cells)
        owner = _rcb_assign(centers, [1] * n_parts, w).astype(np.int32)
        if method == "cut" and edges is not None:
            owner = refine_cut(owner, w, edges[0], edges[1], n_parts)
    else:
        if method == "block":
            order = np.arange(n)
        elif method == "morton":
            order = np.argsort(morton_key(mapping, cells), kind="stable")
        else:
            order = np.argsort(hilbert_key(mapping, cells), kind="stable")

        cum = np.cumsum(w[order])
        total = cum[-1] if n else 0.0
        owner_in_order = (
            np.minimum((cum - w[order] / 2) / max(total, 1e-300) * n_parts, n_parts - 1)
        ).astype(np.int32) if n else np.empty(0, np.int32)
        owner = np.empty(n, dtype=np.int32)
        owner[order] = owner_in_order

    if pins:
        pin_ids = np.array(sorted(pins.keys()), dtype=np.uint64)
        pos = np.searchsorted(cells, pin_ids)
        ok = (pos < n) & (cells[np.minimum(pos, n - 1)] == pin_ids)
        for pid, p in zip(pin_ids[ok], pos[ok]):
            dest = int(pins[int(pid)])
            if not 0 <= dest < n_parts:
                raise ValueError(f"pin of cell {pid} to invalid device {dest}")
            owner[p] = dest
    return owner
