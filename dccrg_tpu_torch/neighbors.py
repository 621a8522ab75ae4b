"""Neighborhood definitions and level-0 neighbor lists.

The default neighborhood offsets and the user-neighborhood validation of
the reference (dccrg.hpp:8017-8076, :6573-6606). A neighborhood is a
list of integer offset triples in units of a cell's own edge length.
The AMR neighbor engine (``find_neighbors_of`` and friends) is not part
of the single-device uniform slice: on an all-level-0 grid every
neighborhood item resolves to the same-level cell at ``ijk + offset``
(periodic wrap, absent across a non-periodic edge), so
``build_neighbor_lists`` computes the flat lists arithmetically, in the
reference's entry order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
    neighbors, so nothing is deduplicated. Any other cell set raises
    ``NotImplementedError`` (refined grids belong to the AMR slice)."""
    cells = np.asarray(all_cells_sorted, dtype=np.uint64)
    dims = tuple(int(v) for v in mapping.length.get())
    nx, ny, nz = dims
    n0 = nx * ny * nz
    if len(cells) != n0 or (n0 and int(cells[-1]) != n0):
        raise NotImplementedError(
            "neighbor lists of refined grids are not ported (level 0 only)")
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
    # invert: v in neighbors_of(c) with offset o  =>  c in neighbors_to(v)
    # with offset -o (displacement of c's min corner from v's)
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
