"""Cell id <-> (refinement level, indices) mapping.

Re-implements the reference's AMR addressing scheme (dccrg_mapping.hpp)
with bit-for-bit id parity, but vectorized over numpy arrays instead of
per-cell scalar calls:

- Cell ids are 1-based and enumerated level-by-level: all level-0 cells
  first (x-fastest over the level-0 index box), then ``8x`` as many
  level-1 slots, and so on (dccrg_mapping.hpp:154-209).
- Indices are measured in units of the *smallest possible* cell, i.e. a
  cell at refinement level ``l`` occupies ``2**(max_ref_lvl - l)``
  index units per dimension (dccrg_mapping.hpp:218-254).
- Children of a cell are enumerated in z-order with x fastest
  (dccrg_mapping.hpp:392-442).

Every query accepts scalars or arrays and broadcasts; invalid inputs map
to ERROR_CELL / ERROR_INDEX / level -1 rather than raising, matching the
reference's error-value convention.
"""

from __future__ import annotations

import numpy as np

from .length import GridLength
from .types import ERROR_CELL, ERROR_INDEX, as_cell_array, as_index_array

_U1 = np.uint64(1)
# 1-D batches at least this long go to the native engine (below it the
# call overhead outweighs the win), as the reference dispatches them
_NATIVE_BATCH = 4096


class Mapping:
    """Grid addressing: 64-bit cell ids under octree refinement.

    Parameters mirror the reference ``Mapping`` (dccrg_mapping.hpp:55):
    level-0 extents (``GridLength``) plus a maximum refinement level.
    """

    def __init__(self, length=(1, 1, 1), maximum_refinement_level: int = 0):
        self.length = GridLength(length)
        self.max_refinement_level = 0
        self._update_tables()
        if maximum_refinement_level != 0:
            if not self.set_maximum_refinement_level(maximum_refinement_level):
                raise ValueError(
                    f"maximum refinement level {maximum_refinement_level} not "
                    f"possible for grid of length {length}"
                )

    # ------------------------------------------------------------------
    # configuration

    def set_length(self, length) -> bool:
        old = tuple(int(v) for v in self.length.get())
        try:
            self.length.set(length)
        except (ValueError, OverflowError):
            return False
        # the current max refinement level must remain representable
        if self.max_refinement_level > self.get_maximum_possible_refinement_level():
            self.length.set(old)
            return False
        self._update_tables()
        return True

    def get_maximum_possible_refinement_level(self) -> int:
        """Largest max_ref_lvl whose cumulative id range fits uint64.

        Exact-integer version of dccrg_mapping.hpp:317-330.
        """
        gl = self.length.total_level0_cells
        level = 0
        total = 0
        while True:
            total += gl * 8**level
            if total > 2**64 - 1:
                return level - 1
            level += 1

    def set_maximum_refinement_level(self, level: int) -> bool:
        """Set max refinement level (0 = unrefined). Invalidates old ids."""
        if level < 0 or level > self.get_maximum_possible_refinement_level():
            return False
        self.max_refinement_level = int(level)
        self._update_tables()
        return True

    def get_maximum_refinement_level(self) -> int:
        return self.max_refinement_level

    def _update_tables(self) -> None:
        """Precompute per-level id offsets and index scales."""
        gl = self.length.total_level0_cells
        nlvl = self.max_refinement_level + 1
        # first id of each level, 1-based (exact Python ints; validated
        # to fit uint64 by get_maximum_possible_refinement_level)
        firsts, acc = [], 1
        for l in range(nlvl):
            firsts.append(acc)
            acc += gl * 8**l
        self._level_first = np.array(firsts, dtype=np.uint64)  # [nlvl]
        self.last_cell = np.uint64(acc - 1)
        # grid extents in units of smallest cells
        self._index_length = self.length.get() * (_U1 << np.uint64(self.max_refinement_level))

    # ------------------------------------------------------------------
    # queries (all vectorized; scalars in -> scalars out)

    def get_last_cell(self):
        return self.last_cell

    def get_index_length(self) -> np.ndarray:
        """Grid extents measured in smallest-cell index units."""
        return self._index_length.copy()

    def get_refinement_level(self, cells):
        """Refinement level of each cell; -1 for invalid ids.

        Vectorized replacement for the reference's linear scan over
        level ranges (dccrg_mapping.hpp:262-290).
        """
        scalar = np.isscalar(cells) or np.asarray(cells).ndim == 0
        cells = as_cell_array(cells)
        if cells.ndim == 1 and len(cells) >= _NATIVE_BATCH:
            from . import native

            if native.lib() is not None:
                return native.refinement_levels(self, cells)
        # level = number of level-firsts <= cell, minus 1
        lvl = np.searchsorted(self._level_first, cells, side="right").astype(np.int64) - 1
        lvl[(cells == ERROR_CELL) | (cells > self.last_cell)] = -1
        return int(lvl[0]) if scalar else lvl

    def get_cell_from_indices(self, indices, refinement_level):
        """Cell id of given refinement level at given indices.

        Parity with dccrg_mapping.hpp:154-209; ERROR_CELL for any index
        outside the grid or invalid level.
        """
        indices = as_index_array(indices)
        scalar = indices.ndim == 1
        indices = np.atleast_2d(indices)
        lvl = np.broadcast_to(
            np.asarray(refinement_level, dtype=np.int64), indices.shape[:-1]
        ).copy()

        bad = (lvl < 0) | (lvl > self.max_refinement_level)
        bad |= np.any(indices >= self._index_length, axis=-1)
        lvl_safe = np.where(bad, 0, lvl)

        # indices at the cell's own refinement level
        shift = (self.max_refinement_level - lvl_safe).astype(np.uint64)
        own = indices >> shift[..., None]
        L = self.length.get()
        lx = L[0] << lvl_safe.astype(np.uint64)
        ly = L[1] << lvl_safe.astype(np.uint64)
        cell = (
            self._level_first[lvl_safe]
            + own[..., 0]
            + own[..., 1] * lx
            + own[..., 2] * lx * ly
        ).astype(np.uint64)
        cell[bad] = ERROR_CELL
        return np.uint64(cell[0]) if scalar else cell

    def get_indices(self, cells):
        """(..., 3) indices of each cell, in smallest-cell units.

        Parity with dccrg_mapping.hpp:218-254; ERROR_INDEX rows for
        invalid ids.
        """
        scalar = np.isscalar(cells) or np.asarray(cells).ndim == 0
        cells = as_cell_array(cells)
        if cells.ndim == 1 and len(cells) >= _NATIVE_BATCH:
            from . import native

            if native.lib() is not None:
                return native.cell_indices(self, cells)
        lvl = np.atleast_1d(np.asarray(self.get_refinement_level(cells), dtype=np.int64))
        bad = lvl < 0
        lvl_safe = np.where(bad, 0, lvl)
        within = cells - self._level_first[lvl_safe]  # 0-based rank inside its level
        L = self.length.get()
        lx = (L[0] << lvl_safe.astype(np.uint64)).astype(np.uint64)
        ly = (L[1] << lvl_safe.astype(np.uint64)).astype(np.uint64)
        shift = (self.max_refinement_level - lvl_safe).astype(np.uint64)
        out = np.empty(cells.shape + (3,), dtype=np.uint64)
        out[..., 0] = (within % lx) << shift
        out[..., 1] = ((within // lx) % ly) << shift
        out[..., 2] = (within // (lx * ly)) << shift
        out[bad] = ERROR_INDEX
        return out[0] if scalar else out

    def get_cell_length_in_indices(self, cells):
        """Edge length of each cell in smallest-cell index units."""
        scalar = np.isscalar(cells) or np.asarray(cells).ndim == 0
        cells = as_cell_array(cells)
        lvl = np.atleast_1d(np.asarray(self.get_refinement_level(cells), dtype=np.int64))
        out = np.where(
            lvl < 0, ERROR_INDEX, _U1 << (self.max_refinement_level - np.where(lvl < 0, 0, lvl)).astype(np.uint64)
        ).astype(np.uint64)
        return np.uint64(out[0]) if scalar else out

    # ------------------------------------------------------------------
    # parent / child navigation (dccrg_mapping.hpp:339-496)

    def get_child(self, cells):
        """First (z-order) child; the cell itself at max level; ERROR_CELL if invalid."""
        scalar = np.isscalar(cells) or np.asarray(cells).ndim == 0
        cells = as_cell_array(cells)
        lvl = np.atleast_1d(np.asarray(self.get_refinement_level(cells), dtype=np.int64))
        out = np.where(lvl < 0, ERROR_CELL, cells).astype(np.uint64)
        can = (lvl >= 0) & (lvl < self.max_refinement_level)
        if np.any(can):
            idx = np.atleast_2d(self.get_indices(cells[can]))
            out[can] = np.atleast_1d(self.get_cell_from_indices(idx, lvl[can] + 1))
        return np.uint64(out[0]) if scalar else out

    def get_parent(self, cells):
        """Parent cell; the cell itself at level 0; ERROR_CELL if invalid."""
        scalar = np.isscalar(cells) or np.asarray(cells).ndim == 0
        cells = as_cell_array(cells)
        lvl = np.atleast_1d(np.asarray(self.get_refinement_level(cells), dtype=np.int64))
        out = np.where(lvl < 0, ERROR_CELL, cells).astype(np.uint64)
        has = lvl > 0
        if np.any(has):
            idx = np.atleast_2d(self.get_indices(cells[has]))
            out[has] = np.atleast_1d(self.get_cell_from_indices(idx, lvl[has] - 1))
        return np.uint64(out[0]) if scalar else out

    def get_level_0_parent(self, cells):
        scalar = np.isscalar(cells) or np.asarray(cells).ndim == 0
        cells = as_cell_array(cells)
        lvl = np.atleast_1d(np.asarray(self.get_refinement_level(cells), dtype=np.int64))
        out = np.where(lvl < 0, ERROR_CELL, cells).astype(np.uint64)
        has = lvl > 0
        if np.any(has):
            idx = np.atleast_2d(self.get_indices(cells[has]))
            out[has] = np.atleast_1d(self.get_cell_from_indices(idx, 0))
        return np.uint64(out[0]) if scalar else out

    def get_all_children(self, cells):
        """(..., 8) children in z-order (x fastest); ERROR_CELL rows when
        the cell is at max level or invalid (dccrg_mapping.hpp:392-442)."""
        scalar = np.isscalar(cells) or np.asarray(cells).ndim == 0
        cells = as_cell_array(cells)
        lvl = np.atleast_1d(np.asarray(self.get_refinement_level(cells), dtype=np.int64))
        out = np.full(cells.shape + (8,), ERROR_CELL, dtype=np.uint64)
        can = (lvl >= 0) & (lvl < self.max_refinement_level)
        if np.any(can):
            sub = cells[can]
            sub_lvl = lvl[can] + 1
            base = np.atleast_2d(self.get_indices(sub))  # [n, 3]
            off = (_U1 << (self.max_refinement_level - sub_lvl).astype(np.uint64)).astype(np.uint64)
            # z-order: child k has offsets (k&1, (k>>1)&1, (k>>2)&1)
            k = np.arange(8, dtype=np.uint64)
            dx = (k & _U1)[None, :] * off[:, None]
            dy = ((k >> _U1) & _U1)[None, :] * off[:, None]
            dz = ((k >> np.uint64(2)) & _U1)[None, :] * off[:, None]
            child_idx = np.stack(
                [base[:, 0:1] + dx, base[:, 1:2] + dy, base[:, 2:3] + dz], axis=-1
            )  # [n, 8, 3]
            out[can] = self.get_cell_from_indices(
                child_idx.reshape(-1, 3), np.repeat(sub_lvl, 8)
            ).reshape(-1, 8)
        return out[0] if scalar else out

    def get_siblings(self, cells):
        """(..., 8) the cell's sibling group (all children of its parent);
        for level-0 cells: [cell, ERROR_CELL x 7] (dccrg_mapping.hpp:450)."""
        scalar = np.isscalar(cells) or np.asarray(cells).ndim == 0
        cells = as_cell_array(cells)
        lvl = np.atleast_1d(np.asarray(self.get_refinement_level(cells), dtype=np.int64))
        out = np.full(cells.shape + (8,), ERROR_CELL, dtype=np.uint64)
        lvl0 = lvl == 0
        out[lvl0, 0] = cells[lvl0]
        deeper = lvl > 0
        if np.any(deeper):
            out[deeper] = self.get_all_children(self.get_parent(cells[deeper]))
        return out[0] if scalar else out

    # ------------------------------------------------------------------
    # file format (reference: dccrg_mapping.hpp:516-652)
    # Record: 3 x uint64 level-0 lengths + 1 x int32 max_ref_lvl.

    def data_size(self) -> int:
        return 3 * 8 + 4

    def to_bytes(self) -> bytes:
        return self.length.get().tobytes() + np.int32(self.max_refinement_level).tobytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Mapping":
        if len(data) != 28:
            raise ValueError(f"mapping record must be 28 bytes, got {len(data)}")
        length = np.frombuffer(data[:24], dtype=np.uint64)
        max_lvl = int(np.frombuffer(data[24:], dtype=np.int32)[0])
        return cls(tuple(int(v) for v in length), max_lvl)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Mapping)
            and self.length == other.length
            and self.max_refinement_level == other.max_refinement_level
        )

    def __repr__(self) -> str:
        return (
            f"Mapping(length={tuple(int(v) for v in self.length.get())}, "
            f"max_refinement_level={self.max_refinement_level})"
        )
