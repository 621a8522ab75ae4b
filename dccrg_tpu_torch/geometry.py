"""Grid geometries: map cell ids/indices to physical coordinates.

Equivalents of the reference's L3 layer with a uniform interface
(get_start / get_end / get_level_0_cell_length / get_length /
get_center / get_min / get_max / get_cell / get_indices /
get_real_coordinate / file (de)serialization):

- ``NoGeometry``    — logical coords == physical (unit cells at origin),
  geometry id 0 (dccrg_no_geometry.hpp:46-558).
- ``CartesianGeometry`` — uniform cuboid cells from ``start`` +
  ``level_0_cell_length`` parameters, geometry id 1
  (dccrg_cartesian_geometry.hpp:51-813).
- ``StretchedCartesianGeometry`` — per-dimension monotone coordinate
  arrays (length+1 boundary values per dim), geometry id 2
  (dccrg_stretched_cartesian_geometry.hpp:48-830).

All coordinate queries are vectorized over arrays of cell ids and run
on the host, in NumPy or, from 4096 cells, in the native engine
(dccrg_tpu_torch/native); device paths derive their own coordinate
arrays from these parameters instead of calling back into Python.
"""

from __future__ import annotations

import struct

import numpy as np

from .mapping import _NATIVE_BATCH, Mapping
from .topology import GridTopology
from .types import ERROR_INDEX, as_cell_array


class _GeometryBase:
    """Shared implementation: everything derives from per-dimension
    level-0 cell boundary coordinates + uniform subdivision within a
    level-0 cell.

    The NumPy paths and the native engine compute with the SAME formulas
    (same operation order, no FMA contraction), and those are the
    reference package's, so results are bit-identical whatever the batch
    size or engine (tests/test_torch_native.py)."""

    geometry_id: int = -1

    def __init__(self, mapping: Mapping, topology: GridTopology):
        self.mapping = mapping
        self.topology = topology

    def _native(self, n: int):
        """The native module when the engine is on and the batch is
        worth dispatching."""
        if n >= _NATIVE_BATCH:
            from . import native

            if native.lib() is not None:
                return native
        return None

    # subclasses must provide level-0 boundary coordinate arrays,
    # one per dimension, each of length length[d]+1 (monotone increasing)
    def _boundaries(self, dimension: int) -> np.ndarray:
        raise NotImplementedError

    # --- extents ------------------------------------------------------

    def get_start(self) -> np.ndarray:
        return np.array([self._boundaries(d)[0] for d in range(3)])

    def get_end(self) -> np.ndarray:
        return np.array([self._boundaries(d)[-1] for d in range(3)])

    # --- per-cell queries --------------------------------------------

    def _cell_level_and_l0(self, cells):
        """refinement level, level-0 index per dim, within-level-0 fractional
        position of min corner, and fractional extent, for each cell."""
        cells = as_cell_array(cells)
        lvl = np.atleast_1d(np.asarray(self.mapping.get_refinement_level(cells), np.int64))
        bad = lvl < 0
        lvl_safe = np.where(bad, 0, lvl)
        idx = np.atleast_2d(self.mapping.get_indices(np.where(bad, np.uint64(1), cells)))
        scale = np.uint64(1) << np.uint64(self.mapping.max_refinement_level)
        l0 = (idx // scale).astype(np.int64)  # level-0 cell index per dim
        # position within the level-0 cell, as a fraction in [0, 1)
        frac = (idx % scale).astype(np.float64) / float(scale)
        extent = 1.0 / (1 << lvl_safe).astype(np.float64)  # cell edge / level-0 edge
        return lvl, bad, l0, frac, extent

    def _min_and_length_flat(self, cells):
        """(min corner, edge lengths) in one structure pass (1-d input);
        large batches go to the native engine."""
        arr = np.atleast_1d(np.asarray(cells))
        native = self._native(len(arr))
        if native is not None:
            return native.geometry_min_len(
                self.mapping, [self._boundaries(d) for d in range(3)], arr)
        lvl, bad, l0, frac, extent = self._cell_level_and_l0(cells)
        mins = np.empty(l0.shape, dtype=np.float64)
        lens = np.empty(l0.shape, dtype=np.float64)
        for d in range(3):
            b = self._boundaries(d)
            lo = b[np.minimum(l0[:, d], len(b) - 2)]
            hi = b[np.minimum(l0[:, d] + 1, len(b) - 1)]
            mins[:, d] = lo + frac[:, d] * (hi - lo)
            lens[:, d] = (hi - lo) * extent
        mins[bad] = np.nan
        lens[bad] = np.nan
        return mins, lens

    def _min_and_length(self, cells):
        """N-d aware wrapper: results have shape cells.shape + (3,)."""
        arr = np.asarray(cells)
        scalar = np.isscalar(cells) or arr.ndim == 0
        flat = arr.reshape(-1)
        mins, lens = self._min_and_length_flat(flat)
        shape = ((1,) if scalar else arr.shape) + (3,)
        return mins.reshape(shape), lens.reshape(shape), scalar

    def get_min(self, cells) -> np.ndarray:
        """Min corner coordinate of each cell; NaN rows for invalid ids."""
        mins, _, scalar = self._min_and_length(cells)
        return mins[0] if scalar else mins

    def get_length(self, cells) -> np.ndarray:
        """Edge lengths of each cell; NaN rows for invalid ids."""
        _, lens, scalar = self._min_and_length(cells)
        return lens[0] if scalar else lens

    def get_max(self, cells) -> np.ndarray:
        mins, lens, scalar = self._min_and_length(cells)
        out = mins + lens
        return out[0] if scalar else out

    def get_center(self, cells) -> np.ndarray:
        arr = np.asarray(cells)
        scalar = np.isscalar(cells) or arr.ndim == 0
        flat = np.atleast_1d(arr).reshape(-1)
        native = self._native(len(flat))
        if native is not None:
            out = native.geometry_centers(
                self.mapping, [self._boundaries(d) for d in range(3)], flat)
        else:
            # same formula and operation order as dn_geometry_centers:
            # lo + (frac + extent/2) * (hi - lo)
            lvl, bad, l0, frac, extent = self._cell_level_and_l0(flat)
            out = np.empty(l0.shape, dtype=np.float64)
            for d in range(3):
                b = self._boundaries(d)
                lo = b[np.minimum(l0[:, d], len(b) - 2)]
                hi = b[np.minimum(l0[:, d] + 1, len(b) - 1)]
                out[:, d] = lo + (frac[:, d] + 0.5 * extent) * (hi - lo)
            out[bad] = np.nan
        out = out.reshape(((1,) if scalar else arr.shape) + (3,))
        return out[0] if scalar else out

    # --- coordinate -> cell ------------------------------------------

    def get_real_coordinate(self, coordinate) -> np.ndarray:
        """Wrap a coordinate into the grid under periodicity; NaN in
        non-periodic dimensions outside the grid
        (dccrg_cartesian_geometry.hpp:523-566)."""
        coordinate = np.asarray(coordinate, dtype=np.float64)
        scalar = coordinate.ndim == 1
        coord = np.atleast_2d(coordinate).copy()
        start, end = self.get_start(), self.get_end()
        for d in range(3):
            c = coord[:, d]
            inside = (c >= start[d]) & (c <= end[d])
            if self.topology.is_periodic(d):
                glen = end[d] - start[d]
                below = c < start[d]
                above = c > end[d]
                c = np.where(below, c + glen * np.ceil((start[d] - c) / glen), c)
                c = np.where(above, c - glen * np.ceil((c - end[d]) / glen), c)
                coord[:, d] = c
            else:
                coord[:, d] = np.where(inside, c, np.nan)
        return coord[0] if scalar else coord

    def get_indices_from_coordinate(self, coordinate) -> np.ndarray:
        """Smallest-cell indices of a coordinate; ERROR_INDEX outside
        (dccrg_cartesian_geometry.hpp:576-609).

        Intentional divergence from the reference: a coordinate exactly
        on the grid end clamps into the last cell here, whereas the
        reference's floor arithmetic produces an out-of-range index
        (and thus error_cell from get_cell) for that boundary point.
        """
        coordinate = np.asarray(coordinate, dtype=np.float64)
        scalar = coordinate.ndim == 1
        coord = np.atleast_2d(self.get_real_coordinate(coordinate))
        scale = 1 << self.mapping.max_refinement_level
        out = np.full(coord.shape, ERROR_INDEX, dtype=np.uint64)
        for d in range(3):
            b = self._boundaries(d)
            c = coord[:, d]
            ok = ~np.isnan(c)
            cc = np.where(ok, c, b[0])
            # level-0 cell containing the coordinate
            l0 = np.clip(np.searchsorted(b, cc, side="right") - 1, 0, len(b) - 2)
            lo, hi = b[l0], b[l0 + 1]
            sub = np.floor((cc - lo) / (hi - lo) * scale).astype(np.int64)
            sub = np.clip(sub, 0, scale - 1)
            out[:, d] = np.where(ok, (l0 * scale + sub).astype(np.uint64), ERROR_INDEX)
        return out[0] if scalar else out

    def get_cell(self, refinement_level, coordinate):
        """Cell of given refinement level at a physical location
        (dccrg_cartesian_geometry.hpp:497-508)."""
        indices = self.get_indices_from_coordinate(coordinate)
        return self.mapping.get_cell_from_indices(indices, refinement_level)

    # --- file format --------------------------------------------------

    def data_size(self) -> int:
        return len(self.to_bytes())

    def to_bytes(self) -> bytes:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}(id={self.geometry_id})"


class NoGeometry(_GeometryBase):
    """Logical coordinates: unit level-0 cells with the grid at the
    origin. Geometry id 0 (dccrg_no_geometry.hpp:55)."""

    geometry_id = 0

    def _boundaries(self, dimension: int) -> np.ndarray:
        n = int(self.mapping.length.get()[dimension])
        return np.arange(n + 1, dtype=np.float64)

    def to_bytes(self) -> bytes:
        return struct.pack("<i", self.geometry_id)

    def spec(self):
        """(kind, params) for Grid.set_geometry / reconstruction."""
        return "none", {}


class CartesianGeometry(_GeometryBase):
    """Uniform cuboid cells: ``start`` corner + ``level_0_cell_length``.
    Geometry id 1 (dccrg_cartesian_geometry.hpp:51-106)."""

    geometry_id = 1

    def __init__(self, mapping, topology, start=(0.0, 0.0, 0.0), level_0_cell_length=(1.0, 1.0, 1.0)):
        super().__init__(mapping, topology)
        self.set(start, level_0_cell_length)

    def set(self, start, level_0_cell_length) -> None:
        start = np.asarray(start, dtype=np.float64)
        l0len = np.asarray(level_0_cell_length, dtype=np.float64)
        if start.shape != (3,) or l0len.shape != (3,):
            raise ValueError("start and level_0_cell_length must be 3-vectors")
        if np.any(l0len <= 0):
            raise ValueError(f"level_0_cell_length must be > 0, got {l0len}")
        self.start = start.copy()
        self.level_0_cell_length = l0len.copy()
        self._len_tbl = None  # invalidate the per-level length cache

    def get_level_0_cell_length(self) -> np.ndarray:
        return self.level_0_cell_length.copy()

    def _boundaries(self, dimension: int) -> np.ndarray:
        n = int(self.mapping.length.get()[dimension])
        return self.start[dimension] + self.level_0_cell_length[dimension] * np.arange(
            n + 1, dtype=np.float64
        )

    # Faster closed-form overrides (no searchsorted / boundary arrays;
    # the geometry lookup throughputs in BASELINE.md hit these paths).

    def _length_table(self):
        """[max_ref_lvl + 1, 3] edge lengths per level (tiny, cached)."""
        tbl = getattr(self, "_len_tbl", None)
        n = self.mapping.max_refinement_level + 1
        if tbl is None or tbl.shape[0] != n:
            tbl = self.level_0_cell_length[None, :] / (
                1 << np.arange(n, dtype=np.int64)
            ).astype(np.float64)[:, None]
            self._len_tbl = tbl
        return tbl

    def get_length(self, cells) -> np.ndarray:
        """Edge lengths from the refinement level alone — uniform cells
        need no index math (cf. dccrg_cartesian_geometry.hpp:226-280).
        The NumPy path and the native engine read the same per-level
        table, so they are bit-identical."""
        arr = np.asarray(cells)
        scalar = np.isscalar(cells) or arr.ndim == 0
        flat = as_cell_array(arr.reshape(-1))
        native = self._native(len(flat))
        if native is not None:
            lens = native.cell_lengths(self.mapping, self._length_table(), flat)
        else:
            lvl = np.atleast_1d(
                np.asarray(self.mapping.get_refinement_level(flat), np.int64)
            )
            bad = lvl < 0
            lens = self._length_table()[np.where(bad, 0, lvl)]
            if bad.any():
                lens[bad] = np.nan
        out = lens.reshape(((1,) if scalar else arr.shape) + (3,))
        return out[0] if scalar else out

    def to_bytes(self) -> bytes:
        return struct.pack("<i", self.geometry_id) + self.start.tobytes() + self.level_0_cell_length.tobytes()

    def spec(self):
        """(kind, params) for Grid.set_geometry / reconstruction."""
        return "cartesian", {
            "start": tuple(float(v) for v in self.start),
            "level_0_cell_length": tuple(float(v) for v in self.level_0_cell_length),
        }


class StretchedCartesianGeometry(_GeometryBase):
    """Per-dimension monotone coordinate arrays: dimension d has
    ``length[d] + 1`` boundary values; level-0 cell i spans
    ``[coords[d][i], coords[d][i+1]]``, refined cells subdivide that
    span uniformly. Geometry id 2
    (dccrg_stretched_cartesian_geometry.hpp:48-210)."""

    geometry_id = 2

    def __init__(self, mapping, topology, coordinates=None):
        super().__init__(mapping, topology)
        if coordinates is None:
            # default: unit cells (same as NoGeometry)
            coordinates = [
                np.arange(int(mapping.length.get()[d]) + 1, dtype=np.float64) for d in range(3)
            ]
        self.set(coordinates)

    def set(self, coordinates) -> None:
        # copy: external mutation must not bypass monotonicity validation
        coords = [np.array(c, dtype=np.float64) for c in coordinates]
        if len(coords) != 3:
            raise ValueError("need one coordinate array per dimension")
        for d in range(3):
            expect = int(self.mapping.length.get()[d]) + 1
            if coords[d].ndim != 1 or len(coords[d]) != expect:
                raise ValueError(
                    f"dimension {d}: need {expect} coordinates "
                    f"(length+1), got {coords[d].shape}"
                )
            if np.any(np.diff(coords[d]) <= 0):
                raise ValueError(f"dimension {d}: coordinates must be strictly increasing")
        self.coordinates = coords

    @classmethod
    def from_cartesian(cls, geom: CartesianGeometry) -> "StretchedCartesianGeometry":
        """Clone a Cartesian geometry
        (dccrg_stretched_cartesian_geometry.hpp:223-251)."""
        coords = [geom._boundaries(d) for d in range(3)]
        return cls(geom.mapping, geom.topology, coords)

    def _boundaries(self, dimension: int) -> np.ndarray:
        return self.coordinates[dimension]

    def to_bytes(self) -> bytes:
        # id, 3 x u64 coordinate counts, then the coordinate arrays —
        # byte-identical to the reference's record
        # (dccrg_stretched_cartesian_geometry.hpp:652-713)
        out = [struct.pack("<i", self.geometry_id),
               struct.pack("<3Q", *(len(self.coordinates[d])
                                    for d in range(3)))]
        for d in range(3):
            out.append(self.coordinates[d].tobytes())
        return b"".join(out)

    def spec(self):
        """(kind, params) for Grid.set_geometry / reconstruction."""
        return "stretched", {"coordinates": [c.copy() for c in self.coordinates]}


def geometry_from_buffer(data, offset: int, mapping: Mapping,
                         topology: GridTopology):
    """Parse the geometry record starting at ``offset``: returns
    ``(geometry, record_size)``. The record is self-describing via its
    id — NO length prefix, exactly the reference's layout (geometry
    ids per dccrg_no_geometry.hpp:55, dccrg_cartesian_geometry.hpp:106,
    dccrg_stretched_...hpp:78; write sequences :620-672 and
    :652-713)."""
    (gid,) = struct.unpack_from("<i", data, offset)
    if gid == 0:
        return NoGeometry(mapping, topology), 4
    if gid == 1:
        vals = np.frombuffer(data, dtype=np.float64, count=6,
                             offset=offset + 4)
        return CartesianGeometry(mapping, topology, vals[:3], vals[3:]), 52
    if gid == 2:
        counts = struct.unpack_from("<3Q", data, offset + 4)
        coords = []
        off = offset + 4 + 24
        for d in range(3):
            n = int(counts[d])
            coords.append(np.frombuffer(data, dtype=np.float64, count=n,
                                        offset=off).copy())
            off += 8 * n
        return (StretchedCartesianGeometry(mapping, topology, coords),
                off - offset)
    raise ValueError(f"unknown geometry id {gid}")


def geometry_from_bytes(data: bytes, mapping: Mapping, topology: GridTopology):
    """Reconstruct a geometry from exactly its file record (inverse of
    ``to_bytes``)."""
    geom, _size = geometry_from_buffer(data, 0, mapping, topology)
    return geom
