"""Neighborhood definitions.

The default neighborhood offsets and the user-neighborhood validation of
the reference (dccrg.hpp:8017-8076, :6573-6606). A neighborhood is a
list of integer offset triples in units of a cell's own edge length.
The AMR neighbor engine (``find_neighbors_of`` and friends) is not part
of the single-device uniform slice: all-level-0 grids resolve neighbors
in closed form (uniform.py).
"""

from __future__ import annotations

import numpy as np


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
