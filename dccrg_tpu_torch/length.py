"""Level-0 grid extents.

Equivalent of the reference's ``Grid_Length`` (dccrg_length.hpp:34):
holds the number of level-0 cells in each dimension, validating that the
total cell count over all refinement levels cannot overflow uint64.
"""

from __future__ import annotations

import numpy as np


class GridLength:
    """Number of level-0 cells in each dimension.

    Reference parity: dccrg_length.hpp:95-134 (``set`` with overflow
    check against the uint64 id space).
    """

    def __init__(self, length=(1, 1, 1)):
        self._length = np.array([1, 1, 1], dtype=np.uint64)
        self.set(length)

    def set(self, length) -> None:
        raw = np.asarray(length)
        if raw.shape != (3,):
            raise ValueError(f"grid length must be 3 values, got {raw!r}")
        if np.any(np.asarray(raw, dtype=object) < 0):
            raise ValueError(f"grid length must be > 0 in every dimension, got {raw}")
        try:
            arr = raw.astype(np.uint64)
        except OverflowError as e:
            raise ValueError(str(e))
        if raw.dtype == object and np.any(raw != arr):
            raise ValueError(f"grid length does not fit uint64: {raw}")
        if np.any(arr == 0):
            raise ValueError(f"grid length must be > 0 in every dimension, got {arr}")
        # Total level-0 cell count must fit uint64 (the per-level id
        # ranges are checked against max_refinement_level by Mapping).
        prod = int(arr[0]) * int(arr[1]) * int(arr[2])
        if prod >= 2**64:
            raise ValueError(f"grid of {arr} level-0 cells overflows the 64-bit id space")
        self._length = arr

    def get(self) -> np.ndarray:
        """The (3,) uint64 array of level-0 extents."""
        return self._length.copy()

    @property
    def total_level0_cells(self) -> int:
        return int(self._length[0]) * int(self._length[1]) * int(self._length[2])

    def __eq__(self, other) -> bool:
        return isinstance(other, GridLength) and bool(np.all(self._length == other._length))

    def __repr__(self) -> str:
        return f"GridLength({tuple(int(v) for v in self._length)})"
