"""Grid topology: per-dimension periodicity.

Equivalent of the reference's ``Grid_Topology`` (dccrg_topology.hpp:38):
three booleans stating whether the grid wraps around in x/y/z, plus the
binary file representation used by checkpoint files (3 uint8 values,
dccrg_topology.hpp:108-222).
"""

from __future__ import annotations

import numpy as np


class GridTopology:
    def __init__(self, periodic=(False, False, False)):
        self._periodic = [False, False, False]
        self.set_periodicity(periodic)

    def set_periodicity(self, periodic) -> None:
        periodic = list(periodic)
        if len(periodic) != 3:
            raise ValueError(f"periodicity must be 3 values, got {periodic!r}")
        self._periodic = [bool(p) for p in periodic]

    def is_periodic(self, dimension: int) -> bool:
        if dimension not in (0, 1, 2):
            raise ValueError(f"dimension must be 0..2, got {dimension}")
        return self._periodic[dimension]

    @property
    def periodic(self) -> tuple:
        return tuple(self._periodic)

    # --- file format (reference: dccrg_topology.hpp:108-222) ---------
    # 3 bytes, one per dimension, nonzero = periodic.

    def data_size(self) -> int:
        return 3

    def to_bytes(self) -> bytes:
        return bytes(np.array(self._periodic, dtype=np.uint8))

    @classmethod
    def from_bytes(cls, data: bytes) -> "GridTopology":
        if len(data) != 3:
            raise ValueError(f"topology record must be 3 bytes, got {len(data)}")
        arr = np.frombuffer(data, dtype=np.uint8)
        return cls(tuple(bool(v) for v in arr))

    def __eq__(self, other) -> bool:
        return isinstance(other, GridTopology) and self._periodic == other._periodic

    def __repr__(self) -> str:
        return f"GridTopology(periodic={tuple(self._periodic)})"
