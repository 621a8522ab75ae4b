"""Primitive types and constants.

Semantics follow the reference's L0 layer (dccrg_types.hpp:60,84):
indices are triples of unsigned 64-bit integers measured in units of the
*smallest possible* cell in the grid (i.e. a cell at the maximum
refinement level has extent 1 in indices); a neighborhood is a list of
integer offset triples, in units of a cell's *own* size.

All host-side structure code is vectorized numpy over uint64/int64;
device-side tables are int32 (a single device never addresses more than
2**31 local+ghost cells).
"""

from __future__ import annotations

import numpy as np

# Invalid cell id (reference: dccrg_mapping.hpp:38). Cell numbering is
# 1-based, so 0 is free to mean "no cell".
ERROR_CELL = np.uint64(0)

# Invalid index (reference: dccrg_mapping.hpp:41).
ERROR_INDEX = np.uint64(0xFFFFFFFFFFFFFFFF)


def as_cell_array(cells) -> np.ndarray:
    """Coerce a scalar/list of cell ids to a uint64 numpy array.

    Out-of-range values (negative, or >= 2**64) become ERROR_CELL rather
    than raising, preserving the error-value convention for callers that
    produce ids from signed arithmetic.
    """
    arr = np.asarray(cells)
    if arr.dtype == np.uint64:
        return np.atleast_1d(arr)
    if np.issubdtype(arr.dtype, np.unsignedinteger):
        return np.atleast_1d(arr.astype(np.uint64))
    if np.issubdtype(arr.dtype, np.signedinteger):
        a = np.atleast_1d(arr)
        return np.where(a < 0, 0, a).astype(np.uint64)
    if np.issubdtype(arr.dtype, np.floating):
        a = np.atleast_1d(arr)
        bad = ~np.isfinite(a) | (a < 0) | (a >= 2.0**64)
        return np.where(bad, 0.0, a).astype(np.uint64)
    # object dtype: python ints possibly outside int64/uint64 range
    a = np.atleast_1d(arr)
    out = np.zeros(a.shape, dtype=np.uint64)
    flat, oflat = a.reshape(-1), out.reshape(-1)
    for i, v in enumerate(flat):
        iv = int(v)
        if 0 <= iv < 2**64:
            oflat[i] = iv
    return out


def as_index_array(indices) -> np.ndarray:
    """Coerce indices to a (..., 3) uint64 array."""
    arr = np.asarray(indices, dtype=np.uint64)
    if arr.shape[-1] != 3:
        raise ValueError(f"indices must have trailing dim 3, got {arr.shape}")
    return arr
