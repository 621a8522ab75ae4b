"""State carried between the reference package and the port.

Both packages keep per-cell fields as ``[n_dev, R]`` arrays, with rows
in the plan's row order and ``R = L + 1``; both build the same plan
for the same cells (closed-form, dense-table or refined), so a field
moves between them as a numpy array of that shape:
``np.asarray(jax_grid.data[name])`` on the reference side (float and
int32 fields alike). ``fields_from_cells`` / ``fields_to_cells`` carry
fields by cell id instead, through each side's own plan
(``plan.cells`` / ``plan.row_of_pos``), whatever the row layouts. A
``DenseGrid`` field is one ``[X, Y, Z, ...]`` array
(``dense_grid.to_host(name)`` there). bfloat16 arrays use the
``ml_dtypes`` bfloat16 type that the reference's arrays convert to.
"""

from __future__ import annotations

import numpy as np
import torch


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def fields_from_numpy(grid, arrays, L=None) -> None:
    """Load ``{name: ndarray [n_dev, R, ...]}`` into ``grid``'s fields.
    Each array must have the grid's shape and the field's dtype; ``L``,
    when given (the source grid's ``plan.L``), must equal the grid's."""
    plan = grid.plan
    if L is not None and int(L) != plan.L:
        raise ValueError(f"source L={L} differs from the grid's L={plan.L}")
    for name, arr in arrays.items():
        shape, dtype = grid.fields[name]
        # a private, writable copy: the reference's arrays are read-only
        arr = np.array(arr, order="C")
        want = (grid.n_dev, plan.R) + shape
        if arr.shape != want:
            raise ValueError(f"{name}: shape {arr.shape}, the grid holds "
                             f"{want} (L={plan.L}, R={plan.R})")
        if arr.dtype.name != _dtype_name(dtype):
            raise TypeError(f"{name}: dtype {arr.dtype.name}, the field is "
                            f"{_dtype_name(dtype)}")
        grid.data[name] = _to_tensor(arr, dtype).to(grid.device)
    grid._mark_ckpt_dirty()


def fields_to_numpy(grid) -> dict:
    """``{name: ndarray [n_dev, R, ...]}`` of every field, in the
    field's dtype (bfloat16 as ``ml_dtypes.bfloat16``)."""
    return {name: _to_numpy(t) for name, t in grid.data.items()}


def fields_to_cells(row_of_pos, arrays) -> dict:
    """``{name: ndarray [n_cells, ...]}`` in the plan's cell order from
    ``{name: ndarray [1, R, ...]}`` fields and that plan's
    ``row_of_pos`` — a reference grid's fields read by cell id through
    the reference's own rows (``plan.cells`` gives the ids)."""
    rows = np.asarray(row_of_pos, dtype=np.int64)
    return {name: np.asarray(a)[0, rows] for name, a in arrays.items()}


def fields_from_cells(grid, cells, arrays) -> None:
    """Write ``{name: ndarray [n, ...]}`` values given per cell id
    (``cells``, any order) into ``grid``'s rows; every id must exist in
    the grid. Rows of the grid's other cells keep their values."""
    values = {}
    for name, arr in arrays.items():
        _shape, dtype = grid.fields[name]
        arr = np.asarray(arr)
        if arr.dtype.name != _dtype_name(dtype):
            raise TypeError(f"{name}: dtype {arr.dtype.name}, the field is "
                            f"{_dtype_name(dtype)}")
        values[name] = _to_tensor(np.array(arr, order="C"), dtype)
    grid.set_many(np.asarray(cells, np.uint64), values)


def _to_tensor(arr, dtype):
    if dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def dense_from_numpy(dense_grid, arrays) -> None:
    """Load ``{name: ndarray [X, Y, Z, ...]}`` into a ``DenseGrid``'s
    arrays; each must have the grid's shape and the field's dtype."""
    for name, arr in arrays.items():
        shape, dtype = dense_grid.fields[name]
        arr = np.array(arr, order="C")
        want = dense_grid.length + shape
        if arr.shape != want:
            raise ValueError(f"{name}: shape {arr.shape}, the grid holds {want}")
        if arr.dtype.name != _dtype_name(dtype):
            raise TypeError(f"{name}: dtype {arr.dtype.name}, the field is "
                            f"{_dtype_name(dtype)}")
        dense_grid.arrays[name] = _to_tensor(arr, dtype).to(dense_grid.device)


def dense_to_numpy(dense_grid) -> dict:
    """``{name: ndarray [X, Y, Z, ...]}`` of every array of a
    ``DenseGrid``, in the field's dtype."""
    return {name: _to_numpy(t) for name, t in dense_grid.arrays.items()}


def batch_state_from_numpy(batch, arrays) -> None:
    """Load a reference ``GridBatch.state`` (``{field: ndarray
    [capacity, R, ...]}``) into a port ``GridBatch``; each array must
    have the batch's shape and the field's dtype."""
    for name, arr in arrays.items():
        shape, dtype = batch.schema[name]
        arr = np.array(arr, order="C")
        want = (batch.capacity, batch.R) + shape
        if arr.shape != want:
            raise ValueError(f"{name}: shape {arr.shape}, the batch holds "
                             f"{want}")
        if arr.dtype.name != _dtype_name(dtype):
            raise TypeError(f"{name}: dtype {arr.dtype.name}, the field is "
                            f"{_dtype_name(dtype)}")
        batch.state[name] = _to_tensor(arr, dtype).to(batch.device)


def batch_state_to_numpy(batch) -> dict:
    """``{field: ndarray [capacity, R, ...]}`` of a port ``GridBatch``'s
    state, in the field's dtype (bfloat16 as ``ml_dtypes.bfloat16``)."""
    return {name: _to_numpy(t) for name, t in batch.state.items()}
