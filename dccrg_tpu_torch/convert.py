"""State carried between the reference package and the port.

Both packages keep per-cell fields as ``[n_dev, R]`` arrays with rows in
grid order and ``R = L + 1``, so a field moves between them as a numpy
array of that shape: ``np.asarray(jax_grid.data[name])`` on the
reference side. bfloat16 arrays use the ``ml_dtypes`` bfloat16 type that
the reference's arrays convert to.
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
        if dtype == torch.bfloat16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        grid.data[name] = t.to(grid.device)


def fields_to_numpy(grid) -> dict:
    """``{name: ndarray [n_dev, R, ...]}`` of every field, in the
    field's dtype (bfloat16 as ``ml_dtypes.bfloat16``)."""
    out = {}
    for name, t in grid.data.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            out[name] = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            out[name] = t.numpy()
    return out
