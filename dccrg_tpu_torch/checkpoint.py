"""Checkpoint helpers of the port (counterpart of ``dccrg_tpu/checkpoint.py``).

Only ``state_digest`` is ported so far: the fleet compares final states
through it. The ``.dc`` file format comes with the checkpoint slice.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def dtype_name(dtype: torch.dtype) -> str:
    """The dtype's name as numpy and JAX print it ('float32',
    'bfloat16'), so digests equal the reference's on equal bytes."""
    return str(dtype).removeprefix("torch.")


def tensor_bytes(t: torch.Tensor) -> bytes:
    """The raw bytes of ``t`` in row-major order. bfloat16 goes through
    its int16 view, which carries the same bytes without needing a
    numpy bfloat16 type."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return np.ascontiguousarray(t.numpy()).tobytes()


def digest_update(h, name: str, shape, dtype, owned: torch.Tensor) -> None:
    """Fold one field's header ``repr((name, shape, dtype name))`` and
    its owned rows' bytes into the hash ``h``."""
    h.update(repr((name, tuple(shape), dtype_name(dtype))).encode())
    h.update(tensor_bytes(owned))


def state_digest(grid, fields=None) -> str:
    """Deterministic SHA-256 over the grid's OWNED cell bytes (rows
    ``[0, n_local)`` of the one device; pad rows excluded), field-name
    sorted with the name, shape and dtype folded in. Equal to the
    reference's digest of a grid holding the same bytes."""
    h = hashlib.sha256()
    n_own = int(grid.plan.n_local[0])
    for name in sorted(fields if fields is not None else grid.fields):
        shape, dtype = grid.fields[name]
        digest_update(h, name, shape, dtype, grid.data[name][0, :n_own])
    return h.hexdigest()
