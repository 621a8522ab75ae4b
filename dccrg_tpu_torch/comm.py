"""Reductions across the partitions of a grid.

Counterpart of ``dccrg_tpu/comm.py``, the wrappers of the reference's
MPI support layer (dccrg_mpi_support.hpp). The reference calls XLA
collectives inside ``shard_map``; here every partition of a grid lives
in one process, so a per-partition quantity is one ``[n_dev, ...]``
tensor and each collective is one reduction over its leading axis. The
in-program functions return the reduced value broadcast back to every
partition (what a collective leaves on each device); each ``host_*``
twin makes one pass and one host read.

- ``all_gather``  — All_Gather (dccrg_mpi_support.hpp:101-234)
- ``all_reduce``  — All_Reduce: sum, max or min (dccrg_mpi_support.hpp:240-269)
- ``all_finite``  — the watchdog's probe: one value, 1 iff every
  element of every array is finite
- ``field_sums``  — each partition's float32 sums, summed over the
  partitions (the integrity layer's conservation sums)
- ``some_reduce`` — Some_Reduce: each partition sums only its peer set
  (dccrg_mpi_support.hpp:285-380)
"""

from __future__ import annotations

import numpy as np
import torch


def _n(x) -> int:
    return int(x.shape[0])


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """``[n_dev, ...]`` -> ``[n_dev, n_dev, ...]``: every partition's
    view of every partition's row."""
    return x.unsqueeze(0).expand((_n(x),) + tuple(x.shape))


def all_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Elementwise reduction over the partition axis, broadcast back to
    every partition: ``[n_dev, ...]`` in and out."""
    if op == "sum":
        r = x.sum(dim=0, keepdim=True)
    elif op == "max":
        r = x.amax(dim=0, keepdim=True)
    elif op == "min":
        r = x.amin(dim=0, keepdim=True)
    else:
        raise ValueError(f"unknown reduction {op!r}")
    return r.expand(tuple(x.shape))


def all_finite(xs) -> torch.Tensor:
    """``[n_dev]`` int32, every entry 1 iff every element of every
    ``[n_dev, ...]`` array in ``xs`` is finite on every partition: each
    partition folds its own ``all(isfinite)`` over the list, then one
    min over the partitions."""
    xs = list(xs)
    ok = torch.stack([torch.isfinite(x).reshape(_n(x), -1).all(dim=1)
                      for x in xs]).all(dim=0).to(torch.int32)
    return all_reduce(ok, "min")


def field_sums(xs) -> torch.Tensor:
    """``[n_dev, len(xs)]`` float32: each partition's sum of each array,
    cast to float32, then summed over the partitions, so every
    partition reads the same value."""
    parts = torch.stack([x.reshape(_n(x), -1).sum(dim=1).to(torch.float32)
                         for x in xs], dim=1)
    return all_reduce(parts, "sum")


def some_reduce(x: torch.Tensor, peer_mask) -> torch.Tensor:
    """Sum of ``x`` (``[n_dev, ...]``) over each partition's peer set:
    ``peer_mask[q, p]`` true when partition q takes partition p's
    contribution. The result differs per partition."""
    w = torch.as_tensor(np.asarray(peer_mask, dtype=bool),
                        device=x.device).to(x.dtype)
    return torch.tensordot(w, x, dims=1)


def pull_replicated(t) -> np.ndarray:
    """Host copy of a replicated result. One process sees every
    partition, so this is a plain copy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _on(devices, x) -> torch.Tensor:
    """``x`` as a tensor on the partitions' device; its leading axis
    must be the partition count."""
    devs = list(devices)
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x, device=devs[0])
    if t.shape[0] != len(devs):
        raise ValueError(f"leading axis {t.shape[0]} != {len(devs)} "
                         "partitions")
    return t


def host_all_gather(devices, x) -> np.ndarray:
    """:func:`all_gather` of ``[n_dev, ...]`` rows on ``devices`` (the
    grid's partition list); returns ``[n_dev, n_dev, ...]``."""
    return pull_replicated(all_gather(_on(devices, x)))


def host_all_reduce(devices, x, op: str = "sum") -> np.ndarray:
    """Reduce ``[n_dev, ...]`` rows over the partitions; one row."""
    t = _on(devices, x)
    return pull_replicated(all_reduce(t, op)[0])


def host_some_reduce(devices, x, peer_mask) -> np.ndarray:
    """Per-partition peer-set sum of ``[n_dev, ...]`` rows."""
    return pull_replicated(some_reduce(_on(devices, x), peer_mask))
