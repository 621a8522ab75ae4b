"""Per-phase timing and transfer accounting.

Port of ``dccrg_tpu/utils/profiling.py``. The reference dccrg has no
profiling subsystem; its apps time phases with MPI_Wtime and reduce
min/avg/max over ranks (tests/advection/2d.cpp:330-340, 453-503) and
compute halo bandwidth from the grid's transfer counters
(2d.cpp:345-350). :class:`PhaseTimer` accumulates named phase
durations, waiting for the card at both ends of a phase when given a
device (``torch.cuda.synchronize``), and :func:`halo_bytes_per_update`
mirrors the byte accounting.

For kernel-level analysis use ``python -m dccrg_tpu_torch.profiling``
(``torch.profiler``); this is the lightweight always-on layer.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np
import torch


def device_sync(device):
    """A ``sync`` callable for :class:`PhaseTimer` that waits for the
    work queued on ``device`` (or on each of a list of devices):
    ``torch.cuda.synchronize`` of every CUDA device, None when there is
    none (host work is synchronous)."""
    devices = device if isinstance(device, (list, tuple)) else [device]
    cards = list({str(d): d for d in (torch.device(d) for d in devices)
                  if d.type == "cuda"}.values())
    if not cards:
        return None

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)
    return sync


class PhaseTimer:
    def __init__(self, sync=None):
        """``sync``: optional callable blocking until device work
        finishes (e.g. :func:`device_sync` of the grid's device)."""
        self._sync = sync
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def phase(self, name: str):
        if self._sync:
            self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()

    def report(self) -> dict:
        """{phase: {total, count, mean}}, the average the reference
        prints per rank."""
        return {
            k: {"total": self.totals[k], "count": self.counts[k],
                "mean": self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }

    def __repr__(self):
        rows = [
            f"{k}: {v['total']:.4f}s / {v['count']} = {v['mean'] * 1e3:.2f}ms"
            for k, v in sorted(self.report().items())
        ]
        return "PhaseTimer(" + "; ".join(rows) + ")"


def halo_bytes_per_update(grid, neighborhood_id=None, fields=None,
                          rank: bool = False, device: bool = False) -> int:
    """Bytes moved by one ``update_copies_of_remote_neighbors`` call:
    the reference's get_number_of_update_send_cells times the payload
    size (tests/advection/2d.cpp:345-350), per field, after the field's
    transfer predicate. Every partition's sends (the group's, on a grid
    whose partitions span ranks), or with ``rank`` only those of this
    process's partitions (the reference's per-rank counter), or with
    ``device`` only the sends between this process's partitions on
    distinct devices (the ``device_halo`` leg)."""
    from ..grid import DEFAULT_NEIGHBORHOOD_ID

    hood_id = (neighborhood_id if neighborhood_id is not None
               else DEFAULT_NEIGHBORHOOD_ID)
    names = fields if fields is not None else list(grid.fields)
    total = 0
    for name in names:
        shape, dtype = grid.fields[name]
        per_cell = (int(np.prod(shape, dtype=np.int64)) if shape else 1) \
            * torch.empty((), dtype=dtype).element_size()
        if device:
            c = grid._field_pair_compact(hood_id, name)
            slot, gof = grid._slot, grid._gof
            both = (slot[c["p"]] >= 0) & (slot[c["q"]] >= 0)
            cells = int(np.count_nonzero(
                gof[slot[c["p"][both]]] != gof[slot[c["q"][both]]]))
        elif rank:
            senders = grid._field_pair_compact(hood_id, name)["p"]
            cells = int(np.count_nonzero(grid._proc_local_dev[senders]))
        else:
            cells = grid.get_number_of_update_send_cells(hood_id, field=name)
        total += cells * per_cell
    return total
