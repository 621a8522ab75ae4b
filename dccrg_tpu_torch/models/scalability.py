"""Synthetic weak/strong-scaling harness, on PyTorch.

Port of ``dccrg_tpu/models/scalability.py``, the reference dccrg's
scalability suite (tests/scalability/scalability.cpp:39-160): a
configurable cost model (bytes moved per cell, artificial compute per
cell) measuring solve time against halo-exchange time per step, and a
sweep over parallelism (tests/scalability/run_tests.py:28-39 sweeps MPI
process counts; here the sweep varies the number of partitions of the
device, and a placement of ``(rank, device)`` entries puts the
partitions on the ranks of a process group).

The per-cell payload is ``floats_per_cell`` float32 lanes; the solve
does ``work_iters`` dependent multiply-adds per lane (the reference's
busy-wait ``solution_time`` knob, :61-75), here a loop of eager
operations. Each ``v * a + b`` rounds twice; the reference's compiler
may contract it into one fused multiply-add, so the two agree to a
stated tolerance, not bit for bit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..grid import Grid
from ..utils import PhaseTimer
from ..utils.profiling import device_sync, halo_bytes_per_update


class ScalabilityModel:
    """The cost model on ``device`` (the card when None; ``[dev] * n``
    for n partitions of it; a list of distinct devices for one partition
    on each; ``coord.rank_devices(k, dev)`` for k partitions on each
    rank of a process group, each rank stepping its own)."""

    def __init__(self, length=(16, 16, 16), floats_per_cell: int = 8,
                 work_iters: int = 64, device=None, partition=None,
                 neighborhood_length: int = 1):
        self.floats_per_cell = int(floats_per_cell)
        self.work_iters = int(work_iters)
        self.grid = (
            Grid(cell_data={"payload": ((self.floats_per_cell,),
                                        torch.float32)})
            .set_initial_length(length)
            .set_periodic(True, True, True)
            .set_neighborhood_length(neighborhood_length)
            .initialize(device, partition=partition)
        )
        cells = self.grid.get_cells()
        rng = np.random.default_rng(0)
        self.grid.set(
            "payload", cells,
            rng.standard_normal((len(cells), self.floats_per_cell))
            .astype(np.float32),
        )
        self.timer = PhaseTimer(device_sync(
            [grp.device for grp in self.grid._groups]))
        iters = self.work_iters

        def kernel(cell, nbr, offs, mask):
            # average of neighbours (consumes the halo) ...
            m = mask[..., None]
            cnt = torch.clamp_min(mask.sum(dim=1), 1)
            avg = torch.where(m, nbr["payload"],
                              nbr["payload"].new_zeros(())).sum(dim=1)
            avg = avg / cnt[:, None].to(torch.float32)
            # ... then a dependent multiply-add chain per lane: the
            # tunable compute cost (scalability.cpp:61-75's busy loop)
            v = 0.5 * (cell["payload"] + avg)
            for _ in range(iters):
                v = v * np.float32(1.0000001) + np.float32(1e-7)
            return {"payload": v}

        self._kernel = kernel

    def step(self) -> None:
        """One timed step: halo exchange, then the synthetic solve (the
        reference times these phases apart, scalability.cpp:124-160)."""
        g = self.grid
        with self.timer.phase("halo"):
            g.update_copies_of_remote_neighbors(fields=["payload"])
        with self.timer.phase("solve"):
            g.apply_stencil(self._kernel, ["payload"], ["payload"])

    def run(self, steps: int = 10, warmup: int = 2) -> dict:
        """Per-step timings and transfer volume, the reference's printed
        metrics (scalability.cpp:124-160): ``n_devices`` and ``n_cells``
        of the whole placement, ``halo_bytes_per_step`` of every
        partition's sends, ``rank_halo_bytes_per_step`` of this
        process's (the same in one process) and
        ``device_halo_bytes_per_step`` of those that cross between
        distinct devices of this process; the times are this process's
        clock."""
        for _ in range(warmup):
            self.step()
        self.timer.reset()
        t0 = time.perf_counter()
        for _ in range(steps):
            self.step()
        total = time.perf_counter() - t0
        rep = self.timer.report()
        n_cells = len(self.grid.get_cells())
        return {
            "n_devices": self.grid.n_dev,
            "n_cells": n_cells,
            "steps": steps,
            "solve_s_per_step": rep["solve"]["total"] / steps,
            "halo_s_per_step": rep["halo"]["total"] / steps,
            "total_s_per_step": total / steps,
            "cell_updates_per_sec": n_cells * steps / total,
            "halo_bytes_per_step": halo_bytes_per_update(self.grid),
            "rank_halo_bytes_per_step": halo_bytes_per_update(self.grid,
                                                              rank=True),
            "device_halo_bytes_per_step": halo_bytes_per_update(
                self.grid, device=True),
        }


def run_sweep(device_counts=None, length=(16, 16, 16),
              floats_per_cell: int = 8, work_iters: int = 64,
              steps: int = 10, weak: bool = False, device=None) -> list:
    """Strong (fixed size) or weak (size grows with the partition count
    in x) scaling sweep over partition counts: the run_tests.py driver.
    ``device`` is a device (the card when None), each count n running n
    partitions of it, or a list of devices, each count n running on its
    first n (``devices[:n]``, the reference's sweep; counts past the
    list's length are skipped with a note on standard error)."""
    if isinstance(device, (list, tuple)):
        devices = list(device)
        if device_counts is None:
            device_counts = [n for n in (1, 2, 4, 8) if n <= len(devices)]
        dropped = [n for n in device_counts if n > len(devices)]
        if dropped:
            import sys
            print(f"skipping device counts {dropped}: only {len(devices)} "
                  f"device(s) given", file=sys.stderr)
            device_counts = [n for n in device_counts if n <= len(devices)]
    else:
        dev = torch.device("cuda" if device is None else device)
        devices = None
        if device_counts is None:
            device_counts = (1, 2, 4, 8)
    results = []
    for n in device_counts:
        dims = (length[0] * n, length[1], length[2]) if weak else length
        model = ScalabilityModel(
            dims, floats_per_cell=floats_per_cell, work_iters=work_iters,
            device=devices[:n] if devices is not None else [dev] * n)
        results.append(model.run(steps=steps))
    return results


if __name__ == "__main__":
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--length", type=int, nargs=3, default=[16, 16, 16])
    p.add_argument("--floats-per-cell", type=int, default=8)
    p.add_argument("--work-iters", type=int, default=64)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--weak", action="store_true")
    p.add_argument("--partitions", type=int, nargs="*", default=None)
    p.add_argument("--device", default=None,
                   help="the card when omitted; 'cpu' for the CPU")
    p.add_argument("--devices", nargs="+", default=None,
                   help="distinct devices to sweep over (count n runs on "
                        "the first n), instead of --device")
    a = p.parse_args()
    for row in run_sweep(a.partitions, tuple(a.length), a.floats_per_cell,
                         a.work_iters, a.steps, a.weak,
                         a.devices if a.devices else a.device):
        print(json.dumps(row))
