"""Profiles the port's paths on the card.

    python -m dccrg_tpu_torch.profiling [--path main] [--n 512] [--steps 20]
    python -m dccrg_tpu_torch.profiling --path fleet [--n 64]
    python -m dccrg_tpu_torch.profiling --path amr [--n 128] [--parts 1]
    python -m dccrg_tpu_torch.profiling --path multi [--n 512] [--parts 4]

``--path main`` (the default) traces ``--steps`` steps of
``GridAdvection(n).run`` after two warm-up steps. ``--path fleet``
traces one 8-step quantum (``DCCRG_FLEET_QUANTUM``'s default) of a full
bucket of 128 ``diffuse`` jobs of ``n``^3 cells
(``DCCRG_FLEET_MAX_BATCH``'s default; bench/fleet_bench.py's jobs,
integrity on) through ``GridBatch`` after one warm-up quantum.
``--path amr`` traces ``--steps`` table-path steps of
bench/recommit_bench.py's refined grid (``amr_slab_grid``: ``n``^3,
two slab commits; on ``--parts`` ``block`` partitions, one by default)
with its diffuse kernel, after one warm-up step.
``--path multi`` traces ``--steps`` steps of ``GridAdvection(n)`` on
``--parts`` partitions of the card (the plain roll path with its fixup
rows, the halo exchange and, by default, the overlapped step's side
stream and outer re-pass) after one warm-up step. Each prints one JSON line
per device kernel (device time and launches per step, or per quantum)
and one summary line: wall time (CUDA events around the traced run, the
profiler's own host cost included), device busy time, the device's busy
share of the wall time, launches, and the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def trace_counts(run):
    """Trace ``run()`` with torch.profiler: ``(wall_ms, rows)`` with the
    wall time by CUDA events around the run (the profiler's own host
    cost included) and one ``(device_us, launches, name)`` row per
    device kernel, copy or set, busiest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        run()
        t1.record()
        t1.synchronize()
    wall_ms = t0.elapsed_time(t1)
    # device-side events only (kernels, copies, sets), so nothing is
    # counted twice through the CPU op that launched it
    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    return wall_ms, rows


def _trace(run, per, unit, summary):
    """Trace ``run()`` (:func:`trace_counts`) and print the device
    kernels (time and launches divided by ``per``, in ``unit``) and the
    dict ``summary()`` returns after the run, with the wall and busy
    figures added."""
    wall_ms, rows = trace_counts(run)
    busy_ms = sum(r[0] for r in rows) / 1e3
    for dev_us, count, key in rows[:15]:
        print(json.dumps({"kernel": key[:80],
                          f"device_ms_per_{unit}": dev_us / 1e3 / per,
                          f"launches_per_{unit}": count / per}), flush=True)
    summary = summary()
    summary.update({
        f"wall_ms_per_{unit}": wall_ms / per,
        f"device_busy_ms_per_{unit}": busy_ms / per,
        "device_busy_share": busy_ms / wall_ms,
        f"device_launches_per_{unit}": sum(r[1] for r in rows) / per})
    print(json.dumps(summary), flush=True)


def profile_main_path(n, steps, card):
    from .models.advection import GridAdvection

    adv = GridAdvection(n=n, device="cuda")
    adv.run(2)
    torch.cuda.synchronize()
    if adv.grid.last_step_path != "bulk":
        raise SystemExit(f"the main path took {adv.grid.last_step_path!r}")
    _trace(lambda: adv.run(steps), steps, "step",
           lambda: {"profile": "main_path", "n": n, "steps": steps,
                    "card": card})


def profile_fleet(n, card, slots=128, q=8):
    from . import fleet
    from .ops import roll_executor

    os.environ.pop("DCCRG_INTEGRITY", None)  # integrity on, the default
    jobs = [fleet.FleetJob(f"b{i:04d}", length=(n, n, n), n_steps=q,
                           params=(0.02 + 0.003 * (i % 7),), seed=i)
            for i in range(slots)]
    batch = fleet.GridBatch(jobs[0], slots, device="cuda")
    for j in jobs:
        j.apply_init(batch.grid)
        batch.admit(j)
    if not batch.bulk_active():
        raise SystemExit("the fleet bucket did not select kernel A'")
    budget = np.full(slots, q, np.int32)
    batch.step(budget)  # warm-up quantum
    torch.cuda.synchronize()
    before = roll_executor.fleet_bulk_pass.launches
    _trace(lambda: batch.step(budget), 1, "quantum",
           lambda: {"profile": "fleet", "n": n, "slots": slots, "steps": q,
                    "kernel_a_prime_launches":
                    roll_executor.fleet_bulk_pass.launches - before,
                    "card": card})


def amr_diffuse(cell, nbr, offs, mask):
    """bench/recommit_bench.py's ``_diffuse`` kernel (its :165), as a
    plain grid kernel."""
    s = torch.sum(torch.where(mask, nbr["density"] - cell["density"][:, None],
                              0.0), dim=1)
    return {"density": cell["density"] + 0.01 * s}


def amr_slab_grid(n, device, on_commit=None, partition=None):
    """bench/recommit_bench.py:90-118's refined grid: an n^3 level-0 grid
    (max level 1, neighbourhood length 1, one float32 density); commit 1
    refines the first n^3/64 cells (a z-slab), commit 2 the last n^3/64
    level-0 cells; density ``arange % 97`` as the bench sets it.
    ``device`` may list partitions (``[dev] * n``, cut by
    ``partition``). ``on_commit(commit)`` wraps each ``stop_refining``
    call (the caller times it)."""
    from .grid import Grid

    g = (Grid(cell_data={"density": torch.float32})
         .set_initial_length((n, n, n))
         .set_maximum_refinement_level(1)
         .set_neighborhood_length(1)
         .initialize(device, partition=partition))
    n0 = n ** 3
    nref = n0 // 64
    for first in (True, False):
        cells = g.plan.cells
        pick = cells[:nref] if first else cells[cells <= n0][-nref:]
        for c in pick:
            g.refine_completely(c)
        if on_commit is None:
            g.stop_refining()
        else:
            on_commit(g.stop_refining)
    cells = g.get_cells()
    g.set("density", cells, (np.arange(len(cells)) % 97).astype(np.float32))
    return g


def plan_digest(grid) -> str:
    """SHA-256 of a grid's structure plan: cells, owners, the row layout
    of every partition and every hood's dense, hard and pair tables —
    equal digests mean plans equal bit for bit."""
    import hashlib

    h = hashlib.sha256()

    def put(a):
        a = np.ascontiguousarray(np.asarray(a))
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())

    plan = grid.plan
    h.update(f"{plan.n_dev} {plan.L} {plan.R}".encode())
    for name in ("cells", "owner", "row_of_pos", "n_local"):
        put(getattr(plan, name))
    for d in range(plan.n_dev):
        put(plan.local_ids[d])
        put(plan.ghost_ids[d])
    for hid in sorted(plan.hoods):
        hood = plan.hoods[hid]
        for name in ("nbr_rows", "nbr_mask", "scale_rows", "hard_rows",
                     "hard_nbr_rows", "hard_offs", "hard_mask", "n_inner"):
            v = getattr(hood, name)
            put(np.zeros(0) if v is None else v)
        for key in ("p", "q", "pos", "srow", "rrow"):
            put(hood.pair_compact[key])
    return h.hexdigest()


def profile_amr(n, steps, card, parts=1):
    g = amr_slab_grid(n, ["cuda"] * parts, partition="block")
    g.run_steps(amr_diffuse, ["density"], ["density"], 1)
    torch.cuda.synchronize()
    if g.last_step_path != "table":
        raise SystemExit(f"the AMR steps took {g.last_step_path!r}")
    hood = g.plan.hoods[-0xDCC]
    _trace(lambda: g.run_steps(amr_diffuse, ["density"], ["density"], steps),
           steps, "step",
           lambda: {"profile": "amr", "n": n, "parts": parts, "steps": steps,
                    "cells": len(g.plan.cells), "L": g.plan.L,
                    "hard_rows": int(np.count_nonzero(
                        hood.hard_rows < g.plan.L)),
                    "overlap": (g.last_overlap or {}).get("mode"),
                    "card": card})


def profile_multi(n, steps, parts, card):
    from .models.advection import GridAdvection

    adv = GridAdvection(n=n, device=["cuda"] * parts)
    adv.run(1)
    torch.cuda.synchronize()
    _trace(lambda: adv.run(steps), steps, "step",
           lambda: {"profile": "multi", "n": n, "parts": parts,
                    "steps": steps, "path": adv.grid.last_step_path,
                    "overlap": adv.grid.last_overlap["mode"], "card": card})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--path", choices=("main", "fleet", "amr", "multi"),
                   default="main")
    p.add_argument("--n", type=int, default=None,
                   help="grid edge (default 512 main and multi, 64 fleet, "
                        "128 amr)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--parts", type=int, default=None,
                   help="partitions (default 4 for --path multi, 1 for "
                        "--path amr)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiling: needs a CUDA device", file=sys.stderr)
        return 2
    if args.path == "main":
        profile_main_path(args.n or 512, args.steps, _card())
    elif args.path == "amr":
        profile_amr(args.n or 128, args.steps, _card(), args.parts or 1)
    elif args.path == "multi":
        profile_multi(args.n or 512, args.steps, args.parts or 4, _card())
    else:
        profile_fleet(args.n or 64, _card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
