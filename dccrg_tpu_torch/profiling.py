"""Profiles the port's paths on the card.

    python -m dccrg_tpu_torch.profiling [--path main] [--n 512] [--steps 20]
    python -m dccrg_tpu_torch.profiling --path fleet [--n 64]

``--path main`` (the default) traces ``--steps`` steps of
``GridAdvection(n).run`` after two warm-up steps. ``--path fleet``
traces one 8-step quantum (``DCCRG_FLEET_QUANTUM``'s default) of a full
bucket of 128 ``diffuse`` jobs of ``n``^3 cells
(``DCCRG_FLEET_MAX_BATCH``'s default; bench/fleet_bench.py's jobs,
integrity on) through ``GridBatch`` after one warm-up quantum. Each prints one JSON line
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


def _trace(run, per, unit, summary):
    """Trace ``run()`` with torch.profiler and print the device kernels
    (time and launches divided by ``per``, in ``unit``) and the dict
    ``summary()`` returns after the run, with the wall and busy figures
    added."""
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--path", choices=("main", "fleet"), default="main")
    p.add_argument("--n", type=int, default=None,
                   help="grid edge (default 512 main, 64 fleet)")
    p.add_argument("--steps", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiling: needs a CUDA device", file=sys.stderr)
        return 2
    if args.path == "main":
        profile_main_path(args.n or 512, args.steps, _card())
    else:
        profile_fleet(args.n or 64, _card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
