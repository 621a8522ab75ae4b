"""Profiles the port's main path on the card.

    python -m dccrg_tpu_torch.profiling [--n 512] [--steps 20]

It traces ``--steps`` steps of ``GridAdvection(n).run`` (after two
warm-up steps) with
``torch.profiler`` and prints one JSON line per device kernel (device
time and launches per step) and one summary line: wall time per step
(CUDA events around the traced run, the profiler's own host cost
included), device busy time per step, the device's busy share of the
wall time, launches per step, and the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def profile_main_path(n, steps, card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .models.advection import GridAdvection

    adv = GridAdvection(n=n, device="cuda")
    adv.run(2)
    torch.cuda.synchronize()
    if adv.grid.last_step_path != "bulk":
        raise SystemExit(f"the main path took {adv.grid.last_step_path!r}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        adv.run(steps)
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
                          "device_ms_per_step": dev_us / 1e3 / steps,
                          "launches_per_step": count / steps}), flush=True)
    print(json.dumps({
        "profile": "main_path", "n": n, "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_busy_share": busy_ms / wall_ms,
        "device_launches_per_step": sum(r[1] for r in rows) / steps,
        "card": card}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--steps", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiling: needs a CUDA device", file=sys.stderr)
        return 2
    profile_main_path(args.n, args.steps, _card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
