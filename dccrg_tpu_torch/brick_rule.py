"""Times kernel A's bricks against k one-step launches on the card: the
readings behind ``PassSpec.deep_pays`` (ops/roll_executor.py
``_BRICK_PAYS``).

    python -m dccrg_tpu_torch.brick_rule [--flux diffuse advect_x]
        [--hood 0 1 2] [--n 64 96 128 192 256] [--k 2 3 4 5 6]
        [--calls 5] [--out FILE]

For each flux, default neighbourhood length, cube edge ``n`` and depth
``k`` the bricks take (``PassSpec.deep``), on a seeded float32 grid
periodic in x and y (T, T, F): one k-deep pass of the bricks
(``bulk_pass_k``) and k one-step launches of the direct kernel
(``bulk_pass``), first checked bit for bit, then each timed with CUDA
events over ``--calls`` calls after a warm-up, the two in turns. Prints
one JSON line a case: the ratio (k direct launches ÷ one pass; above 1
the bricks pay), both times, the blocks and terms a cell the rule reads,
and whether the step loop takes the bricks there; and the card's name
and power limit. ``--out`` also writes the lines to a file. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

# the twins' extras: diffuse's dt, advect_x's cfl; the upwind flux's dt
_EXTRA = {"diffuse": 0.05, "advect_x": 0.4, "upwind_xy": 0.001}


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def _grid(flux, hood_len, n, device):
    """A seeded float32 n^3 grid of the flux's fields, periodic in x
    and y, and the flux's kernel."""
    from . import DEFAULT_NEIGHBORHOOD_ID, Grid, fleet
    from .models.advection import make_uniform_flux_kernel
    from .ops import roll_executor as rx

    names = rx.DEVICE_FLUXES[flux][0]
    g = (Grid(cell_data={f: torch.float32 for f in names})
         .set_initial_length((n, n, n)).set_periodic(True, True, False)
         .set_maximum_refinement_level(0).set_neighborhood_length(hood_len)
         .initialize(device))
    gen = torch.Generator(device=device).manual_seed(n + hood_len)
    for i, f in enumerate(names):
        g.data[f][0, :n ** 3] = (torch.rand(n ** 3, generator=gen,
                                            device=device) - 0.5 * (i > 0))
    kern = (make_uniform_flux_kernel((1.0 / n,) * 3) if flux == "upwind_xy"
            else fleet.FLEET_BULK_KERNELS[flux])
    spec = rx._grid_spec_for(g, g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID], flux)
    return g, kern, spec


def _ms(fn, calls):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def measure(flux, hood_len, n, ks, calls, device):
    """One JSON-ready dict per k the bricks take at this case."""
    from .ops import roll_executor as rx

    g, kern, spec = _grid(flux, hood_len, n, device)
    fields = {f: g.data[f][0, :g.plan.L] for f in rx.DEVICE_FLUXES[flux][0]}
    extras = (torch.tensor(_EXTRA[flux], dtype=torch.float32),)
    out_name = rx.DEVICE_FLUXES[flux][1][0]
    rows = []
    for k in ks:
        deep = spec.deep(k)
        if deep is None or deep[0] != "bricks":
            continue

        def direct(k=k):
            cur = dict(fields)
            for _ in range(k):
                cur.update(rx.bulk_pass(spec, kern, cur, extras))
            return cur[out_name]

        def bricks(k=k):
            return rx.bulk_pass_k(spec, kern, fields, extras, k)[out_name]

        if not torch.equal(bricks(), direct()):
            raise SystemExit(f"brick_rule: {flux} length {hood_len} n={n} "
                             f"k={k}: the bricks differ from k launches")
        t_direct = _ms(direct, calls)
        t_bricks = _ms(bricks, calls)
        t_direct = min(t_direct, _ms(direct, calls))
        t_bricks = min(t_bricks, _ms(bricks, calls))
        bx, by, bz = deep[1]
        blocks = -(-n // bx) * -(-n // by) * -(-n // bz)
        rows.append({"flux": flux, "hood_len": hood_len, "n": n, "k": k,
                     "ratio": t_direct / t_bricks, "direct_ms": t_direct,
                     "bricks_ms": t_bricks, "blocks": blocks,
                     "terms": spec.terms(), "tile": deep[1],
                     "loop_takes": spec.deep_pays(k)})
    del g, fields
    torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--flux", nargs="+", default=["diffuse", "advect_x"])
    ap.add_argument("--hood", nargs="+", type=int, default=[0, 1, 2])
    ap.add_argument("--n", nargs="+", type=int,
                    default=[64, 96, 128, 192, 256])
    ap.add_argument("--k", nargs="+", type=int, default=[2, 3, 4, 5, 6])
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("brick_rule: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    lines = [json.dumps({"card": _card()})]
    print(lines[0], flush=True)
    for flux in args.flux:
        for hood_len in args.hood:
            for n in args.n:
                for row in measure(flux, hood_len, n, args.k, args.calls,
                                   device):
                    lines.append(json.dumps(row))
                    print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
