"""Times the tiled routes of a generated flux on the card in each form:
the readings behind ``flux_gen.gen_form``.

    python -m dccrg_tpu_torch.gen_tile_rule [--cases a b ...] [--iters 20]
        [--out FILE]

The four cases of ``chip_smoke.py``'s ``[user flux]``, on seeded grids
periodic in x and y: (a) ``user_kernels.weighted`` (fields v, w,
float32) on the 26-cube at 512³; (b) the upwind flux over float32
density and bfloat16 velocities on the face set at 512³; (c)
``user_kernels.gauss`` (bfloat16, ``exp``) at 128³ on the 124 slots of
length 2; (d) the user twin ``weighted_diffuse`` over a bucket of 128
grids of 64³, periodic in all three (kernel A'). And the cases on each
side of the rule's thresholds, float32 at 256³: on the 26-cube (p3),
(p7) and (p11) ``user_kernels.polynomial`` of 3, 7 and 11 terms (208,
416 and 624 float operations a cell, about
:data:`flux_gen.HEAVY_CELL`), (s4) and (s8) ``user_kernels.field_sum``
of 4 and 8 staged fields; (w2) ``user_kernels.weighted`` on the 124
slots of length 2 (372 a cell).

Each case's source is built once a form (``flux_gen.GenForm``): 1, 2
and 4 cells a thread under launch bounds of 1 and 2 blocks an SM,
staged through registers and (cases (a)-(d)) by ``cp.async``, tiles of
32 along x; at the rule's cells, tiles of 64 along x (for (d) the band
of a grid's whole x extent) likewise. Each form is checked bit for
bit against the plain pass and timed with CUDA events over ``--iters``
launches after a warm-up, the forms in turns and then in the reverse
order. Prints one JSON line a case: each form's two readings (``CxB``,
with ``/64`` for tiles of 64 and ``/async`` for the async staging), the
rule's form, and the card's name and power limit. ``--out`` also writes
the lines to a file. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from . import user_kernels as uk

F32, BF16 = torch.float32, torch.bfloat16

# case -> (kernel, storage dtypes, fields out, extras, neighbourhood
# length, grid edge); the forms' kinds: every staging (a)-(d), the
# register staging only for the threshold cases
_CASES = {
    "a": (uk.weighted, {"v": F32, "w": F32}, ("v",), (), 1, 512),
    "b": (None, {"density": F32, "vx": BF16, "vy": BF16}, ("density",),
          (0.4 / 512,), 0, 512),
    "c": (uk.gauss, {"u": BF16}, ("u",), (0.05,), 2, 128),
    "d": (uk.weighted_diffuse, {"rho": F32}, ("rho",), (0.02,), 1, 64),
    "p3": (lambda: uk.polynomial(3), {"u": F32}, ("u",), (0.01,), 1, 256),
    "p7": (lambda: uk.polynomial(7), {"u": F32}, ("u",), (0.01,), 1, 256),
    "p11": (lambda: uk.polynomial(11), {"u": F32}, ("u",), (0.01,), 1,
            256),
    "w2": (uk.weighted, {"v": F32, "w": F32}, ("v",), (), 2, 256),
    "s4": (lambda: uk.field_sum(4), {f"f{i}": F32 for i in range(4)},
           ("f0",), (0.01,), 1, 256),
    "s8": (lambda: uk.field_sum(8), {f"f{i}": F32 for i in range(8)},
           ("f0",), (0.01,), 1, 256),
}
_SLOTS = 128  # case (d)'s bucket


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def label(form):
    """A form's name in the readings: ``CxB[/64][/async]``."""
    return (f"{form.cells}x{form.min_blocks}"
            + ("/64" if form.tx == 64 else "")
            + ("/async" if form.stage == "async" else ""))


def forms(case, rule):
    """The forms timed for ``case``, whose rule's form is ``rule``."""
    from .ops.flux_gen import GenForm

    stages = ("regs", "async") if case in "abcd" else ("regs",)
    return ([GenForm(c, b, 32, st) for st in stages for c in (1, 2, 4)
             for b in (1, 2)]
            + [GenForm(rule.cells, b, 64, st) for st in stages
               for b in (1, 2)])


def _kernel(case):
    from .models.advection import make_uniform_flux_kernel

    make = _CASES[case][0]
    return make() if make else make_uniform_flux_kernel((1.0 / 512,) * 3)


def setup(case, device):
    """One case on ``device``: ``(run, want, flux, table)``, ``run(form)``
    one launch of the tiled route in ``form`` and ``want`` the plain
    pass's fields out."""
    from . import DEFAULT_NEIGHBORHOOD_ID, Grid
    from .ops import flux_gen
    from .ops import roll_executor as rx

    _make, cd, fout, ex, hood_len, n = _CASES[case]
    kern = _kernel(case)
    fleet = case == "d"
    # periodic in x and y; a fleet job's grid in all three
    g = (Grid(cell_data=cd).set_initial_length((n, n, n))
         .set_periodic(True, True, fleet)
         .set_maximum_refinement_level(0).set_neighborhood_length(hood_len)
         .initialize(device))
    gen = torch.Generator(device=device).manual_seed(700 + hood_len)
    hood = g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID]
    if fleet:
        cf = hood.closed_form
        spec = rx.FleetPassSpec(cf["dims"], cf["periodic"], cf["offsets"],
                                hood.offs_const, cf["n0"], g.plan.L)
        flux = flux_gen.lower(kern, tuple(cd), fout, cd, len(ex),
                              target="cuda", batched=True)
        state = {"rho": torch.rand((_SLOTS, spec.R), generator=gen,
                                   device=device) * 100}
        extras = torch.full((_SLOTS, 1), ex[0], device=device)

        def run(form):
            return rx.fleet_bulk_pass(spec, kern, state, extras, flux=flux,
                                      gen_form=form)

        want = rx.fleet_bulk_pass_plain(spec, kern, state, extras, flux=flux)
    else:
        n0 = n ** 3
        for f, dt in cd.items():
            g.data[f][0, :n0] = (torch.rand(n0, generator=gen, device=device)
                                 - 0.5).to(dt)
        flux = rx.lowered(g, kern, tuple(cd), fout, len(ex))
        spec = rx._grid_spec_for(g, hood, flux)
        fields = {f: g.data[f][0, :g.plan.L] for f in cd}
        ext = tuple(torch.tensor(e, dtype=F32) for e in ex)

        def run(form):
            return rx.bulk_pass(spec, kern, fields, ext, gen_form=form)

        want = rx.bulk_pass_plain(spec, kern, fields, ext)
    return run, want, flux, spec.gen_table


def _ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def measure(case, iters, device):
    """One case's forms: ``{"case", "ms": {label: [ms, ms]}, "rule"}``."""
    from .ops import flux_gen

    run, want, flux, table = setup(case, device)
    rule = flux_gen.gen_form(flux, table, _CASES[case][5])
    got = {}
    todo = forms(case, rule)
    for form in todo + todo[::-1]:
        out = run(form)
        if not all(torch.equal(out[f], want[f]) for f in want):
            raise RuntimeError(f"case {case} form {label(form)} differs "
                               f"from the plain pass")
        got.setdefault(label(form), []).append(
            _ms(lambda: run(form), iters))
    return {"case": case, "ms": got, "rule": label(rule)}


def sources(cases, device):
    """Write every case's sources, one a form, into the build directory:
    their names, for one batch of nvcc processes."""
    from . import DEFAULT_NEIGHBORHOOD_ID, Grid
    from .ops import _build, flux_gen

    names = []
    for case in cases:
        _make, cd, fout, ex, hood_len, _n = _CASES[case]
        g = (Grid(cell_data={"u": F32}).set_initial_length((5, 5, 5))
             .set_periodic(True, True, True).set_maximum_refinement_level(0)
             .set_neighborhood_length(hood_len).initialize("cpu"))
        hood = g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID]
        table = flux_gen.SlotTable(hood.closed_form["offsets"],
                                   hood.offs_const)
        flux = flux_gen.lower(_kernel(case), tuple(cd), fout, cd, len(ex),
                              target="cuda", batched=case == "d")
        for form in forms(case, flux_gen.gen_form(flux, table, _n)):
            names.append(_build.write_generated(
                flux_gen.source(flux, table, form)))
    return list(dict.fromkeys(names))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=list(_CASES),
                    choices=list(_CASES))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gen_tile_rule needs a CUDA device", file=sys.stderr)
        return 2
    from .ops import _build

    device = torch.device("cuda", 0)
    card = _card()
    names = sources(args.cases, device)
    took = {}
    for i in range(0, len(names), 16):  # 16 nvcc processes at a time
        _build.finish(_build.start(names[i:i + 16]), took)
    if took:
        print(json.dumps({"sources": len(names), "built": len(took),
                          "nvcc_s": [min(took.values()),
                                     max(took.values())]}), flush=True)
    lines = []
    for case in args.cases:
        res = measure(case, args.iters, device)
        res["card"] = card
        lines.append(json.dumps(res))
        print(lines[-1], flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
