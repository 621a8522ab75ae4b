"""A grid whose partitions span processes: two real ranks of a gloo
group on localhost, each holding and stepping only its own two of four
CPU partitions (``Grid.initialize(coord.rank_devices(2, "cpu"))``).

The reference side runs here, in the test process: ``dccrg_tpu``'s
``Grid`` on a mesh of 4 of the 8 virtual host devices the conftest
forces, for the steps, the game of life, the exchange and split phase,
the save, the AMR commit and the balance. The port runs twice more: in this process on four partitions
of one process (the bit-for-bit yardstick of the partitioned port), and
in the two ranks, which start once for every scenario of the file and
write each case's held rows to ``<case>_<rank>.npz``. Each rank's held
rows are compared with the same partitions' rows of the one-process
run and of the reference, every row of the held partitions (ghost rows
included), so a halo row that crossed ranks wrongly shows.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dccrg_tpu.grid import Grid as RefGrid
from dccrg_tpu.models.advection import GridAdvection as RefAdvection
from dccrg_tpu.models.advection import \
    make_uniform_flux_kernel as ref_flux_kernel
from dccrg_tpu.models.game_of_life import GameOfLife as RefLife

from dccrg_tpu_torch import comm, distamr, integrity
from dccrg_tpu_torch.convert import fields_from_numpy
from dccrg_tpu_torch.models.game_of_life import GameOfLife

from torch_ranks_fixture import HELD, collect_ranks, start_ranks

N = 12  # GridAdvection(n=12): 12^3 cells, four block slabs of 3 planes
STEPS = 8
ADV_CASES = [(part, ov) for part in ("block", "morton") for ov in ("0", "1")]
LIFE_LEN = (12, 10, 1)
GLIDER = [1 + x + 12 * y for x, y in ((1, 0), (2, 1), (0, 2), (1, 2), (2, 2))]
BLINKER = [1 + x + 12 * 6 for x in (6, 7, 8)]

# the pieces both the ranks and this process build the same way
_COMMON = r'''
import numpy as np
import torch
from dccrg_tpu_torch import Grid
from dccrg_tpu_torch.models.advection import (GridAdvection,
                                              make_uniform_flux_kernel)

N, STEPS = 12, 8


def adv_grid(partition, device):
    """The main path's grid: GridAdvection on block, the same grid and
    kernel on another partition."""
    if partition == "block":
        a = GridAdvection(n=N, device=device)
        return a.grid, a._kernel, a
    dx = 1.0 / N
    g = (Grid(cell_data={"density": torch.float32, "vx": torch.float32,
                         "vy": torch.float32})
         .set_initial_length((N, N, N)).set_periodic(True, True, False)
         .set_maximum_refinement_level(0).set_neighborhood_length(0)
         .set_geometry("cartesian", start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(dx, dx, 1.0 / N))
         .initialize(device, partition=partition))
    return g, make_uniform_flux_kernel((dx, dx, 1.0 / N)), None


def exch_grid(device):
    g = (Grid(cell_data={"v": torch.float32, "n": torch.int32,
                         "p": ((3,), torch.float32)})
         .set_initial_length((6, 5, 8)).set_periodic(True, False, True)
         .set_neighborhood_length(1).initialize(device, partition="morton"))
    return g


def exch_values(cells, salt):
    v = ((cells * 7 + salt) % 23).astype(np.float32) * 0.25
    n = ((cells * 5 + salt) % 9).astype(np.int32)
    p = np.stack([v, v * 2, v + 1], axis=1).astype(np.float32)
    return {"v": v, "n": n, "p": p}


def amr_grid(device):
    g = (Grid(cell_data={"v": torch.float32, "w": torch.int32})
         .set_initial_length((8, 8, 4)).set_maximum_refinement_level(1)
         .set_neighborhood_length(1).initialize(device, partition="block"))
    cells = g.plan.cells
    g.set_many(cells, {"v": (cells % np.uint64(11)).astype(np.float32),
                       "w": (cells % np.uint64(7)).astype(np.int32)})
    g.update_copies_of_remote_neighbors()
    return g


def amr_picks(g):
    return [int(c) for c in g.plan.cells[::9]]


POISSON_MODES = [(False, "0"), (True, "0"), (True, "1")]  # fused, overlap


def poisson_solves(device):
    """tests/test_poisson.py's 3-D residual case on four partitions,
    by the host loop and the fused solve with the overlap off and on:
    {mode: (iterations, this process's cells, their solution)}."""
    import os

    from dccrg_tpu_torch.models.poisson import PoissonSolver

    out = {}
    for fused, ov in POISSON_MODES:
        os.environ["DCCRG_OVERLAP"] = ov
        s = PoissonSolver((8, 8, 8), device=device, dtype=torch.float32)
        s.set_rhs(np.random.default_rng(0).standard_normal(512)
                  .astype(np.float32))
        info = s.solve(rtol=1e-5, max_iterations=2000, fused=fused)
        g = s.grid
        mine = g._owned_subset(g.get_cells())
        out[f"{int(fused)}{ov}"] = (int(info["iterations"]), mine,
                                    g.get("solution", mine))
    return out
'''

_WORKER = _COMMON + r'''
import json, os, sys
from dccrg_tpu_torch import coord, integrity
from dccrg_tpu_torch.convert import fields_from_numpy
from dccrg_tpu_torch.models.game_of_life import GameOfLife

r, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
coord.distributed_init(f"127.0.0.1:{port}", 2, r, retries=20, backoff=0.1)
os.environ["DCCRG_BARRIER_TIMEOUT"] = "60"
PLACE = coord.rank_devices(2, "cpu")
seed = np.load(os.path.join(out_dir, "seed.npz"))
res = {}


def dump(case, g, fields=None, **extra):
    arrs = {f"data_{n}": g.data[n].numpy() for n in (fields or g.fields)}
    np.savez(os.path.join(out_dir, f"{case}_{r}.npz"), held=g._held, **arrs)
    res[case] = dict({n: list(g.data[n].shape) for n in g.data}, **extra)


for part, ov in [("block", "0"), ("block", "1"), ("morton", "0"),
                 ("morton", "1")]:
    os.environ["DCCRG_OVERLAP"] = ov
    g, kern, app = adv_grid(part, PLACE)
    fields_from_numpy(g, {f: seed[f"{part}_{f}"]
                          for f in ("density", "vx", "vy")})
    dt = float(seed["dt"])
    g.run_steps(kern, ["density", "vx", "vy"], ["density"], STEPS,
                extra_args=(torch.tensor(dt, dtype=torch.float32),))
    extra = {"overlap": g.last_overlap["mode"], "path": g.last_step_path}
    if app is not None:
        app.time = STEPS * dt
        extra["l2"] = app.l2_error()
    dump(f"adv_{part}_{ov}", g, ["density"], **extra)

os.environ["DCCRG_OVERLAP"] = "0"
life = GameOfLife((12, 10, 1), periodic=(True, True, False), device=PLACE,
                  partition="morton")
life.set_alive([int(c) for c in seed["life_alive"]])
for _ in range(4):
    life.step()
dump("life_step", life.grid)
life.run(4)
dump("life_run", life.grid, alive=life.alive_cells().tolist())

g = exch_grid(PLACE)
cells = g.plan.cells
g.set_many(cells, exch_values(cells, 0))
g.update_copies_of_remote_neighbors()
dump("exch_update", g)
g.set_many(cells, exch_values(cells, 5))
g.start_remote_neighbor_copy_updates(fields=["v", "p"])
mine = cells[g._proc_local_dev[g.plan.owner]]
# a local-row write between start and wait survives the wait
g.set("n", mine[:3], np.full(3, 77, np.int32))
g.wait_remote_neighbor_copy_updates()
dump("exch_split", g)
from dccrg_tpu_torch import comm
x = (g._held[:, None] * 10 + np.arange(3)[None, :]).astype(np.float32)
res["comm"] = {"some": comm.host_some_reduce(g, x,
                                             g.neighbor_devices()).tolist(),
               "sum": comm.host_all_reduce(g, x).tolist(),
               "max": comm.host_all_reduce(g, x, "max").tolist(),
               "gather": comm.host_all_gather(g, x)[0].tolist()}
foreign = cells[~g._proc_local_dev[g.plan.owner]][:2]
try:
    g.get("v", foreign)
    res["foreign"] = "read"
except KeyError:
    res["foreign"] = "KeyError"

from dccrg_tpu_torch import resilience

os.environ["DCCRG_OVERLAP"] = "0"
g, kern, app = adv_grid("block", PLACE)
fields_from_numpy(g, {f: seed[f"block_{f}"] for f in ("density", "vx", "vy")})
fn = os.path.join(out_dir, "ranks.dc")
resilience.save_checkpoint(g, fn)
res["verify"] = resilience.verify_checkpoint(fn)
# the same save from a freeze_grid_mp snapshot on a writer thread
from dccrg_tpu_torch import background
frozen = background.freeze_grid_mp(g)
saver = background.AsyncSaver()
saver.submit(lambda: resilience.save_checkpoint(
    frozen, os.path.join(out_dir, "ranks_async.dc")))
saver.drain()
back, _k, _a = adv_grid("block", PLACE)
back.load_grid_data(fn)
# a load repartitions by the load balancing method: rows by cell id
mine = back.plan.cells[back._proc_local_dev[back.plan.owner]]
np.savez(os.path.join(out_dir, f"load_{r}.npz"), ids=mine,
         **{f: back.get(f, mine) for f in ("density", "vx", "vy")})
res["load"] = {n: list(t.shape) for n, t in back.data.items()}

g = amr_grid(PLACE)
group = g.enable_distributed_amr(timeout=60)
for c in amr_picks(g):
    if g._proc_local_dev[g.plan.owner[np.searchsorted(g.plan.cells,
                                                       np.uint64(c))]]:
        g.refine_completely(c)
new = g.stop_refining()
g.assign_children_from_parents()
g.update_copies_of_remote_neighbors()
from dccrg_tpu_torch import distamr
dump("amr", g, new=int(len(new)), pdig=distamr.plan_digest(g.plan),
     cells=g.plan.cells.tolist(), owner=g.plan.owner.tolist())

g, kern, app = adv_grid("block", PLACE)
fields_from_numpy(g, {f: seed[f"block_{f}"] for f in ("density", "vx", "vy")})
fp0 = integrity.grid_fingerprint(g)
g.set_load_balancing_method("rcb")
g.balance_load()
fp1 = integrity.grid_fingerprint(g)
g.update_copies_of_remote_neighbors()
dt = float(seed["dt"])
g.run_steps(kern, ["density", "vx", "vy"], ["density"], STEPS,
            extra_args=(torch.tensor(dt, dtype=torch.float32),))
dump("balance", g, fp0=fp0, fp1=fp1, owner=g.plan.owner.tolist(),
     path=g.last_step_path)

from dccrg_tpu_torch import telemetry
res["bytes"] = {leg: telemetry.registry().counter_total(
    "dccrg_rank_bytes_total", leg=leg) for leg in ("halo", "rows", "gather")}
for mode, (its, ids, sol) in poisson_solves(PLACE).items():
    np.savez(os.path.join(out_dir, f"poisson{mode}_{r}.npz"), ids=ids,
             sol=sol, its=its)
os.environ["DCCRG_OVERLAP"] = "0"
print("RESULT " + json.dumps(res), flush=True)
try:
    coord.barrier("end", timeout=60)
except Exception:
    pass
os._exit(0)
'''

_ns: dict = {}
exec(compile(_COMMON, "<ranks common>", "exec"), _ns)
adv_grid, exch_grid, exch_values = (_ns["adv_grid"], _ns["exch_grid"],
                                    _ns["exch_values"])
amr_grid, amr_picks = _ns["amr_grid"], _ns["amr_picks"]
poisson_solves, POISSON_MODES = _ns["poisson_solves"], _ns["POISSON_MODES"]


def mesh_of(n):
    return Mesh(np.array(jax.devices()[:n]), ("dev",))


def _ref_exch_grid():
    """``exch_grid`` on the reference's 4-device mesh."""
    return (RefGrid(cell_data={"v": jnp.float32, "n": jnp.int32,
                               "p": ((3,), jnp.float32)})
            .set_initial_length((6, 5, 8)).set_periodic(True, False, True)
            .set_neighborhood_length(1)
            .initialize(mesh_of(4), partition="morton"))


def _ref_amr_grid():
    """``amr_grid`` on the reference's 4-device mesh."""
    g = (RefGrid(cell_data={"v": jnp.float32, "w": jnp.int32})
         .set_initial_length((8, 8, 4)).set_maximum_refinement_level(1)
         .set_neighborhood_length(1).initialize(mesh_of(4), partition="block"))
    cells = g.plan.cells
    g.set_many(cells, {"v": (cells % np.uint64(11)).astype(np.float32),
                       "w": (cells % np.uint64(7)).astype(np.int32)})
    g.update_copies_of_remote_neighbors()
    return g


def _ref_adv(partition):
    """The reference's 4-device run: its state before and after."""
    if partition == "block":
        ref = RefAdvection(n=N, mesh=mesh_of(4))
        g, kern = ref.grid, ref._kernel
    else:
        dx = 1.0 / N
        seed_from = RefAdvection(n=N, mesh=mesh_of(1))
        g = (RefGrid(cell_data={"density": jnp.float32, "vx": jnp.float32,
                                "vy": jnp.float32})
             .set_initial_length((N, N, N)).set_periodic(True, True, False)
             .set_maximum_refinement_level(0).set_neighborhood_length(0)
             .set_geometry("cartesian", start=(0.0, 0.0, 0.0),
                           level_0_cell_length=(dx, dx, 1.0 / N))
             .initialize(mesh_of(4), partition=partition))
        cells = g.plan.cells
        g.set_many(cells, {f: seed_from.grid.get(f, cells)
                           for f in ("density", "vx", "vy")})
        g.update_copies_of_remote_neighbors()
        kern = ref_flux_kernel((dx, dx, 1.0 / N))
    start = {f: np.asarray(g.data[f]) for f in ("density", "vx", "vy")}
    return g, kern, start


def _host(g, fields):
    return {f: np.asarray(g.data[f]).copy() for f in fields}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every side's results: the reference's and the one-process
    port's in this process, the two ranks' from their files."""
    out = tmp_path_factory.mktemp("ranks")
    dt = 0.5 * RefAdvection(n=N, mesh=mesh_of(1)).max_time_step()
    seed, ref, one = {"dt": np.float64(dt)}, {}, {}
    for part, ov in ADV_CASES:
        if ov == "0":
            g, kern, start = _ref_adv(part)
            for f, a in start.items():
                seed[f"{part}_{f}"] = a
            if part == "block":
                # the saved state and the balance's start, by cell id
                g.save_grid_data(str(out / "ref.dc"))
                ref["block_cells"] = g.plan.cells
                ref["block_start"] = {f: g.get(f, g.plan.cells)
                                      for f in ("density", "vx", "vy")}
            g.run_steps(kern, ["density", "vx", "vy"], ["density"], STEPS,
                        extra_args=(jnp.float32(dt),))
            ref[part] = np.asarray(g.data["density"])
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DCCRG_OVERLAP", ov)
            pg, pkern, app = adv_grid(part, ["cpu"] * 4)
            fields_from_numpy(pg, {f: seed[f"{part}_{f}"]
                                   for f in ("density", "vx", "vy")})
            pg.run_steps(pkern, ["density", "vx", "vy"], ["density"], STEPS,
                         extra_args=(torch.tensor(dt, dtype=torch.float32),))
            one[f"adv_{part}_{ov}"] = {"density": pg.data["density"].numpy(),
                                       "mode": pg.last_overlap["mode"]}
            if app is not None:
                app.time = STEPS * dt
                one[f"l2_{ov}"] = app.l2_error()
    seed["life_alive"] = np.asarray(GLIDER + BLINKER, dtype=np.uint64)
    np.savez(out / "seed.npz", **seed)

    procs = start_ranks(_WORKER, out)

    # meanwhile: the reference's and the one-process port's other cases
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DCCRG_OVERLAP", "0")
        rl = RefLife(LIFE_LEN, periodic=(True, True, False), mesh=mesh_of(4),
                     partition="morton")
        pl = GameOfLife(LIFE_LEN, periodic=(True, True, False),
                        device=["cpu"] * 4, partition="morton")
        for g in (rl, pl):
            g.set_alive(GLIDER + BLINKER)
            for _ in range(4):
                g.step()
        ref["life_step"] = {f: np.asarray(rl.grid.data[f])
                            for f in ("live", "total")}
        one["life_step"] = {f: pl.grid.data[f].numpy()
                            for f in ("live", "total")}
        for g in (rl, pl):
            g.run(4)
        ref["life_run"] = {f: np.asarray(rl.grid.data[f])
                           for f in ("live", "total")}
        one["life_run"] = {f: pl.grid.data[f].numpy()
                           for f in ("live", "total")}
        one["alive"] = pl.alive_cells()

        g = exch_grid(["cpu"] * 4)
        cells = g.plan.cells
        g.set_many(cells, exch_values(cells, 0))
        g.update_copies_of_remote_neighbors()
        one["exch_update"] = {n: t.numpy().copy() for n, t in g.data.items()}
        g.set_many(cells, exch_values(cells, 5))
        g.start_remote_neighbor_copy_updates(fields=["v", "p"])
        mine = {r: cells[np.isin(g.plan.owner, HELD[r])] for r in HELD}
        for r in HELD:
            g.set("n", mine[r][:3], np.full(3, 77, np.int32))
        g.wait_remote_neighbor_copy_updates()
        one["exch_split"] = {n: t.numpy().copy() for n, t in g.data.items()}
        x = (np.arange(4)[:, None] * 10
             + np.arange(3)[None, :]).astype(np.float32)
        devs = ["cpu"] * 4
        one["comm"] = {
            "some": comm.host_some_reduce(devs, x, g.neighbor_devices()),
            "sum": comm.host_all_reduce(devs, x),
            "max": comm.host_all_reduce(devs, x, "max"),
            "gather": comm.host_all_gather(devs, x)[0]}

        g, _kern, _app = adv_grid("block", ["cpu"] * 4)
        fields_from_numpy(g, {f: seed[f"block_{f}"]
                              for f in ("density", "vx", "vy")})
        g.save_grid_data(str(out / "one.dc"))
        one["load_src"] = {f: g.get(f, g.plan.cells)
                           for f in ("density", "vx", "vy")}
        one["load_cells"] = g.plan.cells

        g = amr_grid(["cpu"] * 4)
        for c in amr_picks(g):
            g.refine_completely(c)
        new = g.stop_refining()
        g.assign_children_from_parents()
        g.update_copies_of_remote_neighbors()
        one["amr"] = {"new": len(new), "pdig": distamr.plan_digest(g.plan),
                      "cells": g.plan.cells, "owner": g.plan.owner,
                      "data": {n: t.numpy().copy() for n, t in g.data.items()}}

        g, kern, _app = adv_grid("block", ["cpu"] * 4)
        fields_from_numpy(g, {f: seed[f"block_{f}"]
                              for f in ("density", "vx", "vy")})
        fp0 = integrity.grid_fingerprint(g)
        g.set_load_balancing_method("rcb")
        g.balance_load()
        g.update_copies_of_remote_neighbors()
        g.run_steps(kern, ["density", "vx", "vy"], ["density"], STEPS,
                    extra_args=(torch.tensor(dt, dtype=torch.float32),))
        one["balance"] = {"fp0": fp0, "owner": g.plan.owner,
                          "data": {n: t.numpy().copy()
                                   for n, t in g.data.items()}}

        one["poisson"] = poisson_solves(["cpu"] * 4)

        # the reference's exchange and split phase, AMR commit and balance
        rg = _ref_exch_grid()
        cells = rg.plan.cells
        rg.set_many(cells, exch_values(cells, 0))
        rg.update_copies_of_remote_neighbors()
        ref["exch_update"] = _host(rg, ("v", "n", "p"))
        rg.set_many(cells, exch_values(cells, 5))
        rg.start_remote_neighbor_copy_updates(fields=["v", "p"])
        for r in HELD:
            rg.set("n", cells[np.isin(rg.plan.owner, HELD[r])][:3],
                   np.full(3, 77, np.int32))
        rg.wait_remote_neighbor_copy_updates()
        ref["exch_split"] = _host(rg, ("v", "n", "p"))

        rg = _ref_amr_grid()
        for c in amr_picks(rg):
            rg.refine_completely(c)
        new = rg.stop_refining()
        rg.assign_children_from_parents()
        rg.update_copies_of_remote_neighbors()
        ref["amr"] = {"new": len(new), "cells": rg.plan.cells,
                      "owner": rg.plan.owner, "data": _host(rg, ("v", "w"))}

        ra = RefAdvection(n=N, mesh=mesh_of(4))
        rg = ra.grid
        np.testing.assert_array_equal(rg.plan.cells, ref["block_cells"])
        rg.set_many(rg.plan.cells, ref["block_start"])
        rg.update_copies_of_remote_neighbors()
        rg.set_load_balancing_method("rcb")
        rg.balance_load()
        rg.update_copies_of_remote_neighbors()
        rg.run_steps(ra._kernel, ["density", "vx", "vy"], ["density"], STEPS,
                     extra_args=(jnp.float32(dt),))
        ref["balance"] = {"owner": rg.plan.owner,
                          "data": _host(rg, ("density", "vx", "vy"))}

    res = collect_ranks(procs)

    def held(case, r):
        return dict(np.load(out / f"{case}_{r}.npz"))

    return {"out": out, "ref": ref, "one": one, "res": res, "held": held}


def _assert_held_rows(runs, case, want, fields):
    """Each rank's field tensors are its two partitions' rows of
    ``want`` (``{field: [4, R, ...]}``), every row bit for bit."""
    for r in HELD:
        got = runs["held"](case, r)
        np.testing.assert_array_equal(got["held"], HELD[r])
        for f in fields:
            a, b = got[f"data_{f}"], np.asarray(want[f])[list(HELD[r])]
            assert a.shape[0] == 2, (case, f, a.shape)
            np.testing.assert_array_equal(
                a.view(np.uint8), np.ascontiguousarray(b).view(np.uint8),
                err_msg=f"{case} rank {r} {f}")


def test_ranks_hold_only_their_partitions(runs):
    """Every field tensor of a rank has a leading dimension of 2, its
    held partitions; the one-process grid's has 4."""
    for r in HELD:
        for case, shapes in runs["res"][r].items():
            if isinstance(shapes, dict) and "density" in shapes:
                assert shapes["density"][0] == 2, (case, shapes)
    assert runs["one"]["adv_block_0"]["density"].shape[0] == 4


@pytest.mark.parametrize("part,ov", ADV_CASES)
def test_advection_steps_bitwise_across_ranks(runs, part, ov):
    """8 steps of the main path's kernel, overlap off and on, on block
    and morton: each rank's rows equal the reference's 4-device mesh
    and the port's one-process four-partition run bit for bit."""
    case = f"adv_{part}_{ov}"
    for r in HELD:
        extra = runs["res"][r][case]
        assert extra["path"] == ("roll" if part == "block" else "table")
        # the overlap decision is the one process's (a morton grid this
        # small is mostly outer rows, where the overlap cannot pay)
        assert extra["overlap"] == runs["one"][case]["mode"]
        if part == "block":
            assert extra["overlap"] == ("off" if ov == "0" else "full")
    _assert_held_rows(runs, case, {"density": runs["ref"][part]},
                      ["density"])
    _assert_held_rows(runs, case, runs["one"][case], ["density"])


def test_l2_reduced_across_ranks(runs):
    """The L2 error is each rank's sum reduced over the group: both
    ranks read the one-process figure within rtol 1e-6."""
    for ov in ("0", "1"):
        want = runs["one"][f"l2_{ov}"]
        for r in HELD:
            got = runs["res"][r][f"adv_block_{ov}"]["l2"]
            assert abs(got - want) <= 1e-6 * want, (ov, r, got, want)


@pytest.mark.parametrize("case", ["life_step", "life_run"])
def test_game_of_life_bitwise_across_ranks(runs, case):
    """4 turns by the exchange and apply_stencil, then 4 through the
    step loop, on morton partitions: the reference's rows bit for bit,
    and the union of the ranks' live cells is the one process's."""
    _assert_held_rows(runs, case, runs["ref"][case], ["live", "total"])
    _assert_held_rows(runs, case, runs["one"][case], ["live", "total"])
    if case == "life_run":
        alive = np.sort(np.concatenate(
            [np.asarray(runs["res"][r]["life_run"]["alive"], np.uint64)
             for r in HELD]))
        np.testing.assert_array_equal(alive, runs["one"]["alive"])


@pytest.mark.parametrize("case", ["exch_update", "exch_split"])
def test_exchange_lands_every_ghost_row(runs, case):
    """``update_copies_of_remote_neighbors`` and the split-phase start
    and wait (a local write in between kept) land every ghost row of a
    float, an int and a vector field bit for bit: the reference's
    4-device mesh and the one-process run."""
    _assert_held_rows(runs, case, runs["ref"][case], ["v", "n", "p"])
    _assert_held_rows(runs, case, runs["one"][case], ["v", "n", "p"])


def test_host_reductions_across_ranks(runs):
    """``comm``'s host forms on a grid whose partitions span ranks: each
    rank's peer-set sums are the one-process ones of its partitions, and
    the sum, the max and the all-gather are the one process's."""
    want = runs["one"]["comm"]
    for r in HELD:
        got = runs["res"][r]["comm"]
        np.testing.assert_array_equal(np.asarray(got["some"], np.float32),
                                      want["some"][list(HELD[r])])
        for k in ("sum", "max", "gather"):
            np.testing.assert_array_equal(np.asarray(got[k], np.float32),
                                          want[k], err_msg=k)


@pytest.mark.parametrize("fused,ov", POISSON_MODES)
def test_poisson_dots_reduced_across_ranks(runs, fused, ov):
    """``PoissonSolver`` on four partitions over two ranks, its dot
    products summed over the group: the one process's iterations (within
    2) and solution (rtol 1e-5, atol 1e-6: the dots add their partition
    sums in another order), by the host loop and the fused solve with
    the overlap off and on."""
    mode = f"{int(fused)}{ov}"
    its, cells, sol = runs["one"]["poisson"][mode]
    seen = []
    for r in HELD:
        got = runs["held"](f"poisson{mode}", r)
        assert abs(int(got["its"]) - its) <= 2
        pos = np.searchsorted(cells, got["ids"])
        np.testing.assert_allclose(got["sol"], sol[pos], rtol=1e-5,
                                   atol=1e-6)
        seen.append(got["ids"])
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)), cells)


def test_foreign_get_raises(runs):
    for r in HELD:
        assert runs["res"][r]["foreign"] == "KeyError"


def test_rows_crossed_ranks(runs):
    """Halo rows crossed by the point-to-point exchange, moved rows by
    the all-to-all and preserved rows by the gather, on both ranks."""
    for r in HELD:
        b = runs["res"][r]["bytes"]
        assert b.get("halo", 0) > 0 and b.get("rows", 0) > 0, b
        assert b.get("gather", 0) > 0, b


def test_placement_rules():
    """A placement names ranks of the group: without one, a second rank
    is refused; a plain entry is this process's; every entry on this
    rank is a one-process grid; distinct devices of one rank keep each
    its own device (``coord.rank_devices`` with a list of a rank's
    devices), and a ``meta`` device is refused."""
    from dccrg_tpu_torch import coord
    from dccrg_tpu_torch.grid import resolve_placement

    assert coord.rank_devices(2, "cpu") == [(0, "cpu"), (0, "cpu")]
    assert coord.rank_devices(2, ["cpu:0", "cpu:1"]) == \
        [(0, "cpu:0"), (0, "cpu:1")]
    with pytest.raises(ValueError, match="3 devices for 2 partitions"):
        coord.rank_devices(2, ["cpu:0", "cpu:1", "cpu:2"])
    with pytest.raises(ValueError, match="process group has 1 rank"):
        resolve_placement([(0, "cpu"), (0, "cpu"), (1, "cpu"), (1, "cpu")])
    devs, ranks = resolve_placement([(0, "cpu"), "cpu"])
    assert ranks is None and [str(d) for d in devs] == ["cpu", "cpu"]
    devs, ranks = resolve_placement([(0, "cpu:1"), "cpu:0", (0, "cpu:1")])
    assert ranks is None
    assert [str(d) for d in devs] == ["cpu:1", "cpu:0", "cpu:1"]
    with pytest.raises(ValueError, match="meta"):
        resolve_placement([(0, "cpu"), (0, "meta")])


def test_two_phase_save_and_load_from_held_storage(runs):
    """The ranks' two-phase save, synchronous and from a
    ``freeze_grid_mp`` snapshot on a writer thread, is byte for byte the
    one-process file and the reference's save of the same state, and
    each rank's load gives back its own rows bit for bit (the owned rows
    a file holds)."""
    out = runs["out"]
    one = (out / "one.dc").read_bytes()
    assert one == (out / "ref.dc").read_bytes()
    assert (out / "ranks.dc").read_bytes() == one
    assert (out / "ranks_async.dc").read_bytes() == one
    for r in HELD:
        assert runs["res"][r]["verify"] == []
    src, cells = runs["one"]["load_src"], runs["one"]["load_cells"]
    got_ids = []
    for r in HELD:
        got = runs["held"]("load", r)
        assert runs["res"][r]["load"]["density"][0] == 2
        pos = np.searchsorted(cells, got["ids"])
        got_ids.append(got["ids"])
        for f in ("density", "vx", "vy"):
            np.testing.assert_array_equal(got[f], src[f][pos],
                                          err_msg=f"load rank {r} {f}")
    np.testing.assert_array_equal(np.sort(np.concatenate(got_ids)), cells)


def test_distributed_amr_commit_across_ranks(runs):
    """A distributed AMR commit, each rank requesting its own cells:
    the reference's one-process commit on its 4-device mesh and the
    port's: the cell set, owners and plan bit for bit, and the payload
    (children from their parents, ghosts exchanged)."""
    want, rwant = runs["one"]["amr"], runs["ref"]["amr"]
    assert rwant["new"] == want["new"]
    for r in HELD:
        res = runs["res"][r]["amr"]
        assert res["new"] == want["new"]
        assert res["pdig"] == want["pdig"]
        for w in (want, rwant):
            np.testing.assert_array_equal(
                np.asarray(res["cells"], np.uint64), w["cells"])
            np.testing.assert_array_equal(np.asarray(res["owner"]),
                                          w["owner"])
    _assert_held_rows(runs, "amr", rwant["data"], ["v", "w"])
    _assert_held_rows(runs, "amr", want["data"], ["v", "w"])


def test_balance_moves_rows_across_ranks(runs):
    """``balance_load`` from block to rcb moves rows between the ranks
    with the fingerprint unchanged, and the owners and 8 later steps are
    bit for bit the reference's 4-device run and the one-process run."""
    want, rwant = runs["one"]["balance"], runs["ref"]["balance"]
    for r in HELD:
        res = runs["res"][r]["balance"]
        fp = {k: tuple(v) for k, v in res["fp0"].items()}
        assert fp == want["fp0"]
        assert {k: tuple(v) for k, v in res["fp1"].items()} == want["fp0"]
        for w in (want, rwant):
            np.testing.assert_array_equal(np.asarray(res["owner"]),
                                          w["owner"])
        assert res["path"] == "table"
    fields = ["density", "vx", "vy"]
    _assert_held_rows(runs, "balance", rwant["data"], fields)
    _assert_held_rows(runs, "balance", want["data"], fields)
