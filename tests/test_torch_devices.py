"""One grid's partitions on distinct devices of one process (the
reference's mesh of several devices, ``Mesh(np.array(devices))``).

The CPU names distinct host devices ``cpu:0``, ``cpu:1``, ... (a tensor
made on ``cpu:1`` reports ``cpu``, and a copy between them is a real
copy), as the reference's tests force XLA host devices. Two placements,
one partition per device and two partitions per device, are held bit
for bit to the one-device grid on the same four partitions
(``["cpu"] * 4``), every comparison starting from one uploaded state,
and to the reference's four-device mesh within the tolerances of
``tests/test_torch_multidevice.py``. Every grid asserts that no two of
its storage groups share memory."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dccrg_tpu import checkpoint as ref_ckpt
from dccrg_tpu import integrity as ref_integrity
from dccrg_tpu.dense import dense_mesh as ref_dense_mesh
from dccrg_tpu.grid import Grid as RefGrid
from dccrg_tpu.models.advection import AdvectionSolver as RefAdvSolver
from dccrg_tpu.models.advection import GridAdvection as RefAdvection
from dccrg_tpu.models.game_of_life import GameOfLife as RefLife
from dccrg_tpu.models.poisson import DensePoissonSolver as RefDensePoisson
from dccrg_tpu.models.poisson import PoissonSolver as RefPoisson

from dccrg_tpu_torch import (MutationAbortedError, checkpoint, integrity,
                             resilience, telemetry)
from dccrg_tpu_torch.convert import fields_from_numpy, fields_to_numpy
from dccrg_tpu_torch.dense import dense_mesh
from dccrg_tpu_torch.faults import FaultPlan
from dccrg_tpu_torch.grid import DEFAULT_NEIGHBORHOOD_ID as HID
from dccrg_tpu_torch.grid import Grid, Grouped
from dccrg_tpu_torch.models.advection import AdvectionSolver, GridAdvection
from dccrg_tpu_torch.models.game_of_life import GameOfLife
from dccrg_tpu_torch.models.poisson import DensePoissonSolver, PoissonSolver
from dccrg_tpu_torch.txn import grid_state_bytes

ONE = ["cpu"] * 4
PLACES = {"spread": ["cpu:0", "cpu:1", "cpu:2", "cpu:3"],
          "pairs": ["cpu:0", "cpu:0", "cpu:1", "cpu:1"]}
DIMS = (6, 5, 8)

places = pytest.mark.parametrize("place", sorted(PLACES))


def mesh_of(n):
    return Mesh(np.array(jax.devices()[:n]), ("dev",))


def make(devs, length=DIMS, partition="morton", hood_len=1,
         periodic=(True, True, False), fields=("v", "w"), max_lvl=0):
    return (Grid(cell_data={f: torch.float32 for f in fields})
            .set_initial_length(length).set_periodic(*periodic)
            .set_maximum_refinement_level(max_lvl)
            .set_neighborhood_length(hood_len)
            .initialize(devs, partition=partition))


def seed(g, fields=("v", "w"), salt=0):
    cells = g.plan.cells
    for i, f in enumerate(fields):
        g.set(f, cells, ((cells * (7 + i) + salt) % 23).astype(np.float32)
              * 0.25)


def held(g, f):
    """Every held row of field ``f`` (ghost and pad rows too), on the
    host, slots in order."""
    return g._to_held(g.data[f]).numpy()


def assert_same(one, got, fields=("v", "w")):
    for f in fields:
        np.testing.assert_array_equal(held(got, f), held(one, f), err_msg=f)


def assert_apart(g):
    """The grid spans its devices, and no two storage groups of any
    field share memory."""
    assert g._grouped
    with pytest.raises(AttributeError, match="span devices"):
        g.device
    assert getattr(g, "device", None) is None
    ptrs = []
    for t in g.data.values():
        assert isinstance(t, Grouped) and len(t.groups) == len(g._groups)
        ptrs += [x.untyped_storage().data_ptr() for x in t.groups]
    assert len(set(ptrs)) == len(ptrs)


def port_kernel(cell, nbr, offs, mask):
    s = torch.sum(torch.where(mask, nbr["v"], 0.0), dim=1)
    return {"v": 0.5 * cell["v"] + 0.125 * s}


def ref_kernel(cell, nbr, offs, mask):
    s = jnp.sum(jnp.where(mask, nbr["v"], 0.0), axis=1)
    return {"v": 0.5 * cell["v"] + 0.125 * s}


@functools.lru_cache(maxsize=None)
def _ref_grid():
    r = (RefGrid(cell_data={"v": jnp.float32, "w": jnp.float32})
         .set_initial_length(DIMS).set_periodic(True, True, False)
         .set_neighborhood_length(1)
         .initialize(mesh_of(4), partition="morton"))
    cells = r.plan.cells
    for i, f in enumerate(("v", "w")):
        r.set(f, cells, ((cells * (7 + i)) % 23).astype(np.float32) * 0.25)
    r.update_copies_of_remote_neighbors()
    out = {"plan": r.plan, "ghosts": {f: np.asarray(r.data[f])
                                      for f in ("v", "w")},
           "fingerprint": ref_integrity.grid_fingerprint(r),
           "digest": ref_ckpt.state_digest(r)}
    r.run_steps(ref_kernel, ["v"], ["v"], 3)
    r.apply_stencil(ref_kernel, ["v"], ["v"])
    out["stepped"] = np.asarray(r.data["v"])
    return out


# ---------------------------------------------------------------------
# placement

def test_placement_groups_and_refusals():
    """Partitions group by device in order of first appearance (``cpu``
    and ``cpu:0`` are one device); a one-device list keeps one tensor
    per field; ``meta`` is refused; distinct devices inside one rank's
    entries keep each its own device, and a grid on them groups its
    partitions as one process's list does."""
    from dccrg_tpu_torch.grid import resolve_placement

    g = make(["cpu:1", "cpu", "cpu:0", "cpu:1"])
    assert [str(x.device) for x in g._groups] == ["cpu:1", "cpu"]
    assert g._gof.tolist() == [0, 1, 1, 0] and g._gpos.tolist() == [0, 0, 1, 1]
    assert [str(g.part_device(p)) for p in range(4)] == \
        ["cpu:1", "cpu", "cpu", "cpu:1"]
    assert_apart(g)
    one = make(["cpu", "cpu:0"])
    assert not one._grouped and isinstance(one.data["v"], torch.Tensor)
    with pytest.raises(ValueError, match="meta"):
        make(["cpu", "meta"])
    devs, ranks = resolve_placement([(0, "cpu:0"), (0, "cpu:1")])
    assert [str(d) for d in devs] == ["cpu:0", "cpu:1"] and ranks is None
    r = make([(0, "cpu:1"), (0, "cpu"), (0, "cpu:0"), (0, "cpu:1")])
    assert [str(x.device) for x in r._groups] == ["cpu:1", "cpu"]
    assert r._gof.tolist() == g._gof.tolist()
    assert_apart(r)
    seed(g)
    seed(r)
    assert_same(g, r)


@places
def test_plan_exchange_tables_and_ghosts(place):
    """The plan is the one-device grid's and the reference's; the
    exchange's legs cover exactly the one-device grid's pairs, split by
    the groups of sender and receiver; the ghost rows after a sync
    exchange are the one-device grid's bit for bit and the
    reference's."""
    one, got = make(ONE), make(PLACES[place])
    assert_apart(got)
    ref = _ref_grid()
    for g in (one, got):
        seed(g)
    for name in ("owner", "n_local", "row_of_pos"):
        np.testing.assert_array_equal(getattr(got.plan, name),
                                      getattr(one.plan, name))
        np.testing.assert_array_equal(getattr(got.plan, name),
                                      getattr(ref["plan"], name))
    for d in range(4):
        np.testing.assert_array_equal(got.plan.ghost_ids[d],
                                      ref["plan"].ghost_ids[d])
    R = got.plan.R
    ex = got._exchange_groups(HID, ("v",))
    pairs = set()
    for leg in ex.legs:
        slots_a = got._groups[leg.a].slots
        slots_b = got._groups[leg.b].slots
        for s, d in zip(leg.src[0].tolist(), leg.dst[0].tolist()):
            pairs.add((int(slots_a[s // R]) * R + s % R,
                       int(slots_b[d // R]) * R + d % R))
    (leg,) = one._exchange_groups(HID, ("v",)).legs
    assert (leg.a, leg.b) == (0, 0)
    want = set(zip(leg.src[0].tolist(), leg.dst[0].tolist()))
    assert pairs == want and len(pairs) == sum(
        leg.src[0].numel() for leg in ex.legs)
    n_cross = sum(leg.src[0].numel() for leg in ex.legs if leg.a != leg.b)
    assert n_cross > 0
    before = telemetry.registry().counter_total(
        "dccrg_rank_bytes_total", leg="device_halo")
    for g in (one, got):
        g.update_copies_of_remote_neighbors()
    assert telemetry.registry().counter_total(
        "dccrg_rank_bytes_total", leg="device_halo") - before == \
        2 * 4 * n_cross
    assert_same(one, got)
    for f in ("v", "w"):
        np.testing.assert_array_equal(held(got, f), ref["ghosts"][f])
    assert integrity.grid_fingerprint(got) == ref["fingerprint"]
    assert checkpoint.state_digest(got) == ref["digest"]


@places
def test_split_phase_step_loop_and_stencil(place, monkeypatch):
    """The split phase (a local write between start and wait
    survives), the step loop with the overlap off and on, and
    ``apply_stencil``: bit for bit with the one-device grid, and with
    the reference's mesh."""
    ref = _ref_grid()
    for ov in ("0", "1"):
        monkeypatch.setenv("DCCRG_OVERLAP", ov)
        one, got = make(ONE), make(PLACES[place])
        for g in (one, got):
            seed(g)
            g.start_remote_neighbor_copy_updates(fields=["v"])
            g.set("w", g.plan.cells[:5], np.arange(5, dtype=np.float32))
            g.wait_remote_neighbor_copy_updates()
        assert_same(one, got)
        for g in (one, got):
            g.update_copies_of_remote_neighbors()
            seed(g, ("w",))
            g.update_copies_of_remote_neighbors(fields=["w"])
            g.run_steps(port_kernel, ["v"], ["v"], 3)
            g.apply_stencil(port_kernel, ["v"], ["v"])
        assert got.last_overlap["mode"] == one.last_overlap["mode"]
        assert_same(one, got)
        np.testing.assert_array_equal(held(got, "v"), ref["stepped"])
        assert_apart(got)


@places
def test_get_and_set_many(place):
    """Reads and writes by cell id, repeated ids (the last value wins),
    a field of rows, a fresh cover: the one-device grid's rows."""
    fields = {"v": torch.float32, "m": ((3,), torch.float32)}
    one, got = (Grid(cell_data=fields).set_initial_length(DIMS)
                .initialize(devs, partition="morton")
                for devs in (ONE, PLACES[place]))
    rng = np.random.default_rng(3)
    cells = one.plan.cells
    ids = rng.choice(cells, 50)
    vals = rng.random(50).astype(np.float32)
    rows = rng.random((len(cells), 3)).astype(np.float32)
    for g in (one, got):
        g.set_many(ids, {"v": vals})
        g.set("m", cells, rows)
        g.set("v", cells[:3], 7.0)
        g.update_copies_of_remote_neighbors()
    assert_same(one, got, ("v", "m"))
    np.testing.assert_array_equal(got.get("m", cells[::-1]), rows[::-1])
    np.testing.assert_array_equal(got.get("v", ids), one.get("v", ids))
    assert got.get("v", cells[1]) == 7.0
    for g in (one, got):
        g.set_many(cells, {"v": np.ones(len(cells), np.float32)},
                   preserve_ghosts=False)
    assert_same(one, got, ("v", "m"))
    assert_apart(got)


# ---------------------------------------------------------------------
# the models

@places
def test_grid_advection_and_game_of_life(place):
    """``GridAdvection`` 8 steps from one uploaded state (the reference's)
    and the game of life: the one-device grid bit for bit (density,
    L2, mass, fingerprint, finite check) and the reference's mesh."""
    ref = RefAdvection(n=12, mesh=mesh_of(4))
    fields = {f: np.asarray(ref.grid.data[f]) for f in ("density", "vx", "vy")}
    runs = []
    for devs in (ONE, PLACES[place]):
        a = GridAdvection(n=12, device=devs)
        fields_from_numpy(a.grid, fields, L=ref.grid.plan.L)
        runs.append(a)
    dt = 0.5 * ref.max_time_step()
    ref.run(8, dt)
    for a in runs:
        a.run(8, dt)
    one, got = runs
    assert_apart(got.grid)
    assert got.grid.last_step_path == "roll"
    assert_same(one.grid, got.grid, ("density", "vx", "vy"))
    np.testing.assert_array_equal(
        fields_to_numpy(got.grid)["density"],
        np.asarray(ref.grid.data["density"]))
    assert got.l2_error() == one.l2_error()
    assert abs(got.l2_error() - ref.l2_error()) <= 1e-5 * ref.l2_error()
    assert got.checksum() == one.checksum()
    assert integrity.grid_fingerprint(got.grid) == \
        integrity.grid_fingerprint(one.grid)
    np.testing.assert_array_equal(
        integrity.conservation_sums(got.grid, ["density"]),
        integrity.conservation_sums(one.grid, ["density"]))
    assert resilience.check_finite(got.grid)
    got.grid.set("density", [np.uint64(5)], [np.nan])
    assert not resilience.check_finite(got.grid)
    with pytest.raises(resilience.NumericsError, match="5"):
        resilience.assert_finite(got.grid)

    rl = RefLife((12, 10, 1), periodic=(True, True, False), mesh=mesh_of(4),
                 partition="morton")
    lives = [GameOfLife((12, 10, 1), periodic=(True, True, False),
                        device=devs, partition="morton")
             for devs in (ONE, PLACES[place])]
    glider = [1 + x + 12 * y for x, y in ((1, 0), (2, 1), (0, 2), (1, 2),
                                          (2, 2))]
    for g in [rl] + lives:
        g.set_alive(glider + [1 + x + 12 * 6 for x in (6, 7, 8)])
        g.step()
        g.run(4)
    assert_same(lives[0].grid, lives[1].grid, ("live", "total"))
    np.testing.assert_array_equal(lives[1].alive_cells(), rl.alive_cells())
    assert_apart(lives[1].grid)


@places
def test_checkpoint_bytes_and_load(place, tmp_path, monkeypatch):
    """The ``.dc`` bytes of a grid spanning devices are the one-device
    grid's (streamed in chunks of 16 cells, so a chunk may hold one
    device's cells alone); a load back onto the placement holds the same
    rows, saves the same bytes, and a frozen copy for a background
    writer too."""
    from dccrg_tpu_torch.background import freeze_grid

    monkeypatch.setattr(checkpoint, "CHUNK", 16)
    one, got = make(ONE), make(PLACES[place])
    for g in (one, got):
        seed(g)
        g.update_copies_of_remote_neighbors()
    f1, f2, f3, f4 = (str(tmp_path / x) for x in ("1", "2", "3", "4"))
    one.save_grid_data(f1, header=b"hd")
    got.save_grid_data(f2, header=b"hd")
    assert open(f1, "rb").read() == open(f2, "rb").read()
    back, hdr = Grid.from_file(f2, {"v": torch.float32, "w": torch.float32},
                               device=PLACES[place], header_size=2)
    assert hdr == b"hd" and [str(x.device) for x in back._groups] == \
        [str(x.device) for x in got._groups]
    assert_apart(back)
    back.update_copies_of_remote_neighbors()
    assert checkpoint.state_digest(back) == checkpoint.state_digest(one)
    back.save_grid_data(f3, header=b"hd")
    assert open(f3, "rb").read() == open(f1, "rb").read()
    snap = freeze_grid(got)
    got.set("v", got.plan.cells, np.zeros(len(got.plan.cells), np.float32))
    snap.save_grid_data(f4, header=b"hd")
    assert open(f4, "rb").read() == open(f1, "rb").read()


@places
def test_amr_commit_balance_and_rollback(place):
    """An AMR commit, a balance and a transaction rolled back: the cell
    sets, owners and every row equal the one-device grid's; a rolled
    back balance leaves the state bytes as they were."""
    one, got = (make(devs, length=(4, 4, 2), periodic=(True, True, True),
                     max_lvl=2) for devs in (ONE, PLACES[place]))
    for g in (one, got):
        seed(g)
        g.refine_completely(int(g.get_cells()[0]))
        g.refine_completely(int(g.get_cells()[9]))
        new = g.stop_refining()
        g.assign_children_from_parents()
        g.update_copies_of_remote_neighbors()
    np.testing.assert_array_equal(got.plan.cells, one.plan.cells)
    np.testing.assert_array_equal(got.plan.owner, one.plan.owner)
    assert len(new) == 16
    assert_same(one, got)
    for g in (one, got):
        g.pin(int(g.get_cells()[-1]), 1)
        g.set_cell_weight(int(g.get_cells()[0]), 2.0)
        g.balance_load()
        g.update_copies_of_remote_neighbors()
    np.testing.assert_array_equal(got.plan.owner, one.plan.owner)
    assert_same(one, got)
    assert_apart(got)
    before = grid_state_bytes(got)
    assert before == grid_state_bytes(one)
    plan = FaultPlan(seed=2)
    plan.mutation_error(site="balance.commit", times=1, phase="land")
    got.set_cell_weight(int(got.get_cells()[3]), 5.0)
    with plan:
        with pytest.raises(MutationAbortedError):
            got.balance_load()
    assert grid_state_bytes(got) == before
    got.update_copies_of_remote_neighbors()
    assert_same(one, got)


@places
@pytest.mark.parametrize("overlap", ["0", "1"])
def test_refined_grid_steps(place, overlap, monkeypatch):
    """Steps of a refined grid (the table path) whose partitions span
    devices, after its commit and again after a balance that moves rows
    between the devices, with the overlap off and on: every row the
    one-device grid's bit for bit, and every cell the reference's
    four-device mesh's to rtol/atol 1e-6 of the peak (the kernel's slot
    sum is a reduction, which XLA and PyTorch order differently, as
    tests/test_torch_amr_partitions_run.py holds it)."""
    monkeypatch.setenv("DCCRG_OVERLAP", overlap)

    def commit(g):
        seed(g)
        g.refine_completely(int(g.get_cells()[0]))
        g.refine_completely(int(g.get_cells()[9]))
        g.stop_refining()
        g.assign_children_from_parents()
        g.update_copies_of_remote_neighbors()

    def balance(g):
        g.pin(int(g.get_cells()[-1]), 1)
        g.set_cell_weight(int(g.get_cells()[0]), 2.0)
        g.balance_load()
        g.update_copies_of_remote_neighbors()

    one, got = (make(devs, length=(4, 4, 2), periodic=(True, True, True),
                     max_lvl=2) for devs in (ONE, PLACES[place]))
    ref = (RefGrid(cell_data={"v": jnp.float32, "w": jnp.float32})
           .set_initial_length((4, 4, 2)).set_periodic(True, True, True)
           .set_maximum_refinement_level(2).set_neighborhood_length(1)
           .initialize(mesh_of(4), partition="morton"))
    for stage in (commit, balance):
        for g in (ref, one, got):
            stage(g)
        ref.run_steps(ref_kernel, ["v"], ["v"], 3)
        for g in (one, got):
            g.run_steps(port_kernel, ["v"], ["v"], 3)
        assert got.last_step_path == one.last_step_path == "table"
        assert got.last_overlap["mode"] == one.last_overlap["mode"]
        np.testing.assert_array_equal(got.plan.owner, ref.plan.owner)
        assert_same(one, got)
        cells = ref.plan.cells
        want = ref.get("v", cells)
        np.testing.assert_allclose(
            got.get("v", cells), want, rtol=1e-6,
            atol=1e-6 * max(1.0, float(np.abs(want).max())))
    assert_apart(got)


# ---------------------------------------------------------------------
# the solvers and the dense mesh

@places
def test_partitioned_poisson(place):
    """``PoissonSolver`` on four partitions: the one-device grid's
    iterations and solution bit for bit, the reference's iterations and
    solution within its tolerance."""
    n = (8, 8, 8)
    x = (np.arange(8) + 0.5) / 8
    rhs = np.sin(2 * np.pi * x)[:, None, None] * np.ones(n)
    rhs = rhs.transpose(2, 1, 0).reshape(-1).astype(np.float32)
    ref = RefPoisson(n, mesh=mesh_of(4))
    ref.grid.set("rhs", ref.grid.plan.cells, rhs)
    want = ref.solve(rtol=1e-6, max_iterations=200)
    outs = []
    for devs in (ONE, PLACES[place]):
        s = PoissonSolver(n, device=devs)
        s.grid.set("rhs", s.grid.plan.cells, rhs)
        outs.append((s, s.solve(rtol=1e-6, max_iterations=200)))
    (one, r1), (got, r2) = outs
    assert_apart(got.grid)
    assert r2 == r1 and r2["iterations"] == want["iterations"]
    sol = got.grid.get("solution", got.grid.plan.cells)
    np.testing.assert_array_equal(
        sol, one.grid.get("solution", one.grid.plan.cells))
    np.testing.assert_allclose(
        sol, ref.grid.get("solution", ref.grid.plan.cells),
        rtol=1e-4, atol=1e-5)


def test_dense_mesh_blocks_and_solvers():
    """``dense_mesh`` on distinct devices: each block on its own device
    (no shared storage), the slabs copied between them; the advection
    and the dense Poisson solve equal the one-device mesh bit for bit
    and the reference's mesh within its tolerance."""
    shape = (2, 1, 2)
    m = dense_mesh(["cpu:0", "cpu:1", "cpu:2", "cpu:3"], shape)
    assert m.spans_devices and m.ranks is None
    one = dense_mesh(ONE, shape)
    adv = [AdvectionSolver(n=8, nz=4, mesh=mesh) for mesh in (one, m)]
    rho = adv[1].grid.arrays["rho"]
    assert isinstance(rho, Grouped) and len({
        b.untyped_storage().data_ptr() for b in rho.groups}) == 4
    before = telemetry.registry().counter_total(
        "dccrg_rank_bytes_total", leg="device_slab")
    for a in adv:
        for _ in range(3):
            a.step()
    assert telemetry.registry().counter_total(
        "dccrg_rank_bytes_total", leg="device_slab") > before
    np.testing.assert_array_equal(adv[1].grid.to_host("rho"),
                                  adv[0].grid.to_host("rho"))
    assert adv[1].total_mass() == adv[0].total_mass()
    assert adv[1].l2_error() == adv[0].l2_error()
    ref = RefAdvSolver(n=8, nz=4, mesh=ref_dense_mesh(jax.devices()[:4], shape))
    for _ in range(3):
        ref.step()
    np.testing.assert_allclose(adv[1].grid.to_host("rho"),
                               np.asarray(ref.grid.arrays["rho"]),
                               rtol=2e-5, atol=1e-6)
    x = (np.arange(8) + 0.5) / 8
    rhs = np.sin(2 * np.pi * x)[:, None, None] * np.ones((8, 8, 8))
    sols = []
    for mesh in (one, m):
        s = DensePoissonSolver((8, 8, 8), mesh=mesh)
        sol, info = s.solve(rhs, rtol=1e-6, max_iterations=100)
        sols.append((s.grid, sol, info))
    assert sols[1][2] == sols[0][2]
    whole = [torch.empty(8, 8, 8) for _ in sols]
    for w, (g, sol, _info) in zip(whole, sols):
        for view, i in zip(g._whole_blocks(w, g.block), range(4)):
            view.copy_(sol[i].cpu() if g._spans else
                       g._whole_blocks(sol)[i])
    np.testing.assert_array_equal(whole[1].numpy(), whole[0].numpy())
    rp = RefDensePoisson((8, 8, 8),
                         mesh=ref_dense_mesh(jax.devices()[:4], shape))
    rsol, rr = rp.solve(rhs, rtol=1e-6, max_iterations=100)
    assert abs(sols[1][2]["iterations"] - rr["iterations"]) <= 1
    np.testing.assert_allclose(whole[1].numpy(), np.asarray(rsol),
                               rtol=1e-3, atol=1e-4)


def test_refused_models_name_5b1d():
    """The models run on a grid spanning devices, one storage group per
    device (their runs are held to one device's in
    tests/test_torch_devices_models.py); ``GridBatch`` keeps one device,
    as the reference's does."""
    from dccrg_tpu_torch.fleet import FleetJob, GridBatch
    from dccrg_tpu_torch.models import AmrAdvection, GridMHD, GridVlasov
    from dccrg_tpu_torch.models.particles import ParticleModel
    from dccrg_tpu_torch.models.scalability import ScalabilityModel

    devs = ["cpu:0", "cpu:1"]
    makers = [
        lambda: AmrAdvection((8, 8, 1), 1, device=devs),
        lambda: GridMHD(4, device=devs),
        lambda: GridVlasov(4, nv=4, device=devs),
        lambda: ParticleModel(lambda x: torch.zeros_like(x), device=devs),
        lambda: ScalabilityModel((4, 4, 4), device=devs),
    ]
    for make_model in makers:
        g = make_model().grid
        assert [str(x.device) for x in g._groups] == devs
        assert_apart(g)
    with pytest.raises(NotImplementedError, match="reference's GridBatch"):
        GridBatch(FleetJob("a", length=(4, 4, 4), n_steps=1), 2,
                  device=devs)
