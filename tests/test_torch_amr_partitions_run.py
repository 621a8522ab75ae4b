"""The AMR commit, the halo exchange, stencils and the step loop, load
balancing, ``.dc`` checkpoints and the integrity probes of a refined
grid on n partitions, the port on ``["cpu"] * n`` against the reference
on a mesh of n virtual CPU devices (tests/test_device_counts.py:42-64
and tests/test_balance_and_restart.py:99-142 on the port), and the
port's partitioned runs against its one-partition runs. A slot-wise
kernel adds its slots one at a time, in the same order on both sides,
so its results are held bit for bit; a plain kernel's slot sum is a
reduction, which XLA and PyTorch order differently (ROADMAP section 3),
so it is held to rtol/atol 1e-6 of the field's peak."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dccrg_tpu import checkpoint as ref_ckpt
from dccrg_tpu import integrity as ref_integrity
from dccrg_tpu.grid import Grid as RefGrid
from dccrg_tpu.grid import SlotwiseKernel as RefSlotwise

from dccrg_tpu_torch import checkpoint, integrity, resilience
from dccrg_tpu_torch.grid import Grid, SlotwiseKernel

from torch_amr_fixture import assert_plans_equal

HID = -0xDCC
COUNTS = (1, 3, 5, 7)


def mesh_of(n):
    return Mesh(np.array(jax.devices()[:n]), ("dev",))


def pair(length=(6, 5, 4), n=4, partition="block", periodic=(False, True, False),
         max_lvl=2, hood_len=1, fields=("v",)):
    r = (RefGrid(cell_data={f: jnp.float32 for f in fields})
         .set_initial_length(length).set_periodic(*periodic)
         .set_maximum_refinement_level(max_lvl)
         .set_neighborhood_length(hood_len)
         .initialize(mesh_of(n), partition=partition))
    p = (Grid(cell_data={f: torch.float32 for f in fields})
         .set_initial_length(length).set_periodic(*periodic)
         .set_maximum_refinement_level(max_lvl)
         .set_neighborhood_length(hood_len)
         .initialize(["cpu"] * n, partition=partition))
    return r, p


def commit(grids, refine=(), unrefine=()):
    out = []
    for g in grids:
        for c in refine:
            g.refine_completely(c)
        for c in unrefine:
            g.unrefine_completely(c)
        out.append(g.stop_refining())
    np.testing.assert_array_equal(out[1], out[0])
    return out[0]


def seed(grids, fields=("v",), salt=0):
    cells = grids[0].plan.cells
    for i, f in enumerate(fields):
        vals = ((cells * (7 + i) + salt) % 23).astype(np.float32) * 0.25
        for g in grids:
            g.set(f, cells, vals)


def assert_data_equal(r, p, fields=("v",)):
    """Every partition's rows, ghost and pad rows included, bit for
    bit (both grids keep a zero pad row and zero-filled new rows)."""
    for f in fields:
        np.testing.assert_array_equal(p.data[f].numpy(),
                                      np.asarray(r.data[f]), err_msg=f)


def refined(n=4, partition="block", fields=("v",), refine=(1, 2, 3, 9),
            **kw):
    r, p = pair(n=n, partition=partition, fields=fields, **kw)
    seed((r, p), fields)
    commit((r, p), refine=refine)
    commit((r, p), refine=(int(r.plan.cells[-1]),), unrefine=())
    seed((r, p), fields, salt=3)
    for g in (r, p):
        g.update_copies_of_remote_neighbors()
    return r, p


# ---------------------------------------------------------------------
# the reference's device-count sweep on the port

@pytest.mark.parametrize("n", COUNTS)
def test_exchange_and_amr(n):
    """tests/test_device_counts.py:42-64: ghosts after an exchange,
    a commit across partitions, an exchange on the refined plan and a
    balance that keeps the data; every step's plan and rows equal the
    reference's."""
    r, p = pair(length=(5, 3, 2), n=n, periodic=(True, False, False),
                max_lvl=1)
    cells = p.plan.cells
    for g in (r, p):
        g.set("v", cells, cells.astype(np.float32))
        g.update_copies_of_remote_neighbors()
    host = p.data["v"].numpy()
    for d in range(n):
        for row, cid in enumerate(p.plan.ghost_ids[d]):
            assert host[d, p.plan.L + row] == float(cid)
    commit((r, p), refine=(1,))
    assert len(p.plan.cells) == 30 + 7
    assert_plans_equal(r, p, lists=False)
    for g in (r, p):
        g.update_copies_of_remote_neighbors()
    assert_data_equal(r, p)
    host = p.data["v"].numpy()
    for d in range(n):
        own = p.get("v", p.plan.ghost_ids[d])
        ng = len(p.plan.ghost_ids[d])
        np.testing.assert_array_equal(host[d, p.plan.L:p.plan.L + ng], own)
    for g in (r, p):
        g.balance_load()
    assert_plans_equal(r, p, lists=False)
    assert_data_equal(r, p)
    np.testing.assert_array_equal(
        np.sort(p.get("v", np.arange(2, 31).astype(np.uint64))),
        np.arange(2, 31, dtype=np.float32))


@pytest.mark.parametrize("n,partition", [(2, "block"), (3, "morton"),
                                         (4, "hilbert"), (8, "block")])
def test_commit_moves_data_across_partitions(n, partition):
    """Refine and unrefine commits whose cells change owner, row and
    partition: the surviving rows move on the device, the old data of
    refined parents and removed children is read back from any
    partition, and the projections land on the new owners, all equal
    to the reference."""
    r, p = pair(n=n, partition=partition)
    seed((r, p))
    created = commit((r, p), refine=(1, 2, 3, 9, 30))
    assert_plans_equal(r, p, lists=False)
    assert_data_equal(r, p)
    parents = r.mapping.get_parent(created)
    np.testing.assert_array_equal(p.get_old_data("v", parents),
                                  r.get_old_data("v", parents))
    for g in (r, p):
        g.assign_children_from_parents()
        g.clear_refined_unrefined_data()
    assert_data_equal(r, p)
    np.testing.assert_array_equal(p.get_removed_cells(), r.get_removed_cells())
    # unrefine the children of 2 and 30: their parents come back on the
    # first child's partition, averaged from the removed children
    kids = [int(r.mapping.get_all_children(np.uint64(c))[0]) for c in (2, 30)]
    commit((r, p), unrefine=kids)
    np.testing.assert_array_equal(p.get_removed_cells(), r.get_removed_cells())
    for g in (r, p):
        g.average_parents_from_children()
    assert_plans_equal(r, p, lists=False)
    assert_data_equal(r, p)
    for c in p.plan.cells[::5]:
        for d in range(n):
            assert p.is_local(c, d) == r.is_local(c, d)


@pytest.mark.parametrize("n", [3, 8])
def test_load_cells_on_partitions(n):
    r, p = pair(length=(4, 4, 2), n=n, max_lvl=1)
    kids = r.mapping.get_all_children(np.uint64(6))
    cells = np.sort(np.concatenate(
        [np.setdiff1d(r.plan.cells, [np.uint64(6)]), kids]))
    for g in (r, p):
        g.load_cells(cells)
    assert_plans_equal(r, p, lists=False)
    assert float(p.data["v"].abs().sum()) == 0.0


# ---------------------------------------------------------------------
# exchange, stencils and the step loop

def _ref_plain(cell, nbr, offs, mask):
    s = jnp.sum(jnp.where(mask, nbr["v"] * (1.0 + 0.125 * offs[..., 0]), 0.0),
                axis=1)
    return {"v": 0.5 * cell["v"] + 0.0625 * s}


def _port_plain(cell, nbr, offs, mask):
    s = torch.sum(torch.where(mask, nbr["v"] * (1.0 + 0.125 * offs[..., 0]),
                              0.0), dim=1)
    return {"v": 0.5 * cell["v"] + 0.0625 * s}


def _slot(mod, where, zeros_like, ghost_deps=None):
    kw = {} if ghost_deps is None else {"ghost_deps": ghost_deps}
    return mod(
        lambda c: zeros_like(c["v"]),
        lambda acc, c, nb, o, m: acc + where(m, nb["w"], 0.0) * 0.125
        + where(m, nb["v"], 0.0) * 0.0625,
        lambda acc, c: {"v": c["v"] * 0.5 + acc, "w": c["w"] * 0.75},
        **kw)


def ref_slot(ghost_deps=None):
    return _slot(RefSlotwise, jnp.where, jnp.zeros_like, ghost_deps)


def port_slot(ghost_deps=None):
    return _slot(SlotwiseKernel, torch.where, torch.zeros_like, ghost_deps)


def _peak_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    tol = 1e-6 * max(1.0, float(np.abs(a).max()))
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=tol)


@pytest.mark.parametrize("n,partition", [(2, "block"), (3, "morton"),
                                         (5, "block"), (8, "hilbert")])
def test_step_loop_and_stencils_match_reference(n, partition):
    r, p = refined(n=n, partition=partition, fields=("v", "w"))
    r.run_steps(ref_slot(), ["v", "w"], ["v", "w"], 3)
    p.run_steps(port_slot(), ["v", "w"], ["v", "w"], 3)
    assert p.last_step_path == "table"
    assert_data_equal(r, p, ("v", "w"))
    r.run_steps(_ref_plain, ["v"], ["v"], 2)
    p.run_steps(_port_plain, ["v"], ["v"], 2)
    _peak_close(r.data["v"], p.data["v"])
    r.apply_stencil(_ref_plain, ["v"], ["v"])
    p.apply_stencil(_port_plain, ["v"], ["v"])
    _peak_close(r.data["v"], p.data["v"])


def test_include_to_on_partitions():
    """apply_stencil(include_to=True) over the merged far + hard tables
    and the to-tables of each partition."""
    r, p = refined(n=4, partition="morton")

    def ref_k(cell, nbr, offs, mask, tnbr, toffs, tmask):
        a = jnp.sum(jnp.where(mask, nbr["v"], 0.0), axis=1)
        b = jnp.sum(jnp.where(tmask, tnbr["v"] * toffs[..., 1], 0.0), axis=1)
        return {"v": 0.25 * cell["v"] + 0.125 * a + 0.03125 * b}

    def port_k(cell, nbr, offs, mask, tnbr, toffs, tmask):
        a = torch.sum(torch.where(mask, nbr["v"], 0.0), dim=1)
        b = torch.sum(torch.where(tmask, tnbr["v"] * toffs[..., 1], 0.0),
                      dim=1)
        return {"v": 0.25 * cell["v"] + 0.125 * a + 0.03125 * b}

    r.apply_stencil(ref_k, ["v"], ["v"], include_to=True)
    p.apply_stencil(port_k, ["v"], ["v"], include_to=True)
    _peak_close(r.data["v"], p.data["v"])


# refined cells on the block partitions' boundaries (z = 4, 8 and 12
# of a 6 x 5 x 16 grid), so hard rows are outer rows too
OVERLAP_REFINE = (1, 2, 3, 9, 121, 241, 242, 361)


@pytest.mark.parametrize("n,partition,split", [
    (2, "block", False), (2, "block", True), (4, "block", True),
    (5, "morton", False)])
def test_overlap_on_refined_partitions(monkeypatch, n, partition, split):
    """The overlapped step on a split plan (the bulk pass on
    pre-exchange ghosts, the outer rows again after the receives, the
    hard rows last on the fresh ghosts): bit for bit with the overlap
    off, with the reference's overlapped step and with one partition."""
    deps = {"v": ("v", "w"), "w": ()} if split else None
    runs = []
    for ov in ("0", "1"):
        monkeypatch.setenv("DCCRG_OVERLAP", ov)
        r, p = refined(n=n, partition=partition, fields=("v", "w"),
                       length=(6, 5, 16), refine=OVERLAP_REFINE)
        p.run_steps(port_slot(deps), ["v", "w"], ["v", "w"], 4)
        runs.append((p.last_overlap["mode"], p.data["v"].numpy().copy()))
        if ov == "1":
            r.run_steps(ref_slot(deps), ["v", "w"], ["v", "w"], 4)
            assert p.last_overlap["mode"] == r.last_overlap["mode"]
            assert_data_equal(r, p, ("v", "w"))
    assert runs[0][0] == "off"
    # block slabs keep the outer rows a minority, so the overlap engages
    assert partition != "block" or runs[1][0] in ("full", "split")
    np.testing.assert_array_equal(runs[1][1], runs[0][1])
    monkeypatch.setenv("DCCRG_OVERLAP", "0")
    _r1, one = refined(n=1, fields=("v", "w"), length=(6, 5, 16),
                       refine=OVERLAP_REFINE)
    hood = p.plan.hoods[HID]
    outer_hard = [np.count_nonzero(
        (hood.hard_rows[d] >= hood.n_inner[d]) & (hood.hard_rows[d] < p.plan.L))
        for d in range(n)]
    assert partition != "block" or min(outer_hard) > 0
    one.run_steps(port_slot(deps), ["v", "w"], ["v", "w"], 4)
    cells = p.plan.cells
    np.testing.assert_array_equal(p.get("v", cells), one.get("v", cells))


def test_split_phase_exchange_on_refined_partitions():
    r, p = refined(n=5, partition="morton")
    vals = (p.plan.cells % 13).astype(np.float32)
    for g in (r, p):
        g.set("v", g.plan.cells, vals)
        g.start_remote_neighbor_copy_updates()
        g.wait_remote_neighbor_copy_updates()
    assert_data_equal(r, p)
    assert p.get_number_of_update_send_cells() == \
        r.get_number_of_update_send_cells()
    assert p.exchange_bytes() == 4 * p.get_number_of_update_send_cells()


# ---------------------------------------------------------------------
# balance

def test_amr_then_balance_keeps_data():
    """tests/test_balance_and_restart.py:99-112 on 8 partitions."""
    r, p = pair(length=(2, 2, 2), n=8, max_lvl=1, periodic=(False,) * 3)
    for g in (r, p):
        cells = g.get_cells()
        g.set("v", cells, np.arange(1, 9, dtype=np.float32))
    commit((r, p), refine=(2,))
    for g in (r, p):
        g.assign_children_from_parents()
        g.balance_load()
    assert_plans_equal(r, p, lists=False)
    assert_data_equal(r, p)
    kids = p.mapping.get_all_children(np.uint64(2))
    np.testing.assert_allclose(p.get("v", kids), np.full(8, 2.0))
    assert p.get("v", np.uint64(8)) == 8.0


@pytest.mark.parametrize("method", ["rcb", "morton", "hilbert", "cut", "block"])
def test_balance_refined_grid_matches_reference(method):
    """Every partitioner on a refined grid, with a pinned refined
    parent (its children inherit the pin) and weighted cells: owners,
    plans, moved cells and data equal to the reference's."""
    r, p = pair(n=4, partition="block")
    seed((r, p))
    for g in (r, p):
        g.pin(3, 2)
        g.set_cell_weight(9, 4.0)
    commit((r, p), refine=(1, 3, 9))
    assert p.get_pin_requests() == r.get_pin_requests()
    assert p._weights == r._weights
    for g in (r, p):
        g.set_load_balancing_method(method)
        g.balance_load()
    assert_plans_equal(r, p, lists=False)
    assert_data_equal(r, p)
    np.testing.assert_array_equal(p.get_cells_added_by_balance_load(),
                                  r.get_cells_added_by_balance_load())
    for kid in p.mapping.get_all_children(np.uint64(3)):
        assert p.get_process(kid) == 2


# ---------------------------------------------------------------------
# checkpoints and the integrity probes

def test_save_load_with_amr(tmp_path):
    """tests/test_balance_and_restart.py:130-142 on 8 partitions: the
    refined grid's ``.dc`` bytes equal the reference's and a
    one-partition save's; the load onto 8 partitions equals the
    reference's load and saves the same bytes."""
    r, p = pair(length=(2, 2, 2), n=8, max_lvl=1, periodic=(False,) * 3)
    commit((r, p), refine=(3,))
    ids = p.get_cells()
    for g in (r, p):
        g.set("v", ids, np.arange(len(ids), dtype=np.float32))
    fr, fp, f1, f2 = (str(tmp_path / x) for x in ("r.dc", "p.dc", "1.dc",
                                                  "2.dc"))
    r.save_grid_data(fr, header=b"amr")
    p.save_grid_data(fp, header=b"amr")
    assert open(fp, "rb").read() == open(fr, "rb").read()
    _r1, one = pair(length=(2, 2, 2), n=1, max_lvl=1, periodic=(False,) * 3)
    one.refine_completely(3)
    one.stop_refining()
    one.set("v", ids, np.arange(len(ids), dtype=np.float32))
    one.save_grid_data(f1, header=b"amr")
    assert open(f1, "rb").read() == open(fr, "rb").read()

    r2, p2 = pair(length=(2, 2, 2), n=8, max_lvl=1, periodic=(False,) * 3)
    r2.load_grid_data(fr, header_size=3)
    p2.load_grid_data(fp, header_size=3)
    assert_plans_equal(r2, p2, lists=False)
    np.testing.assert_array_equal(p2.get("v", ids),
                                  np.arange(len(ids), dtype=np.float32))
    cd = {"v": torch.float32}
    back, hdr = Grid.from_file(fp, cd, device=["cpu"] * 8, header_size=3)
    assert hdr == b"amr" and back.n_dev == 8
    rback, _ = RefGrid.from_file(fr, {"v": jnp.float32}, mesh=mesh_of(8),
                                 header_size=3)
    np.testing.assert_array_equal(back.plan.owner, rback.plan.owner)
    assert checkpoint.state_digest(back) == ref_ckpt.state_digest(rback)
    back.save_grid_data(f2, header=b"amr")
    assert open(f2, "rb").read() == open(fr, "rb").read()
    path = resilience.save_checkpoint(p, str(tmp_path / "c.dc"))
    g, _h, _rep = resilience.load_checkpoint(path, cd, device=["cpu"] * 8)
    np.testing.assert_array_equal(g.get("v", ids), p.get("v", ids))


@pytest.mark.parametrize("n", [3, 8])
def test_integrity_probes_on_refined_partitions(n):
    r, p = refined(n=n, partition="morton", fields=("v", "w"))
    assert integrity.grid_fingerprint(p) == ref_integrity.grid_fingerprint(r)
    np.testing.assert_allclose(
        integrity.conservation_sums(p, ["v", "w"]),
        ref_integrity.conservation_sums(r, ["v", "w"]), rtol=1e-6)
    assert checkpoint.state_digest(p) == ref_ckpt.state_digest(r)
    _r1, one = refined(n=1, fields=("v", "w"))
    assert integrity.grid_fingerprint(p) == integrity.grid_fingerprint(one)
    assert bool(resilience.check_finite(p, ["v", "w"]))
