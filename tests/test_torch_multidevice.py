"""The port's level-0 grid on n partitions against the reference on a
mesh of n virtual CPU devices (``Mesh(np.array(jax.devices()[:n]))``
against ``["cpu"] * n``): the partitioned plans (owners, rows, ghost
sets, ``n_inner``, pair tables, roll plans and fixup bands, dense and
to-tables, the per-offset exchange tables) bit for bit, the halo
exchange sync and split, the step loop with and without the overlap,
``GridAdvection`` and ``GameOfLife`` after 8 steps bit for bit in
float32 (and bfloat16 storage), the integrity probes and the ``.dc``
bytes of a partitioned grid."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dccrg_tpu import checkpoint as ref_ckpt
from dccrg_tpu import integrity as ref_integrity
from dccrg_tpu import resilience as ref_res
from dccrg_tpu.grid import Grid as RefGrid
from dccrg_tpu.models.advection import GridAdvection as RefAdvection
from dccrg_tpu.models.game_of_life import GameOfLife as RefLife

from dccrg_tpu_torch import checkpoint, comm, integrity, resilience
from dccrg_tpu_torch.convert import fields_from_numpy, fields_to_numpy
from dccrg_tpu_torch.dense import DenseGrid
from dccrg_tpu_torch.grid import DEFAULT_NEIGHBORHOOD_ID as HID
from dccrg_tpu_torch.grid import Grid, SlotwiseKernel
from dccrg_tpu_torch.models.advection import GridAdvection
from dccrg_tpu_torch.models.game_of_life import GameOfLife

DIMS = (6, 5, 8)


def mesh_of(n):
    return Mesh(np.array(jax.devices()[:n]), ("dev",))


def pair(length=DIMS, n=4, partition="block", hood_len=1,
         periodic=(True, True, False), fields=("v",)):
    r = (RefGrid(cell_data={f: jnp.float32 for f in fields})
         .set_initial_length(length).set_periodic(*periodic)
         .set_neighborhood_length(hood_len)
         .initialize(mesh_of(n), partition=partition))
    p = (Grid(cell_data={f: torch.float32 for f in fields})
         .set_initial_length(length).set_periodic(*periodic)
         .set_neighborhood_length(hood_len)
         .initialize(["cpu"] * n, partition=partition))
    return r, p


def seed(r, p, fields=("v",), salt=0):
    cells = r.plan.cells
    for i, f in enumerate(fields):
        vals = ((cells * (7 + i) + salt) % 23).astype(np.float32) * 0.25
        r.set(f, cells, vals)
        p.set(f, cells, vals)


def assert_fields_equal(r, p, fields=("v",)):
    for f in fields:
        np.testing.assert_array_equal(p.data[f].numpy(),
                                      np.asarray(r.data[f]), err_msg=f)


def ref_kernel(cell, nbr, offs, mask):
    s = jnp.sum(jnp.where(mask, nbr["v"], 0.0), axis=1)
    return {"v": 0.5 * cell["v"] + 0.125 * s}


def port_kernel(cell, nbr, offs, mask):
    s = torch.sum(torch.where(mask, nbr["v"], 0.0), dim=1)
    return {"v": 0.5 * cell["v"] + 0.125 * s}


# ---------------------------------------------------------------------
# plans

@pytest.mark.parametrize("periodic", [(True, True, True), (False, True, False)])
@pytest.mark.parametrize("hood_len", [0, 1])
@pytest.mark.parametrize("partition", ["block", "morton"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_plan_matches_reference(n, partition, hood_len, periodic):
    r, p = pair(n=n, partition=partition, hood_len=hood_len,
                periodic=periodic)
    rp, pp = r.plan, p.plan
    np.testing.assert_array_equal(pp.owner, rp.owner)
    assert (pp.L, pp.R, pp.n_dev) == (rp.L, rp.R, rp.n_dev)
    np.testing.assert_array_equal(pp.n_local, rp.n_local)
    np.testing.assert_array_equal(pp.row_of_pos, rp.row_of_pos)
    for d in range(n):
        np.testing.assert_array_equal(pp.local_ids[d], rp.local_ids[d])
        np.testing.assert_array_equal(pp.ghost_ids[d], rp.ghost_ids[d])
    rh, ph = rp.hoods[HID], pp.hoods[HID]
    np.testing.assert_array_equal(ph.n_inner, rh.n_inner)
    for k in ("n_dev", "M", "p", "q", "pos", "srow", "rrow"):
        np.testing.assert_array_equal(ph.pair_compact[k], rh.pair_compact[k])
    # block is contiguous in id order; a curve may happen to be too
    closed = rh.closed_form is not None
    assert (ph.closed_form is not None) == closed
    assert closed or partition != "block"
    if closed:
        assert ph.closed_form["multi"]
        for a, b in zip(ph.roll_plan(pp.L), rh.roll_plan(rp.L)):
            np.testing.assert_array_equal(a, np.asarray(b))
    for name in ("nbr_rows", "nbr_mask", "nbr_offs", "to_rows", "to_offs",
                 "to_mask", "send_rows", "recv_rows"):
        np.testing.assert_array_equal(getattr(ph, name),
                                      np.asarray(getattr(rh, name)),
                                      err_msg=name)
    assert p._peer_deltas(HID) == r._peer_deltas(HID)
    ps, pr = p._pair_tables_host(HID, ("v",))
    rs, rr = r._pair_tables_device(HID, ("v",))
    for a, b in zip(ps + pr, rs + rr):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert p._cap_memo == r._cap_memo


def test_weighted_block_partition_keeps_closed_form():
    """Uneven contiguous cuts (weights) still take the closed form, and
    its dense thunk equals the forced dense build
    (tests/test_uniform.py:304)."""
    r, p = pair(length=(6, 6, 6), n=4, periodic=(True, True, True))
    for g in (r, p):
        for c in g.plan.cells[:72]:
            g.set_cell_weight(c, 5.0)
        g.set_load_balancing_method("block")
        g.balance_load()
    ph, rh = p.plan.hoods[HID], r.plan.hoods[HID]
    assert ph.closed_form["multi"]
    assert np.std([len(x) for x in p.plan.local_ids]) > 0
    np.testing.assert_array_equal(p.plan.owner, r.plan.owner)
    np.testing.assert_array_equal(ph.nbr_rows, np.asarray(rh.nbr_rows))
    for a, b in zip(ph.roll_plan(p.plan.L), rh.roll_plan(r.plan.L)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_forced_tables_on_partitions(monkeypatch):
    monkeypatch.setenv("DCCRG_FORCE_TABLES", "1")
    r, p = pair(n=3)
    assert p.plan.hoods[HID].closed_form is None
    np.testing.assert_array_equal(p.plan.hoods[HID].nbr_rows,
                                  np.asarray(r.plan.hoods[HID].nbr_rows))
    seed(r, p)
    r.update_copies_of_remote_neighbors()
    p.update_copies_of_remote_neighbors()
    r.run_steps(ref_kernel, ["v"], ["v"], 3)
    p.run_steps(port_kernel, ["v"], ["v"], 3)
    assert p.last_step_path == "table"
    assert_fields_equal(r, p)


def test_views_and_queries_match_reference():
    r, p = pair(length=(8, 1, 1), n=4, hood_len=1,
                periodic=(False, False, False))
    for name in ("local_cells", "inner_cells", "outer_cells",
                 "remote_cells"):
        a, b = getattr(p, name)(), getattr(r, name)()
        np.testing.assert_array_equal(a.ids, b.ids, err_msg=name)
        np.testing.assert_array_equal(a.owner, b.owner, err_msg=name)
    assert list(p.get_remote_neighbors_of(2, sorted=True)) == [3]
    assert len(p.get_remote_neighbors_of(9999)) == 0
    for c in range(1, 9):
        assert p.get_process(c) == r.get_process(c)
        assert p.is_inner(c) == r.is_inner(c)
        assert p.is_local(c, p.get_process(c))
        np.testing.assert_array_equal(p.get_remote_neighbors_to(c),
                                      r.get_remote_neighbors_to(c))
    np.testing.assert_array_equal(p.neighbor_type_masks(),
                                  r.neighbor_type_masks())
    np.testing.assert_array_equal(p.neighbor_devices(), r.neighbor_devices())
    assert p.get_comm_size() == 4 and p.get_number_of_cells() == 8
    for fn in ("get_cells_to_send", "get_cells_to_receive"):
        a, b = getattr(p, fn)(), getattr(r, fn)()
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert p.get_number_of_update_send_cells() == 6
    assert p.get_number_of_update_receive_cells() == 6
    assert p.exchange_bytes() == 6 * 4
    crit = [p.HAS_REMOTE_NEIGHBOR_BOTH]
    np.testing.assert_array_equal(p.get_cells(crit), r.get_cells(crit))
    np.testing.assert_array_equal(p.device_row_ids().numpy(),
                                  np.asarray(r.device_row_ids()))
    np.testing.assert_array_equal(p.local_row_mask().numpy(),
                                  np.asarray(r.local_row_mask()))


def test_get_set_on_partitions():
    r, p = pair(n=4)
    ids = np.array([1, 7, 16, 200, 7], dtype=np.uint64)
    p.set("v", ids, np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32))
    np.testing.assert_array_equal(p.get("v", ids[:4]), [1.0, 5.0, 3.0, 4.0])
    assert p.get("v", np.uint64(16)) == 3.0
    p.update_copies_of_remote_neighbors()
    cells = p.plan.cells
    p.set_many(cells, {"v": np.ones(len(cells), np.float32)},
               preserve_ghosts=False)
    ghosts = p.data["v"][:, p.plan.L:p.plan.R - 1]
    assert float(ghosts.abs().sum()) == 0.0
    with pytest.raises(KeyError):
        p.get("v", [99999])


# ---------------------------------------------------------------------
# the halo exchange

@pytest.mark.parametrize("n,partition,hood_len", [
    (2, "block", 1), (3, "morton", 1), (4, "block", 0), (8, "morton", 1),
    (5, "hilbert", 1), (7, "rcb", 0),
])
def test_exchange_matches_reference(n, partition, hood_len):
    r, p = pair(n=n, partition=partition, hood_len=hood_len,
                fields=("v", "w"))
    seed(r, p, ("v", "w"))
    for g in (r, p):
        g.update_copies_of_remote_neighbors(fields=["w"])
    assert_fields_equal(r, p, ("v", "w"))
    assert float(p.data["v"][:, p.plan.L:].abs().sum()) == 0.0
    for g in (r, p):
        g.update_copies_of_remote_neighbors()
    assert_fields_equal(r, p, ("v", "w"))
    host = p.data["v"].numpy()
    for d in range(n):
        for k, cid in enumerate(p.plan.ghost_ids[d]):
            assert host[d, p.plan.L + k] == p.get("v", cid)


def test_dense_all_to_all_fallback(monkeypatch):
    """More peer offsets than ``_MAX_PEER_OFFSETS`` take the dense
    all-to-all tables. Eight partitions have at most seven offsets, so
    the limit is lowered on both packages to make ``morton`` on 8
    partitions take it; the same grid on 12 partitions (beyond the
    reference's 8-device mesh) takes it at the real limit and equals
    its per-offset exchange."""
    monkeypatch.setattr(RefGrid, "_MAX_PEER_OFFSETS", 2)
    monkeypatch.setattr(Grid, "_MAX_PEER_OFFSETS", 2)
    r, p = pair(n=8, partition="morton")
    assert p._peer_deltas(HID) is None and r._peer_deltas(HID) is None
    seed(r, p)
    for g in (r, p):
        g.update_copies_of_remote_neighbors()
    assert_fields_equal(r, p)
    r.run_steps(ref_kernel, ["v"], ["v"], 2)
    p.run_steps(port_kernel, ["v"], ["v"], 2)
    assert_fields_equal(r, p)
    monkeypatch.undo()

    def run12(limit):
        monkeypatch.setattr(Grid, "_MAX_PEER_OFFSETS", limit)
        g = (Grid(cell_data={"v": torch.float32}).set_initial_length(DIMS)
             .set_periodic(True, True, True).set_neighborhood_length(1)
             .initialize(["cpu"] * 12, partition="morton"))
        cells = g.plan.cells
        g.set("v", cells, (cells % 11).astype(np.float32))
        g.update_copies_of_remote_neighbors()
        g.run_steps(port_kernel, ["v"], ["v"], 2)
        return g

    dense, peer = run12(8), run12(64)
    assert dense._peer_deltas(HID) is None
    assert len(peer._peer_deltas(HID)) > 8
    np.testing.assert_array_equal(dense.data["v"].numpy(),
                                  peer.data["v"].numpy())


def test_split_phase_exchange():
    r, p = pair(length=(8, 1, 1), n=4)
    ids = np.arange(1, 9, dtype=np.uint64)
    for g in (r, p):
        g.set("v", ids, (10 * ids).astype(np.float32))
        g.start_remote_neighbor_copy_updates()
        # interleaved writes to local rows survive the wait
        g.set("v", ids, (100 * ids).astype(np.float32))
        g.wait_remote_neighbor_copy_update_receives()
        g.wait_remote_neighbor_copy_update_sends()
    assert_fields_equal(r, p)
    host = p.data["v"].numpy()
    for d in range(4):
        for k, cid in enumerate(p.plan.ghost_ids[d]):
            assert host[d, p.plan.L + k] == 10.0 * float(cid)
    np.testing.assert_array_equal(p.get("v", ids), 100.0 * ids)


def test_split_phase_rules():
    p = pair(length=(8, 1, 1), n=4)[1]
    p.start_remote_neighbor_copy_updates()
    with pytest.raises(RuntimeError):
        p.start_remote_neighbor_copy_updates()
    with pytest.raises(RuntimeError):
        p.update_copies_of_remote_neighbors()
    p.wait_remote_neighbor_copy_updates()
    p.wait_remote_neighbor_copy_updates()  # nothing in flight: no-op
    # distinct neighborhoods may be in flight together
    p.add_neighborhood(9, [[1, 0, 0]])
    p.start_remote_neighbor_copy_updates()
    p.start_remote_neighbor_copy_updates(neighborhood_id=9)
    p.wait_remote_neighbor_copy_updates(neighborhood_id=9)
    p.wait_remote_neighbor_copy_updates()
    # a start from an older structure epoch is stale
    p.start_remote_neighbor_copy_updates()
    p.set_load_balancing_method("rcb")
    p.balance_load()
    with pytest.raises(RuntimeError, match="stale"):
        p.wait_remote_neighbor_copy_updates()
    p.start_remote_neighbor_copy_updates()  # the stale one was dropped
    p.wait_remote_neighbor_copy_updates()
    with pytest.raises(KeyError):
        p.update_copies_of_remote_neighbors(fields=["nope"])
    one = Grid(cell_data={"v": torch.float32}).set_initial_length(
        (3, 3, 1)).initialize("cpu")
    one.start_remote_neighbor_copy_updates()
    with pytest.raises(RuntimeError):
        one.start_remote_neighbor_copy_updates()
    one.wait_remote_neighbor_copy_updates()
    assert len(one.inner_cells()) == 9 and len(one.outer_cells()) == 0


def test_transfer_predicate_matches_reference():
    r, p = pair(n=4, partition="morton")
    seed(r, p)
    pred = lambda ids, s, q, h: (ids % np.uint64(3)) != 0
    for g in (r, p):
        g.set_transfer_predicate("v", pred)
        g.update_copies_of_remote_neighbors()
    assert_fields_equal(r, p)
    assert p.get_number_of_update_send_cells(field="v") == \
        r.get_number_of_update_send_cells(field="v")
    for g, k in ((r, ref_kernel), (p, port_kernel)):
        g.run_steps(k, ["v"], ["v"], 2)
    assert_fields_equal(r, p)
    with pytest.raises(KeyError):
        p.set_transfer_predicate("nope", pred)


# ---------------------------------------------------------------------
# stencils and the step loop

@pytest.mark.parametrize("n,partition", [(2, "block"), (5, "block"),
                                         (4, "morton"), (8, "hilbert")])
def test_step_loop_and_stencil_match_reference(n, partition):
    r, p = pair(n=n, partition=partition, periodic=(False, True, True))
    seed(r, p)
    for g in (r, p):
        g.update_copies_of_remote_neighbors()
    r.run_steps(ref_kernel, ["v"], ["v"], 3)
    p.run_steps(port_kernel, ["v"], ["v"], 3)
    assert p.last_step_path == ("roll" if partition == "block" else "table")
    assert_fields_equal(r, p)
    r.apply_stencil(ref_kernel, ["v"], ["v"])
    p.apply_stencil(port_kernel, ["v"], ["v"])
    assert_fields_equal(r, p)


@pytest.mark.parametrize("n,dtype", [
    (1, "float32"), (2, "float32"), (3, "float32"), (5, "float32"),
    (8, "float32"), (4, "bfloat16")])
def test_grid_advection_matches_reference(n, dtype):
    """8 steps of the main path on n partitions, seeded from the
    reference's state (the reference's jitted init may contract
    ``0.5 - y`` into an FMA and takes XLA's cos, so its initial fields
    differ from ATen's by an ulp in some cells; ROADMAP section 3)."""
    ref = RefAdvection(n=12, mesh=mesh_of(n), dtype=getattr(jnp, dtype))
    got = GridAdvection(n=12, device=["cpu"] * n, dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(got.grid.plan.owner, ref.grid.plan.owner)
    fields_from_numpy(got.grid, {f: np.asarray(ref.grid.data[f])
                                 for f in ("density", "vx", "vy")},
                      L=ref.grid.plan.L)
    dt = 0.5 * ref.max_time_step()
    ref.run(8, dt)
    got.run(8, dt)
    assert got.grid.last_step_path == ("bulk" if n == 1 else "roll")
    np.testing.assert_array_equal(
        fields_to_numpy(got.grid)["density"].astype(np.float32),
        np.asarray(ref.grid.data["density"]).astype(np.float32))
    assert abs(got.l2_error() - ref.l2_error()) <= 1e-5 * ref.l2_error()


def test_partitioned_advection_equals_one_partition():
    """The same state on 1, 3 and 7 partitions steps to the same
    densities cell by cell (one uploaded state, the init not under
    test), overlap on and off."""
    one = GridAdvection(n=8, nz=48, device="cpu")
    start = one.density()
    dt = 0.5 * one.max_time_step()
    one.run(6, dt)
    want = one.density()
    for n in (3, 7):
        for ov in ("0", "1"):
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("DCCRG_OVERLAP", ov)
                g = GridAdvection(n=8, nz=48, device=["cpu"] * n)
                g.grid.set("density", g.grid.plan.cells, start)
                g.grid.update_copies_of_remote_neighbors(fields=["density"])
                g.run(6, dt)
                assert g.grid.last_overlap["mode"] == (
                    "full" if ov == "1" else "off")
            np.testing.assert_array_equal(g.density(), want)


@pytest.mark.parametrize("n,partition", [(2, "block"), (4, "morton"),
                                         (8, "block")])
def test_game_of_life_matches_reference(n, partition):
    ref = RefLife((12, 10, 1), periodic=(True, True, False),
                  mesh=mesh_of(n), partition=partition)
    got = GameOfLife((12, 10, 1), periodic=(True, True, False),
                     device=["cpu"] * n, partition=partition)
    np.testing.assert_array_equal(got.grid.plan.owner, ref.grid.plan.owner)
    glider = [1 + x + 12 * y for x, y in ((1, 0), (2, 1), (0, 2), (1, 2),
                                          (2, 2))]
    blinker = [1 + x + 12 * 6 for x in (6, 7, 8)]
    for g in (ref, got):
        g.set_alive(glider + blinker)
    for _ in range(4):
        ref.step()
        got.step()
    np.testing.assert_array_equal(got.alive_cells(), ref.alive_cells())
    ref.run(4)
    got.run(4)
    np.testing.assert_array_equal(got.alive_cells(), ref.alive_cells())
    for f in ("live", "total"):
        np.testing.assert_array_equal(got.grid.data[f].numpy(),
                                      np.asarray(ref.grid.data[f]))


# ---------------------------------------------------------------------
# the overlapped step

def _overlap_grid(monkeypatch, ov, n=8, partition="block",
                  periodic=(True, True, False)):
    monkeypatch.setenv("DCCRG_OVERLAP", "1" if ov else "0")
    g = (Grid(cell_data={"v": torch.float32, "w": torch.float32})
         .set_initial_length((8, 8, 40)).set_periodic(*periodic)
         .set_neighborhood_length(1)
         .initialize(["cpu"] * n, partition=partition))
    cells = g.plan.cells
    rng = np.random.default_rng(7)
    g.set("v", cells, rng.random(len(cells)).astype(np.float32))
    g.set("w", cells, rng.random(len(cells)).astype(np.float32))
    g.update_copies_of_remote_neighbors()
    return g


def _kern2(cell, nbr, offs, mask):
    sv = torch.sum(torch.where(mask, nbr["v"], 0.0), dim=1)
    sw = torch.sum(torch.where(mask, nbr["w"], 0.0), dim=1)
    return {"v": 0.5 * cell["v"] + 0.125 * sw,
            "w": 0.9 * cell["w"] + 0.05 * sv}


def _static_kern(cell, nbr, offs, mask):
    sw = torch.sum(torch.where(mask, nbr["w"], 0.0), dim=1)
    return {"v": cell["v"] + 0.015625 * sw * cell["w"]}


def _slot_kern(ghost_deps=None):
    return SlotwiseKernel(
        lambda c: torch.zeros_like(c["v"]),
        lambda acc, c, nb, o, m: acc + torch.where(m, nb["w"], 0.0)
        * torch.where(o[..., 0] != 0, 0.25, 0.125),
        lambda acc, c: {"v": c["v"] * 0.5 + acc, "w": c["w"] * 0.75},
        ghost_deps=ghost_deps)


@pytest.mark.parametrize("case", [
    ("block", port_kernel, ("v",), ("v",)),
    ("morton", port_kernel, ("v",), ("v",)),
    ("rcb", port_kernel, ("v",), ("v",)),
    ("block", _kern2, ("v", "w"), ("v", "w")),
    ("block", _static_kern, ("v", "w"), ("v",)),
    ("block", "slot", ("v", "w"), ("v", "w")),
    ("block", "slot_split", ("v", "w"), ("v", "w")),
    ("morton", "slot_split", ("v", "w"), ("v", "w")),
])
def test_overlap_matches_sequential(monkeypatch, case):
    """Overlap on and off give the same state bit for bit (the
    reference's tests/test_overlap.py cases on the port: block, morton
    and rcb, two exchanged fields, a static field, a slot-wise kernel
    and its ghost split)."""
    partition, kern, fin, fout = case
    if kern == "slot":
        kern = _slot_kern()
    elif kern == "slot_split":
        # v reads only w's ghosts; w reads no ghost at all
        kern = _slot_kern({"v": ("w",), "w": ()})
    results, modes = [], []
    for ov in (False, True):
        g = _overlap_grid(monkeypatch, ov, partition=partition)
        g.run_steps(kern, fin, fout, 4)
        modes.append(g.last_overlap["mode"])
        results.append(fields_to_numpy(g))
    # block slabs keep the outer rows a minority, so the overlap engages
    assert modes[0] == "off"
    if partition == "block":
        assert modes[1] in ("full", "split", "none")
    if getattr(kern, "ghost_deps", None) and partition == "block":
        assert modes[1] == "split"
    for f in fout:
        np.testing.assert_array_equal(results[1][f], results[0][f], err_msg=f)


def test_overlap_matches_reference(monkeypatch):
    """The overlapped step against the reference's overlapped step on
    the same mesh, odd partition count, non-periodic edges."""
    monkeypatch.setenv("DCCRG_OVERLAP", "1")
    r, p = pair(length=(8, 8, 40), n=5, periodic=(False, False, False))
    seed(r, p)
    for g in (r, p):
        g.update_copies_of_remote_neighbors()
    r.run_steps(ref_kernel, ["v"], ["v"], 4)
    p.run_steps(port_kernel, ["v"], ["v"], 4)
    assert p.last_overlap == {
        k: (tuple(v) if isinstance(v, tuple) else v)
        for k, v in r.last_overlap.items()}
    assert p.last_overlap["mode"] == "full"
    assert_fields_equal(r, p)


def test_overlap_survives_balance(monkeypatch):
    results = []
    for ov in (False, True):
        g = _overlap_grid(monkeypatch, ov)
        g.run_steps(port_kernel, ["v"], ["v"], 2)
        g.set_partitioning_option("method", "morton")
        g.balance_load()
        g.update_copies_of_remote_neighbors()
        g.run_steps(port_kernel, ["v"], ["v"], 2)
        results.append(g.get("v", g.plan.cells))
    np.testing.assert_array_equal(results[0], results[1])


def test_outer_repass_matches_reference():
    r, p = pair(n=4, partition="morton", fields=("v", "w"))
    seed(r, p, ("v", "w"))
    rf = r._make_outer_repass(ref_kernel, ["v"], ["v"], HID, ["v"])
    pf = p._make_outer_repass(port_kernel, ["v"], ["v"], HID, ["v"])
    for g in (r, p):
        g.update_copies_of_remote_neighbors()
    bulk_r = r.data["w"]
    bulk_p = p.data["w"]
    out_r = rf[0](*rf[1], r.data["v"], bulk_r)[0]
    out_p = pf[0](*pf[1], p.data["v"], bulk_p)[0]
    np.testing.assert_array_equal(out_p.numpy(), np.asarray(out_r))


# ---------------------------------------------------------------------
# integrity, resilience and checkpoints across partitions

def test_fingerprint_sums_and_finite_across_partitions():
    r, p = pair(n=4, partition="morton", fields=("v", "w"))
    seed(r, p, ("v", "w"))
    for g in (r, p):
        g.update_copies_of_remote_neighbors()
    assert integrity.grid_fingerprint(p) == ref_integrity.grid_fingerprint(r)
    np.testing.assert_allclose(
        integrity.conservation_sums(p, ["v", "w"]),
        ref_integrity.conservation_sums(r, ["v", "w"]), rtol=1e-6)
    assert checkpoint.state_digest(p) == ref_ckpt.state_digest(r)
    one = Grid(cell_data={"v": torch.float32, "w": torch.float32}) \
        .set_initial_length(DIMS).set_periodic(True, True, False) \
        .initialize("cpu")
    for f in ("v", "w"):
        one.set(f, one.plan.cells, p.get(f, p.plan.cells))
    assert integrity.grid_fingerprint(one) == integrity.grid_fingerprint(p)
    assert resilience.check_finite(p) and ref_res.check_finite(r)
    bad = np.uint64(37)
    for g in (r, p):
        g.set("w", [bad], [np.nan])
    assert not resilience.check_finite(p) and not ref_res.check_finite(r)
    assert resilience.check_finite(p, ["v"])
    with pytest.raises(resilience.NumericsError, match="37"):
        resilience.assert_finite(p)
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    np.testing.assert_array_equal(comm.host_all_reduce(p.devices, x),
                                  x.sum(0).numpy())
    np.testing.assert_array_equal(comm.host_all_reduce(p.devices, x, "max"),
                                  x[3].numpy())
    assert comm.host_all_gather(p.devices, x).shape == (4, 4, 3)
    np.testing.assert_array_equal(
        comm.host_some_reduce(p.devices, x, p.neighbor_devices()),
        p.neighbor_devices().astype(np.float32) @ x.numpy())


@pytest.mark.parametrize("n,partition", [(3, "block"), (4, "morton")])
def test_partitioned_checkpoint_bytes(tmp_path, n, partition):
    """A partitioned grid's ``.dc`` bytes equal the reference's on the
    same mesh and a one-partition save of the same state; a load onto
    n partitions (the load balancing method's partition) holds the same
    cells and saves the same bytes again."""
    r, p = pair(n=n, partition=partition, fields=("v", "w"))
    seed(r, p, ("v", "w"))
    fr, fp, f1, f2 = (str(tmp_path / x) for x in ("r.dc", "p.dc", "1.dc",
                                                  "2.dc"))
    r.save_grid_data(fr, header=b"hdr")
    p.save_grid_data(fp, header=b"hdr")
    assert open(fp, "rb").read() == open(fr, "rb").read()
    one = Grid(cell_data={"v": torch.float32, "w": torch.float32}) \
        .set_initial_length(DIMS).set_periodic(True, True, False) \
        .initialize("cpu")
    for f in ("v", "w"):
        one.set(f, one.plan.cells, p.get(f, p.plan.cells))
    one.save_grid_data(f1, header=b"hdr")
    assert open(f1, "rb").read() == open(fr, "rb").read()
    cd = {"v": torch.float32, "w": torch.float32}
    back, hdr = Grid.from_file(fp, cd, device=["cpu"] * n, header_size=3)
    assert hdr == b"hdr" and back.n_dev == n
    rback, _ = RefGrid.from_file(fr, {"v": jnp.float32, "w": jnp.float32},
                                 mesh=mesh_of(n), header_size=3)
    np.testing.assert_array_equal(back.plan.owner, rback.plan.owner)
    assert checkpoint.state_digest(back) == ref_ckpt.state_digest(rback)
    assert integrity.grid_fingerprint(back) == integrity.grid_fingerprint(p)
    back.save_grid_data(f2, header=b"hdr")
    assert open(f2, "rb").read() == open(fr, "rb").read()
    path = resilience.save_checkpoint(p, str(tmp_path / "c.dc"))
    g, _h, _rep = resilience.load_checkpoint(path, cd, device=["cpu"] * n)
    assert g.n_dev == n
    np.testing.assert_array_equal(g.get("v", g.plan.cells),
                                  p.get("v", p.plan.cells))


# ---------------------------------------------------------------------
# what waits for the next slice

def test_next_slice_raises():
    # AMR on partitions is ported (tests/test_torch_amr_partitions*.py):
    # the commit and load_cells run; what stays raises
    g = Grid(cell_data={"v": torch.float32}).set_initial_length(
        (4, 4, 1)).set_maximum_refinement_level(1).initialize(["cpu"] * 2)
    g.refine_completely(1)
    kids = g.mapping.get_all_children(np.uint64(1))
    np.testing.assert_array_equal(g.stop_refining(), kids)
    refined = np.sort(np.concatenate([np.arange(2, 17, dtype=np.uint64),
                                      kids]))
    g.load_cells(refined)
    np.testing.assert_array_equal(g.plan.cells, refined)
    with pytest.raises(ValueError, match="meta"):
        DenseGrid((4, 4, 4), {"u": torch.float32}, device=["cpu", "meta"])
    assert DenseGrid((4, 4, 4), {"u": torch.float32},
                     device=["cpu", "cpu"]).mesh_shape == (2, 1, 1)
    # distinct devices of one process run (item 5b.1b): a mesh of blocks
    # on two host devices, a grid and a Poisson solver on two partitions
    two = DenseGrid((4, 4, 4), {"u": torch.float32},
                    device=["cpu:0", "cpu:1"])
    assert two.mesh.spans_devices and two.to_host("u").shape == (4, 4, 4)
    from dccrg_tpu_torch.fleet import FleetJob, GridBatch

    # GridBatch keeps one device, as the reference's does
    with pytest.raises(NotImplementedError, match="reference's GridBatch"):
        GridBatch(FleetJob("a", length=(4, 4, 4), n_steps=1), 2,
                  device=["cpu", "cpu"])
    with pytest.raises(ValueError, match="meta"):
        Grid(cell_data={"v": torch.float32}).initialize(["cpu", "meta"])
    assert Grid(cell_data={"v": torch.float32}).initialize(
        ["cpu:0", "cpu:1"])._grouped
    from dccrg_tpu_torch.models.poisson import PoissonSolver

    with pytest.raises(ValueError, match="meta"):
        PoissonSolver((4, 4, 4), device=["cpu", "meta"])
    assert PoissonSolver((4, 4, 4), device=["cpu"] * 2).grid.n_dev == 2
    assert PoissonSolver((4, 4, 4), device=["cpu:0", "cpu:1"]).grid._grouped


# ---------------------------------------------------------------------
# the reference's tests/test_grid.py cases on partitions

def test_user_neighborhood_on_partitions():
    r, p = pair(length=(6, 1, 1), n=2, periodic=(True, False, False))
    for g in (r, p):
        assert g.add_neighborhood(7, [[1, 0, 0]])
        assert not g.add_neighborhood(7, [[1, 0, 0]])
    assert p.get_neighbors_of(3, neighborhood_id=7) == [(4, (1, 0, 0))]
    assert p.get_neighbors_to(3, neighborhood_id=7) == [(2, (-1, 0, 0))]
    for k in ("p", "q", "srow", "rrow"):
        np.testing.assert_array_equal(p.plan.hoods[7].pair_compact[k],
                                      r.plan.hoods[7].pair_compact[k])
    seed(r, p)
    for g in (r, p):
        g.update_copies_of_remote_neighbors(neighborhood_id=7)
    assert_fields_equal(r, p)
    with pytest.raises(ValueError):
        p.add_neighborhood(8, [[0, 0, 0]])
    p.remove_neighborhood(7)
    with pytest.raises(KeyError):
        p.get_neighbors_of(3, neighborhood_id=7)
    with pytest.raises(ValueError):
        p.remove_neighborhood(HID)


def test_transfer_predicate_receiver_dependent():
    """Field ``a`` withheld from odd receivers, ``b`` everywhere
    (dccrg_get_cell_datatype.hpp:48-213), sync and split, then cleared;
    every ghost row as the reference's."""
    r, p = pair(length=(8, 2, 1), n=4, fields=("a", "b"),
                periodic=(False, False, False))
    cells = p.plan.cells
    pred = lambda ids, sender, receiver, hood: np.full(len(ids),
                                                       receiver % 2 == 0)
    for g in (r, p):
        g.set_many(cells, {"a": cells.astype(np.float32),
                           "b": -cells.astype(np.float32)})
        g.set_transfer_predicate("a", pred)
        g.update_copies_of_remote_neighbors()
    assert_fields_equal(r, p, ("a", "b"))
    host = p.data["a"].numpy()
    assert host[1, p.plan.L:].sum() == 0 and host[0, p.plan.L:].sum() > 0
    for g in (r, p):
        g.set("a", cells, 2 * cells.astype(np.float32))
        g.start_remote_neighbor_copy_updates(fields=["a"])
        g.wait_remote_neighbor_copy_updates()
    assert_fields_equal(r, p, ("a", "b"))
    for g in (r, p):
        g.set_transfer_predicate("a", None)
        g.update_copies_of_remote_neighbors()
    assert_fields_equal(r, p, ("a", "b"))
    with pytest.raises(RuntimeError):
        Grid(cell_data={"v": torch.float32}).set_transfer_predicate("v", pred)


def test_transfer_predicate_in_step_loop():
    """A predicate blocking every transfer leaves the ghosts at zero in
    the step loop; clearing it takes effect in the next loop."""
    p = (Grid(cell_data={"v": torch.float32}).set_initial_length((4, 1, 1))
         .initialize(["cpu"] * 2))
    cells = p.plan.cells
    p.set("v", cells, cells.astype(np.float32))
    p.set_transfer_predicate("v", lambda ids, s, r, h: np.zeros(len(ids), bool))

    def kernel(cell, nbr, offs, mask):
        return {"v": torch.sum(torch.where(mask, nbr["v"], 0.0), dim=1)}

    p.run_steps(kernel, ["v"], ["v"], 1)
    np.testing.assert_array_equal(p.get("v", cells)[1:3], [1.0, 4.0])
    p.set("v", cells, cells.astype(np.float32))
    p.set_transfer_predicate("v", None)
    p.run_steps(kernel, ["v"], ["v"], 1)
    np.testing.assert_array_equal(p.get("v", cells)[1:3], [4.0, 6.0])


def test_peer_exchange_buffers_compact():
    """Block slabs talk to their two neighbours only: the per-offset
    tables move a quarter of the dense all-to-all's rows at 8
    partitions."""
    p = (Grid(cell_data={"v": torch.float32}).set_initial_length((16, 16, 32))
         .set_periodic(True, True, True)
         .initialize(["cpu"] * 8, partition="block"))
    assert p._peer_deltas(HID) == (1, 7)
    sends, _ = p._pair_tables_host(HID, ("v",))
    dense_rows = p.n_dev * p.plan.hoods[HID].send_rows.shape[2]
    assert dense_rows >= 3 * sum(t.shape[1] for t in sends)


@pytest.mark.parametrize("partition", ["block", "morton", "hilbert"])
def test_device_count_invariance(partition):
    """The reference requires identical results on any process count
    (tests/README:5-6): the game of life from one random state on 1, 3
    and 8 partitions."""
    rng = np.random.default_rng(5)
    alive = None
    out = []
    for n in (1, 3, 8):
        g = GameOfLife((10, 9, 4), periodic=(True, False, True),
                       device=["cpu"] * n, partition=partition)
        if alive is None:
            cells = g.grid.plan.cells
            alive = cells[rng.random(len(cells)) < 0.3]
        g.set_alive(alive)
        g.run(3)
        g.step()
        out.append(g.alive_cells())
    for a in out[1:]:
        np.testing.assert_array_equal(a, out[0])


def test_restart_equivalence_on_partitions(tmp_path):
    """The reference restart test (tests/restart/README:10-14) on four
    partitions: a save and load in the middle changes nothing."""
    mk = lambda: GameOfLife(device=["cpu"] * 4)
    blinker = [35, 45, 55]
    ref = mk()
    ref.set_alive(blinker)
    for _ in range(5):
        ref.step()
    a = mk()
    a.set_alive(blinker)
    for _ in range(2):
        a.step()
    fn = str(tmp_path / "gol.dc")
    a.grid.save_grid_data(fn)
    b = mk()
    b.grid.load_grid_data(fn)
    for _ in range(3):
        b.step()
    np.testing.assert_array_equal(b.alive_cells(), ref.alive_cells())


@pytest.mark.parametrize("variant", ["tables", "predicate"])
def test_overlap_with_tables_and_predicates(monkeypatch, variant):
    results = []
    for ov in (False, True):
        if variant == "tables":
            monkeypatch.setenv("DCCRG_FORCE_TABLES", "1")
        g = _overlap_grid(monkeypatch, ov)
        if variant == "predicate":
            g.set_transfer_predicate(
                "v", lambda ids, s, r, h: (ids % np.uint64(3)) != 0)
            g.update_copies_of_remote_neighbors()
        g.run_steps(port_kernel, ["v"], ["v"], 3)
        if ov:
            assert g.last_overlap["mode"] == "full"
        results.append(g.get("v", g.plan.cells))
    np.testing.assert_array_equal(results[0], results[1])
