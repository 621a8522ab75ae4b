"""Load balancing on partitions: the port's ``balance_load`` and its
staged protocol against the reference's on the same virtual CPU mesh
(tests/test_balance_and_restart.py's level-0 cases): owners, moved
cells and data bit for bit, pins, weights, the options and the
hierarchy levels, the multi-stage capture, and the ``balance.commit``
fault phases."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dccrg_tpu.grid import Grid as RefGrid

from dccrg_tpu_torch import faults, integrity, telemetry
from dccrg_tpu_torch.checkpoint import state_digest
from dccrg_tpu_torch.grid import Grid
from dccrg_tpu_torch.txn import MutationAbortedError


def make_pair(length=(8, 1, 1), n=4, fields=("v",), partition=None,
              periodic=(False, False, False), hood_len=1):
    r = (RefGrid(cell_data={f: jnp.float32 for f in fields})
         .set_initial_length(length).set_periodic(*periodic)
         .set_neighborhood_length(hood_len)
         .initialize(Mesh(np.array(jax.devices()[:n]), ("dev",)),
                     partition=partition))
    p = (Grid(cell_data={f: torch.float32 for f in fields})
         .set_initial_length(length).set_periodic(*periodic)
         .set_neighborhood_length(hood_len)
         .initialize(["cpu"] * n, partition=partition))
    cells = r.plan.cells
    for i, f in enumerate(fields):
        vals = (cells.astype(np.float32) * (3 + i))
        r.set(f, cells, vals)
        p.set(f, cells, vals)
    return r, p


def assert_same(r, p, fields=("v",)):
    np.testing.assert_array_equal(p.plan.owner, r.plan.owner)
    assert (p.plan.L, p.plan.R) == (r.plan.L, r.plan.R)
    for f in fields:
        np.testing.assert_array_equal(p.data[f].numpy(), np.asarray(r.data[f]))
    for d in range(p.n_dev):
        np.testing.assert_array_equal(
            p.get_cells_added_by_balance_load(d),
            r.get_cells_added_by_balance_load(d))
        np.testing.assert_array_equal(
            p.get_cells_removed_by_balance_load(d),
            r.get_cells_removed_by_balance_load(d))
    np.testing.assert_array_equal(p.get_cells_added_by_balance_load(),
                                  r.get_cells_added_by_balance_load())


def test_balance_load_preserves_data():
    r, p = make_pair()
    ids = np.arange(1, 9, dtype=np.uint64)
    for g in (r, p):
        g.set_cell_weight(1, 10.0)  # skew the partition
        g.balance_load()
    assert_same(r, p)
    np.testing.assert_array_equal(p.get("v", ids), ids * 3.0)
    assert p.get_process(1) not in [p.get_process(int(i)) for i in ids[1:]]


@pytest.mark.parametrize("method", ["rcb", "morton", "hilbert", "cut", "block"])
def test_balance_from_block_matches_reference(method):
    """From ``block`` to each method on 4 partitions (the chip smoke's
    balance leg at test size): owners, moved cells and data; the grid's
    fingerprint is unchanged and the next steps equal an unbalanced
    run's."""
    r, p = make_pair(length=(8, 6, 4), partition="block",
                     periodic=(True, True, False))
    unb = make_pair(length=(8, 6, 4), partition="block",
                    periodic=(True, True, False))[1]
    before = integrity.grid_fingerprint(p)
    for g in (r, p):
        g.set_load_balancing_method(method)
        g.balance_load()
    assert_same(r, p)
    assert integrity.grid_fingerprint(p) == before

    def k(cell, nbr, offs, mask):
        return {"v": 0.5 * cell["v"] + 0.0625 * torch.sum(
            torch.where(mask, nbr["v"], 0.0), dim=1)}

    for g in (p, unb):
        g.update_copies_of_remote_neighbors()
        g.run_steps(k, ["v"], ["v"], 3)
    np.testing.assert_array_equal(p.get("v", p.plan.cells),
                                  unb.get("v", unb.plan.cells))


def test_staged_protocol():
    r, p = make_pair()
    for g in (r, p):
        with pytest.raises(RuntimeError):
            g.continue_balance_load()
        with pytest.raises(RuntimeError):
            g.finish_balance_load()
        g.set_load_balancing_method("hilbert")
        g.initialize_balance_load()
        with pytest.raises(RuntimeError):
            g.initialize_balance_load()
        with pytest.raises(KeyError):
            g.continue_balance_load(fields=["nope"])
        g.continue_balance_load()
        g.continue_balance_load()  # repeatable (multi-stage transfers)
        g.finish_balance_load()
    assert_same(r, p)


def test_multi_stage_balance_moves_staged_values():
    """What a stage captured lands at the destination; later source
    writes do not leak through (dccrg.hpp:3932-3964)."""
    r, p = make_pair(fields=("a", "b"))
    cells = p.plan.cells
    for g in (r, p):
        for c in cells:
            g.pin(int(c), (g.get_process(int(c)) + 1) % 4)
        g.initialize_balance_load(use_zoltan=False)
        g.continue_balance_load(fields=["a"])
    ids, vals = p.staged_balance_data("a")
    rids, rvals = r.staged_balance_data("a")
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(vals, rvals)
    for g in (r, p):
        g.set("a", cells, np.full(8, -99, dtype=np.float32))
        g.set("b", cells, np.full(8, -77, dtype=np.float32))
        g.continue_balance_load(fields=["b"])
        g.finish_balance_load()
    assert_same(r, p, ("a", "b"))
    np.testing.assert_array_equal(p.get("a", cells), np.arange(1, 9) * 3.0)
    np.testing.assert_array_equal(p.get("b", cells), np.full(8, -77.0))


def test_unstaged_fields_move_with_current_values():
    r, p = make_pair(fields=("a", "b"))
    cells = p.plan.cells
    for g in (r, p):
        g.set_load_balancing_method("rcb")
        g.set_cell_weight(8, 6.0)
        g.initialize_balance_load()
        g.continue_balance_load(fields=["a"])
        g.set("b", cells, np.full(8, 5, dtype=np.float32))
        g.finish_balance_load()
    assert_same(r, p, ("a", "b"))


def test_pinning_and_pins_only_balance():
    r, p = make_pair()
    for g in (r, p):
        assert g.pin(5, 2)
        assert not g.pin(5, 9) and not g.pin(99, 0)
        g.balance_load()
    assert p.get_process(5) == 2
    assert_same(r, p)
    assert p.get_pin_requests() == {5: 2}
    assert p.unpin(5) and not p.unpin(5)
    before = [p.get_process(int(i)) for i in range(1, 9)]
    for g in (r, p):
        g.unpin_all_cells()
        g.pin(4, 0)
        g.balance_load(use_zoltan=False)
    after = [p.get_process(int(i)) for i in range(1, 9)]
    assert after[3] == 0
    assert all(a == b for i, (a, b) in enumerate(zip(before, after)) if i != 3)
    assert_same(r, p)
    for g in (r, p):
        g.pin(1, 3)
        g.pin(2, 3)
        g.unpin_local_cells(p.get_process(1))
    assert p.get_pin_requests() == r.get_pin_requests()
    p.unpin_local_cells()
    assert p.get_pin_requests() == {}


def test_cell_weights_and_options():
    r, p = make_pair(length=(4, 1, 1), n=2)
    assert p.get_cell_weight(1) == 1.0
    assert p.set_cell_weight(1, 5.0) and p.get_cell_weight(1) == 5.0
    assert not p.set_cell_weight(1, -1.0)
    assert not p.set_cell_weight(77, 1.0)
    p.set_partitioning_option("LB_METHOD", "hilbert")
    assert p._lb_method == "hilbert"
    p.set_partitioning_option("IMBALANCE_TOL", 1.05)
    assert p.get_partitioning_options()["IMBALANCE_TOL"] == 1.05
    with pytest.raises(ValueError):
        p.set_load_balancing_method("zoltan")
    with pytest.raises(IndexError):
        p.get_partitioning_options(0)


def test_hierarchical_levels_match_reference():
    r, p = make_pair(length=(6, 5, 4), n=8, periodic=(True, True, True))
    for g in (r, p):
        g.add_partitioning_level(4)
        g.add_partitioning_option(0, "LB_METHOD", "RCB")
        g.add_partitioning_level(1)
        g.add_partitioning_option(1, "method", "hilbert")
        g.add_partitioning_option(1, "PHG_EDGE", 1)
        g.set_cell_weight(3, 4.0)
    assert p.get_partitioning_options(1) == r.get_partitioning_options(1)
    assert p.get_partitioning_option_value(0, "method") == "rcb"
    for g in (r, p):
        g.balance_load()
    assert_same(r, p)
    for g in (r, p):
        g.remove_partitioning_option(1, "method")
        g.remove_partitioning_level(0)
        g.add_partitioning_option(0, "method", "cut")
        g.balance_load()
    assert_same(r, p)
    with pytest.raises(ValueError):
        p.add_partitioning_option(0, "method", "nope")
    with pytest.raises(ValueError):
        p.add_partitioning_level(0)
    with pytest.raises(IndexError):
        p.remove_partitioning_level(5)


@pytest.mark.parametrize("phase", ["partition", "stage", "finish"])
def test_balance_fault_leaves_grid_unchanged(phase):
    """A fault before the rebuild leaves the partition, the data and
    the structure epoch as they were, nothing staged; the retry
    balances as the reference does."""
    r, p = make_pair(length=(6, 5, 4), partition="block")
    p.set_load_balancing_method("morton")
    r.set_load_balancing_method("morton")
    before = (p.plan.owner.copy(), state_digest(p), p.plan.epoch)
    plan = faults.FaultPlan()
    plan.mutation_error(site="balance.commit", phase=phase)
    # the balance is transactional: the injected error is the cause of
    # the rollback's MutationAbortedError, as in the reference
    with plan, pytest.raises(MutationAbortedError) as ei:
        p.balance_load()
    assert isinstance(ei.value.__cause__, faults.InjectedMutationError)
    assert plan.fired("balance.commit") == 1
    np.testing.assert_array_equal(p.plan.owner, before[0])
    assert (state_digest(p), p.plan.epoch) == before[1:]
    assert p._pending_owner is None and p._staged_balance == {}
    for g in (r, p):
        g.balance_load()
    assert_same(r, p)


def test_balance_spans_and_restructure(monkeypatch):
    telemetry.configure(trace=True)
    try:
        p = make_pair(n=4)[1]
        p.set_load_balancing_method("rcb")
        p.balance_load()
        names = [e["name"] for e in telemetry.events()]
    finally:
        telemetry.configure(trace=False)
    assert names.count("grid.balance") == 1
    assert names.count("grid.recommit") == 1
