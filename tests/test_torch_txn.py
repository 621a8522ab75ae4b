"""Transactional mutation atomicity (txn.py) of the port, held to the
reference.

tests/test_txn.py's scenarios: a FaultPlan fault injected at every
fault point of the adapt commit and of ``balance_load``
(``faults.MUTATION_FAULT_SITES``) must leave the port's grid bit for bit
its pre-mutation state (``grid_state_bytes``, the ``.dc`` bytes, which
equal the reference's grid's), pass ``verify_all``, and let the same
mutation be retried, whose result is the reference's fault-free
mutation byte for byte. Then what the port adds because torch tensors
are mutable: in-place writes inside a transaction (``set``, the halo
exchange) roll back too, and a second plan build inside one transaction
does not reuse the rollback plan's arena buffers.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dccrg_tpu.grid import Grid as RefGrid
from dccrg_tpu.txn import grid_state_bytes as ref_state_bytes

from dccrg_tpu_torch import (Grid, GridInvariantError, MutationAbortedError,
                             VerificationError, verify_all)
from dccrg_tpu_torch import verify as V
from dccrg_tpu_torch.faults import (MUTATION_FAULT_SITES, FaultPlan,
                                    InjectedMutationError)
from dccrg_tpu_torch.txn import (CrossRankAbortedError, grid_state_bytes,
                                 grid_transaction, restore_state,
                                 snapshot_state)

pytestmark = pytest.mark.faultinject

ADAPT_SITES = MUTATION_FAULT_SITES["adapt"]
BALANCE_SITES = MUTATION_FAULT_SITES["balance"]


def make_grid(ref=False, n_dev=4, length=(4, 4, 2), max_lvl=2, refined=True):
    """tests/test_txn.py's grid, by either package."""
    if ref:
        g = (RefGrid(cell_data={"rho": jnp.float32, "mom": ((3,), jnp.float32)})
             .set_initial_length(length).set_maximum_refinement_level(max_lvl)
             .set_periodic(True, True, True).set_neighborhood_length(1)
             .initialize(Mesh(np.array(jax.devices()[:n_dev]), ("dev",))))
    else:
        g = (Grid(cell_data={"rho": torch.float32, "mom": ((3,), torch.float32)})
             .set_initial_length(length).set_maximum_refinement_level(max_lvl)
             .set_periodic(True, True, True).set_neighborhood_length(1)
             .initialize(["cpu"] * n_dev))
    if refined:
        g.refine_completely(int(g.get_cells()[0]))
        g.stop_refining()
    rng = np.random.default_rng(7)
    cells = g.get_cells()
    g.set("rho", cells, rng.random(len(cells)).astype(np.float32))
    g.set("mom", cells, rng.random((len(cells), 3)).astype(np.float32))
    g.pin(int(cells[-1]), 1)
    g.set_cell_weight(int(cells[0]), 2.0)
    g.balance_load()  # apply the pin so full verify_all holds
    return g


@functools.lru_cache(maxsize=None)
def _reference(op):
    """The reference's (pre-mutation bytes, fault-free result bytes)."""
    g = make_grid(ref=True)
    if op == "adapt":
        assert g.refine_completely(int(g.get_cells()[3]))
    before = ref_state_bytes(g)
    g.stop_refining() if op == "adapt" else g.balance_load()
    return before, ref_state_bytes(g)


@pytest.mark.parametrize("site,phase", ADAPT_SITES)
def test_adapt_fault_rolls_back_bitwise(site, phase):
    g = make_grid()
    pins_before = g.get_pin_requests()
    weights_before = dict(g._weights)
    target = int(g.get_cells()[3])
    assert g.refine_completely(target)
    before = grid_state_bytes(g)
    ref_before, ref_after = _reference("adapt")
    assert before == ref_before

    plan = FaultPlan(seed=1)
    plan.mutation_error(site=site, times=1, phase=phase)
    with plan:
        with pytest.raises(MutationAbortedError) as ei:
            g.stop_refining()
    assert plan.fired(site) == 1
    assert isinstance(ei.value.__cause__, InjectedMutationError)
    assert ei.value.op == "stop_refining"

    assert grid_state_bytes(g) == before
    assert g.get_pin_requests() == pins_before
    assert g._weights == weights_before
    verify_all(g)

    # the refine request survived the rollback: the retry commits what
    # the reference's fault-free commit does
    new = g.stop_refining()
    assert len(new) >= 8
    assert np.isin(g.mapping.get_all_children(np.uint64(target)),
                   g.get_cells()).all()
    assert grid_state_bytes(g) == ref_after
    verify_all(g)


@pytest.mark.parametrize("site,phase", BALANCE_SITES)
def test_balance_fault_rolls_back_bitwise(site, phase):
    g = make_grid()
    before = grid_state_bytes(g)
    owner_before = g.plan.owner.copy()
    ref_before, ref_after = _reference("balance")
    assert before == ref_before

    plan = FaultPlan(seed=2)
    plan.mutation_error(site=site, times=1, phase=phase)
    with plan:
        with pytest.raises(MutationAbortedError) as ei:
            g.balance_load()
    assert plan.fired(site) == 1
    assert ei.value.op == "balance_load"

    assert grid_state_bytes(g) == before
    assert np.array_equal(g.plan.owner, owner_before)
    assert g._pending_owner is None and g._staged_balance == {}
    verify_all(g)

    g.balance_load()  # the retry succeeds
    assert grid_state_bytes(g) == ref_after
    verify_all(g)


def test_staged_finish_fault_preserves_staging():
    g = make_grid()
    g.initialize_balance_load()
    g.continue_balance_load()
    pending = g._pending_owner.copy()

    plan = FaultPlan(seed=3)
    plan.mutation_error(site="balance.commit", times=1, phase="land")
    with plan:
        with pytest.raises(MutationAbortedError):
            g.finish_balance_load()
    assert np.array_equal(g._pending_owner, pending)
    assert set(g._staged_balance) == set(g.fields)
    g.finish_balance_load()
    verify_all(g)


def test_unrefine_fault_rolls_back():
    g = make_grid()
    lvl1 = [int(c) for c in g.get_cells()
            if g.mapping.get_refinement_level(np.uint64(c)) == 1]
    assert g.unrefine_completely(lvl1[0])
    before = grid_state_bytes(g)

    plan = FaultPlan(seed=4)
    plan.mutation_error(site="adapt.commit", times=1, phase="preserved")
    with plan:
        with pytest.raises(MutationAbortedError):
            g.stop_refining()
    assert grid_state_bytes(g) == before
    g.stop_refining()
    verify_all(g)


def test_load_cells_fault_rolls_back():
    """load_cells is one transaction: a fault in its partitioner leaves
    the grid, its data included, as it was."""
    g = make_grid()
    before = grid_state_bytes(g)
    cells = g.get_cells()
    plan = FaultPlan(seed=6)
    plan.mutation_error(site="partition.compute", times=1)
    with plan:
        with pytest.raises(MutationAbortedError) as ei:
            g.load_cells(cells)
    assert ei.value.op == "load_cells"
    assert grid_state_bytes(g) == before
    g.load_cells(cells)
    verify_all(g)


@pytest.mark.parametrize("crash", [False, True])
def test_post_commit_validation_rolls_back(monkeypatch, crash):
    """A broken invariant found by the post-commit verify_all (or the
    verifier crashing on the committed state) rolls the commit back
    under GridInvariantError, naming the cells."""
    g = make_grid()
    g._debug = True
    before = grid_state_bytes(g)

    def planted(grid):
        if crash:
            raise ValueError("verifier blew up on malformed state")
        raise VerificationError("planted invariant break", cells=(17, 23))

    monkeypatch.setattr(V, "verify_partition_coverage", planted)
    assert g.refine_completely(int(g.get_cells()[2]))
    with pytest.raises(GridInvariantError) as ei:
        g.stop_refining()
    if crash:
        assert isinstance(ei.value.__cause__, ValueError)
    else:
        assert ei.value.cells == (17, 23) and "17" in str(ei.value)
    monkeypatch.undo()
    assert grid_state_bytes(g) == before
    verify_all(g)
    assert len(g.stop_refining()) >= 8


def test_nested_transaction_joins_outer():
    g = make_grid(refined=False)
    before = grid_state_bytes(g)
    with pytest.raises(MutationAbortedError):
        with grid_transaction(g, op="outer"):
            with grid_transaction(g, op="inner"):
                g.balance_load()  # joins too (depth 3)
            raise RuntimeError("outer failure after inner success")
    assert grid_state_bytes(g) == before
    assert g._txn_depth == 0
    verify_all(g)


def test_transaction_errors_are_typed():
    g = make_grid(refined=False)
    with pytest.raises(RuntimeError):
        with grid_transaction(g, op="noop"):
            raise ValueError("boom")
    try:
        with grid_transaction(g, op="noop"):
            raise ValueError("boom")
    except MutationAbortedError as e:
        assert e.op == "noop"
        assert isinstance(e.__cause__, ValueError)
    else:  # pragma: no cover
        pytest.fail("MutationAbortedError not raised")
    seen = []
    from dccrg_tpu_torch.txn import cross_rank_transaction

    with pytest.raises(CrossRankAbortedError) as ei:
        with cross_rank_transaction(g, op="dist", rank=3,
                                    on_abort=seen.append):
            raise KeyError("peer")
    assert ei.value.rank == 3 and isinstance(seen[0], MutationAbortedError)
    with pytest.raises(KeyboardInterrupt):
        with grid_transaction(g):
            g._refines.add(5)
            raise KeyboardInterrupt
    assert g._refines == set() and g._txn_depth == 0


def test_fault_exhausted_plan_does_not_fire():
    g = make_grid(refined=False)
    plan = FaultPlan(seed=5)
    plan.mutation_error(site="balance.commit", times=1, phase="finish")
    with plan:
        with pytest.raises(MutationAbortedError):
            g.balance_load()
        g.balance_load()  # the rule is exhausted
    assert plan.fired("balance.commit") == 1
    verify_all(g)


def test_in_place_writes_roll_back():
    """Torch tensors are mutable: ``set`` and the halo exchange write in
    place, so inside a transaction they first clone the snapshot's
    tensors; a rollback reinstates the very tensors, ghost rows
    included, bit for bit."""
    g = make_grid(refined=False)
    tensors = dict(g.data)
    values = {n: t.clone() for n, t in g.data.items()}
    cells = g.get_cells()
    with pytest.raises(MutationAbortedError):
        with grid_transaction(g, op="writes"):
            g.set("rho", cells, np.full(len(cells), 9.0, np.float32))
            g.update_copies_of_remote_neighbors()
            g.start_remote_neighbor_copy_updates(fields=["mom"])
            g.set("mom", cells[:3], np.zeros((3, 3), np.float32))
            g.wait_remote_neighbor_copy_updates()
            assert g.data["rho"] is not tensors["rho"]
            raise RuntimeError("after the writes")
    for n, t in tensors.items():
        assert g.data[n] is t
        torch.testing.assert_close(t, values[n], rtol=0, atol=0)
    assert g._pending == {}
    # outside a transaction the writes stay in place
    g.set("rho", cells, np.full(len(cells), 2.0, np.float32))
    assert g.data["rho"] is tensors["rho"]


def test_second_build_spares_the_rollback_plan():
    """Two commits inside one transaction: the second build reclaims the
    first's arena buffers but never the rollback plan's (protected as
    ``_txn_plan``), so the rollback's plan tables are intact."""
    g = make_grid()
    hood = g.plan.hoods[-0xDCC]
    saved = {k: np.array(getattr(hood, k)) for k in
             ("nbr_rows", "nbr_mask", "hard_rows", "hard_nbr_rows",
              "hard_mask")}
    plan_before = g.plan
    before = grid_state_bytes(g)
    with pytest.raises(MutationAbortedError):
        with grid_transaction(g, op="two commits"):
            for i in (5, 9):
                g.refine_completely(int(g.get_cells()[i]))
                g.stop_refining()
            raise RuntimeError("abort after two builds")
    assert g.plan is plan_before
    for k, v in saved.items():
        np.testing.assert_array_equal(np.asarray(getattr(hood, k)), v)
    assert grid_state_bytes(g) == before
    verify_all(g)


def test_snapshot_restores_more_than_once():
    g = make_grid(refined=False)
    snap = snapshot_state(g)
    before = grid_state_bytes(g)
    for _ in range(2):
        g.refine_completely(int(g.get_cells()[0]))
        g.stop_refining()
        restore_state(g, snap)
        assert grid_state_bytes(g) == before
