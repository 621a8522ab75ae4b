"""The port's crash-safe distributed AMR commit
(``dccrg_tpu_torch/distamr.py``) against the reference's, on the CPU.

The counterparts of ``tests/test_distamr.py``: two faked ranks (process
splits of a four-partition grid, one shared
:class:`~dccrg_tpu_torch.coord.InMemoryKV`, one protocol thread per
rank) drive the four-phase epoch-fenced protocol end to end. A
committed round installs the structure the reference's one-process
commit of the merged requests gives (the reference on four virtual
devices): created cells, cell list, owners, plan digest and every
locally owned row bit for bit. An injected failure at every named fault
point aborts both ranks bit for bit and the retry commits; a torn
proposal, a zombie proposer, a dead peer, a slow rank at the commit
barrier, a roll-forward after a decided commit, the fence, the garbage
collection and a fatal post-decision install behave as the reference's.
Without a group, ``stop_refining`` is the one-process commit.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dccrg_tpu import distamr as ref_distamr
from dccrg_tpu.grid import Grid as RefGrid

from dccrg_tpu_torch import amr, coord, distamr, faults, fleet, txn
from dccrg_tpu_torch.checkpoint import state_digest
from dccrg_tpu_torch.grid import DEFAULT_NEIGHBORHOOD_ID, Grid

N_DEV = 4
HALF = N_DEV // 2


def _mk(length=(8, 8, 4), max_lvl=1):
    g = (Grid(cell_data={"v": torch.float32})
         .set_initial_length(length)
         .set_periodic(True, True, False)
         .set_maximum_refinement_level(max_lvl)
         .set_neighborhood_length(1)
         .initialize(["cpu"] * N_DEV, partition="block"))
    cells = g.plan.cells
    g.set("v", cells, (cells % np.uint64(23)).astype(np.float32))
    return g


def _ref_mk(length=(8, 8, 4), max_lvl=1):
    g = (RefGrid(cell_data={"v": jnp.float32})
         .set_initial_length(length)
         .set_periodic(True, True, False)
         .set_maximum_refinement_level(max_lvl)
         .set_neighborhood_length(1)
         .initialize(Mesh(np.array(jax.devices()[:N_DEV]), ("dev",)),
                     partition="block"))
    cells = g.plan.cells
    g.set("v", cells, (cells % np.uint64(23)).astype(np.float32))
    return g


def _devs(rank):
    return list(range(HALF) if rank == 0 else range(HALF, N_DEV))


def _fake_split(g, rank):
    g._proc_local_dev = np.array(
        [d in set(_devs(rank)) for d in range(g.n_dev)], dtype=bool)
    g._ckpt_rank = rank


def _pair(kv=None, timeout=60, membership=None):
    """Two faked ranks sharing one KV, distributed AMR enabled; returns
    (kv, {rank: grid})."""
    kv = kv if kv is not None else coord.InMemoryKV()
    grids = {}
    for rank in (0, 1):
        g = _mk()
        _fake_split(g, rank)
        g.enable_distributed_amr(kv=kv, rank=rank, n_ranks=2,
                                 timeout=timeout, membership=membership)
        grids[rank] = g
    return kv, grids


def _run_ranks(grids, fn, join_s=120):
    """fn(rank, grid) on one thread per rank; returns {rank: error}."""
    errs = {}

    def body(rank):
        try:
            fn(rank, grids[rank])
            errs[rank] = None
        except BaseException as e:  # noqa: BLE001 - asserted by caller
            errs[rank] = e

    ts = {r: threading.Thread(target=body, args=(r,)) for r in grids}
    for t in ts.values():
        t.start()
    for t in ts.values():
        t.join(join_s)
    assert all(not t.is_alive() for t in ts.values()), "rank wedged"
    return errs


def _digest(g):
    """One faked rank's world: plan digest, owned payload digest, the
    pending request sets and the fence (the reference's
    ``fuzz._dist_amr_digest``)."""
    return (distamr.plan_digest(g.plan), state_digest(g),
            tuple(sorted(g._refines)), tuple(sorted(g._unrefines)),
            tuple(sorted(g._dont_refines)),
            tuple(sorted(g._dont_unrefines)),
            g._amr_group.read_fence())


def _local_reqs(g, rank, count=4, stride=3):
    """``count`` locally owned level-0 cells of ``rank``, spread out."""
    mine = g.plan.cells[np.isin(g.plan.owner, _devs(rank))]
    return [int(c) for c in mine[: count * stride : stride]]


def _request(grids, reqs):
    for r, g in grids.items():
        for c in reqs[r]:
            g.refine_completely(c)


def _merged_reference(reqs):
    """The REFERENCE's one-process commit of the merged requests: what
    every rank's installed structure must equal bit for bit. Returns
    (cells, owner, plan digest, v, created cells)."""
    ref = _ref_mk()
    for r in sorted(reqs):
        for c in reqs[r]:
            ref.refine_completely(c)
    new = ref.stop_refining()
    ref.assign_children_from_parents(fields=["v"])
    ref.clear_refined_unrefined_data()
    return (ref.plan.cells.copy(), ref.plan.owner.copy(),
            ref_distamr.plan_digest(ref.plan), ref.get("v", ref.plan.cells),
            np.sort(new))


def _project(grids):
    for g in grids.values():
        g.assign_children_from_parents(fields=["v"])
        g.clear_refined_unrefined_data()


def _assert_matches_reference(grids, ref, created=None):
    cells, owner, pdig, v, new = ref
    for rank, g in grids.items():
        np.testing.assert_array_equal(g.plan.cells, cells,
                                      err_msg=f"rank {rank} cells")
        np.testing.assert_array_equal(g.plan.owner, owner,
                                      err_msg=f"rank {rank} owner")
        assert distamr.plan_digest(g.plan) == pdig, rank
        # a faked split writes only this rank's rows (the other rank's
        # happen in its own process): compare the owned ones
        mine = np.isin(owner, _devs(rank))
        g._proc_local_dev = np.ones(g.n_dev, dtype=bool)
        np.testing.assert_array_equal(g.get("v", cells[mine]), v[mine])
        if created is not None:
            np.testing.assert_array_equal(np.sort(created[rank]), new)


def test_two_rank_commit_matches_single_controller():
    kv, grids = _pair()
    reqs = {r: _local_reqs(grids[0], r) for r in (0, 1)}
    ref = _merged_reference(reqs)
    created = {}

    def body(rank, g):
        for c in reqs[rank]:
            g.refine_completely(c)
        created[rank] = g.stop_refining()
        assert len(created[rank]) == 8 * len(set(reqs[0]) | set(reqs[1]))

    errs = _run_ranks(grids, body)
    assert not any(errs.values()), errs
    _project(grids)
    assert grids[0]._amr_group.read_fence() == 1
    _assert_matches_reference(grids, ref, created)


@pytest.mark.parametrize("site,phase", faults.DIST_AMR_FAULT_SITES)
@pytest.mark.parametrize("victim", [0, 1])
def test_injected_abort_rolls_back_both_ranks_bitwise(site, phase,
                                                      victim):
    """An error at any named fault point aborts the round on EVERY rank
    (the victim by the injected error, the peer fast-aborted by the
    posted marker), both bit for bit pre-commit; the fault-free retry
    then commits the merged structure of the reference."""
    kv, grids = _pair()
    reqs = {r: _local_reqs(grids[0], r) for r in (0, 1)}
    _request(grids, reqs)
    before = {r: _digest(g) for r, g in grids.items()}

    plan = faults.FaultPlan().amr_error(site=site, phase=phase,
                                        rank=victim)
    with plan:
        errs = _run_ranks(grids, lambda _r, g: g.stop_refining())
    assert plan.fired(site) == 1, plan.log
    for r, e in errs.items():
        assert isinstance(e, txn.CrossRankAbortedError), (r, e)
    cause_v = errs[victim].__cause__
    cause_p = errs[1 - victim].__cause__
    assert isinstance(cause_v, faults.InjectedMutationError), cause_v
    assert isinstance(cause_p, coord.RemoteAbortError), cause_p
    assert cause_p.rank == victim
    for r, g in grids.items():
        assert _digest(g) == before[r], f"rank {r} not bitwise"

    ref = _merged_reference(reqs)
    errs = _run_ranks(grids, lambda _r, g: g.stop_refining())
    assert not any(errs.values()), errs
    _project(grids)
    assert grids[0]._amr_group.read_fence() == 1
    _assert_matches_reference(grids, ref)


def test_torn_proposal_record_convicted_never_parsed():
    kv, grids = _pair()
    reqs = {r: _local_reqs(grids[0], r) for r in (0, 1)}
    _request(grids, reqs)
    before = {r: _digest(g) for r, g in grids.items()}
    plan = faults.FaultPlan().amr_torn_record(site="amr.propose", rank=0)
    with plan:
        errs = _run_ranks(grids, lambda _r, g: g.stop_refining())
    assert plan.fired("amr.propose.torn") == 1, plan.log
    for r, e in errs.items():
        assert isinstance(e, txn.CrossRankAbortedError), (r, e)
    causes = {type(e.__cause__) for e in errs.values()}
    assert coord.TornRecordError in causes, causes
    for r, g in grids.items():
        assert _digest(g) == before[r], f"rank {r} not bitwise"
    errs = _run_ranks(grids, lambda _r, g: g.stop_refining())
    assert not any(errs.values()), errs
    assert grids[0]._amr_group.read_fence() == 1


def test_zombie_proposer_loses_to_advanced_fence(monkeypatch):
    kv, grids = _pair()
    g = grids[1]
    for c in _local_reqs(g, 1):
        g.refine_completely(c)
    before = _digest(g)
    old_cells = g.plan.cells.copy()

    def probe(phase, rank):
        # the survivors re-formed and committed while this rank was
        # stopped: the fence key moved on
        if phase == "propose":
            kv.set(g._amr_group.fence_key(), "1")

    monkeypatch.setattr(distamr, "_PHASE_PROBE", probe)
    with pytest.raises(txn.CrossRankAbortedError) as ei:
        g.stop_refining()
    assert isinstance(ei.value.__cause__, coord.StaleFenceError)
    assert _digest(g)[:-1] == before[:-1]  # all but the moved fence
    np.testing.assert_array_equal(g.plan.cells, old_cells)


class _StubMembership:
    """A lease view the test scripts directly: live until told dead."""

    lease_s = 1.0

    def __init__(self):
        self.live = {0, 1}

    def poll(self):
        pass

    def live_ranks(self):
        return set(self.live)

    def detect_dead_ranks(self):
        return {0, 1} - self.live


def test_peer_death_aborts_then_retry_reforms_over_survivors(monkeypatch):
    """Rank 1 dies mid-propose (no abort marker). The survivor's barrier
    convicts it through the lease view (PeerDeadError), rolls back bit
    for bit, and the retry re-forms over the survivor alone: rank 0
    commits its own requests, as the reference's commit of them."""
    stub = _StubMembership()
    kv, grids = _pair(timeout=30, membership=stub)
    reqs = {r: _local_reqs(grids[0], r) for r in (0, 1)}
    _request(grids, reqs)
    before = {r: _digest(g) for r, g in grids.items()}

    def probe(phase, rank):
        if rank == 0 and phase == "propose":
            stub.live.discard(1)

    outcome = {}

    def body(rank, g):
        if rank == 1:
            g.stop_refining()  # raises InjectedRankDeath
            return
        try:
            g.stop_refining()
            outcome["first"] = "committed"
        except txn.CrossRankAbortedError as e:
            outcome["first"] = e
        outcome["mid"] = _digest(g)
        outcome["new"] = g.stop_refining()

    monkeypatch.setattr(distamr, "_PHASE_PROBE", probe)
    with faults.FaultPlan().rank_death(site="amr.propose", rank=1):
        errs = _run_ranks(grids, body)
    assert isinstance(errs[1], faults.InjectedRankDeath), errs[1]
    assert errs[0] is None, errs[0]
    assert isinstance(outcome["first"], txn.CrossRankAbortedError)
    assert isinstance(outcome["first"].__cause__, coord.PeerDeadError)
    assert outcome["mid"] == before[0], "survivor not bitwise on abort"
    assert _digest(grids[1])[:-1] == before[1][:-1]
    cells, owner, pdig, _v, new = _merged_reference({0: reqs[0]})
    g0 = grids[0]
    assert g0._amr_group.read_fence() == 1
    np.testing.assert_array_equal(g0.plan.cells, cells)
    np.testing.assert_array_equal(g0.plan.owner, owner)
    assert distamr.plan_digest(g0.plan) == pdig
    np.testing.assert_array_equal(np.sort(outcome["new"]), new)


def test_slow_rank_at_commit_barrier_cannot_commit_alone(monkeypatch):
    """Rank 1 stalls before the commit barrier until rank 0 timed out,
    rolled back and posted the abort. Rank 1 then wakes into a barrier
    whose arrivals are all present and must still LOSE to the abort
    verdict; both ranks bit for bit pre-round, the retry commits."""
    kv, grids = _pair(timeout=60)
    grids[0]._amr_group.timeout = 3  # only rank 0's commit wait
    reqs = {r: _local_reqs(grids[0], r) for r in (0, 1)}
    _request(grids, reqs)
    before = {r: _digest(g) for r, g in grids.items()}
    abort_key = f"{grids[0]._amr_group.prefix}/abort/0#1"

    def probe(phase, rank):
        if rank == 1 and phase == "commit":
            deadline = time.monotonic() + 60
            while kv.get(abort_key) is None:
                assert time.monotonic() < deadline, "rank 0 never aborted"
                time.sleep(0.01)

    monkeypatch.setattr(distamr, "_PHASE_PROBE", probe)
    errs = _run_ranks(grids, lambda _r, g: g.stop_refining())
    monkeypatch.setattr(distamr, "_PHASE_PROBE", None)
    for r, e in errs.items():
        assert isinstance(e, txn.CrossRankAbortedError), (r, e)
    assert isinstance(errs[0].__cause__, coord.BarrierTimeoutError)
    assert isinstance(errs[1].__cause__, coord.RemoteAbortError)
    assert errs[1].__cause__.rank == 0
    for r, g in grids.items():
        assert _digest(g) == before[r], f"rank {r} not bitwise"
    assert grids[0]._amr_group.read_fence() == 0

    grids[0]._amr_group.timeout = 60
    ref = _merged_reference(reqs)
    errs = _run_ranks(grids, lambda _r, g: g.stop_refining())
    assert not any(errs.values()), errs
    _project(grids)
    assert grids[0]._amr_group.read_fence() == 1
    _assert_matches_reference(grids, ref)


def test_commit_barrier_failure_rolls_forward_when_decided(monkeypatch):
    """A rank whose commit barrier fails AFTER the verdict landed as
    COMMIT installs with the fleet: its abort bid loses the race."""
    kv, grids = _pair()
    reqs = {r: _local_reqs(grids[0], r) for r in (0, 1)}
    _request(grids, reqs)
    ref = _merged_reference(reqs)
    real = distamr._Attempt.barrier

    def wrapped(self, phase, value="1"):
        out = real(self, phase, value=value)
        if phase == "commit" and self.group.rank == 1:
            deadline = time.monotonic() + 60
            while self.group.kv.get(self.decision_key()) is None:
                assert time.monotonic() < deadline, "no verdict landed"
                time.sleep(0.01)
            raise coord.BarrierTimeoutError(self.tag(phase), 0.0)
        return out

    monkeypatch.setattr(distamr._Attempt, "barrier", wrapped)
    errs = _run_ranks(grids, lambda _r, g: g.stop_refining())
    assert not any(errs.values()), errs  # BOTH ranks committed
    _project(grids)
    assert grids[0]._amr_group.read_fence() == 1
    _assert_matches_reference(grids, ref)


def test_fence_advance_is_monotonic_and_zombie_proof():
    kv, grids = _pair()
    group = grids[0]._amr_group
    assert group.read_fence() == 0
    assert group.advance_fence(1) == 1
    assert group.advance_fence(2) == 2
    assert group.advance_fence(1) == 2
    assert group.read_fence() == 2
    kv.set(group.fence_key(), "1")
    assert group.read_fence() == 2
    kv.set(group.fence_key(), "5")
    assert group.read_fence() == 5


def test_committed_rounds_are_garbage_collected():
    kv, grids = _pair()
    prefix = grids[0]._amr_group.prefix
    reqs = {r: _local_reqs(grids[0], r) for r in (0, 1)}
    _request(grids, reqs)
    with faults.FaultPlan().amr_error(site="amr.resolve", rank=0):
        errs = _run_ranks(grids, lambda _r, g: g.stop_refining())
    assert all(isinstance(e, txn.CrossRankAbortedError)
               for e in errs.values()), errs
    errs = _run_ranks(grids, lambda _r, g: g.stop_refining())
    assert not any(errs.values()), errs
    _project(grids)
    assert kv.dir_get(f"{prefix}/b/0#"), "round-0 keys collected early"
    assert kv.dir_get(f"{prefix}/abort/0#")
    for r, g in grids.items():
        cells, owner = g.plan.cells, g.plan.owner
        lvl = g.mapping.get_refinement_level(cells)
        mine = cells[np.isin(owner, _devs(r)) & (lvl < 1)]
        for c in mine[:2]:
            g.refine_completely(int(c))
    errs = _run_ranks(grids, lambda _r, g: g.stop_refining())
    assert not any(errs.values()), errs
    assert grids[0]._amr_group.read_fence() == 2
    for sub in (f"{prefix}/b/0#", f"{prefix}/abort/0#",
                f"{prefix}/decision/0#"):
        assert not kv.dir_get(sub), (sub, kv.dir_get(sub))
    assert kv.dir_get(f"{prefix}/fence/")


def test_post_decision_install_failure_is_fatal_not_divergent(
        monkeypatch):
    kv, grids = _pair()
    reqs = {r: _local_reqs(grids[0], r) for r in (0, 1)}
    _request(grids, reqs)
    died = []
    monkeypatch.setattr(distamr, "_FATAL_INSTALL", died.append)

    def broken_install(plan, same_cells=None):
        raise RuntimeError("injected install fault")

    grids[1]._install_plan = broken_install
    errs = _run_ranks(grids, lambda _r, g: g.stop_refining())
    del grids[1]._install_plan
    assert errs[0] is None, errs[0]
    assert isinstance(errs[1], RuntimeError), errs[1]
    assert len(died) == 1 and isinstance(died[0], RuntimeError)
    assert not isinstance(errs[1], txn.CrossRankAbortedError)
    assert grids[0]._amr_group.read_fence() == 1


def test_frontier_induced_refines_properties():
    g = _mk(max_lvl=2)
    offsets = g.neighborhoods[DEFAULT_NEIGHBORHOOD_ID]
    cells, owner = g.plan.cells, g.plan.owner
    empty = amr.frontier_induced_refines(
        g.mapping, cells, owner, offsets, set(), [0], topology=g.topology)
    assert empty.dtype == np.uint64 and len(empty) == 0
    corner = int(cells[0])
    assert len(amr.frontier_induced_refines(
        g.mapping, cells, owner, offsets, {corner},
        range(g.n_dev), topology=g.topology)) == 0
    g.refine_completely(corner)
    new = g.stop_refining()
    g.clear_refined_unrefined_data()
    cells, owner = g.plan.cells, g.plan.owner
    child = int(np.min(new))
    lvl = g.mapping.get_refinement_level(cells)
    f0 = amr.frontier_induced_refines(
        g.mapping, cells, owner, offsets, {child}, [0], topology=g.topology)
    assert len(f0), "corner child induces nothing across the boundary"
    assert np.array_equal(f0, np.sort(f0)) and f0.dtype == np.uint64
    pos = np.searchsorted(cells, f0)
    np.testing.assert_array_equal(cells[pos], f0)
    child_lvl = int(g.mapping.get_refinement_level(
        np.asarray([child], dtype=np.uint64))[0])
    assert (lvl[pos] < child_lvl).all(), "frontier must be coarser"
    assert not np.isin(owner[pos], [0]).any(), "frontier must be foreign"
    f01 = amr.frontier_induced_refines(
        g.mapping, cells, owner, offsets, {child}, [0, 1],
        topology=g.topology)
    assert set(int(c) for c in f01) <= set(int(c) for c in f0)


def test_single_controller_path_is_unchanged():
    """Without a commit group, stop_refining IS the one-process commit,
    bit for bit the reference's commit of the same requests."""
    a, b = _mk(), _mk()
    picks = [int(c) for c in a.plan.cells[:9:3]]
    for g in (a, b):
        for c in picks:
            g.refine_completely(c)
    ra = a.stop_refining()
    rb = b._stop_refining_local()
    np.testing.assert_array_equal(ra, rb)
    np.testing.assert_array_equal(a.plan.cells, b.plan.cells)
    np.testing.assert_array_equal(a.plan.owner, b.plan.owner)
    for g in (a, b):
        g.assign_children_from_parents(fields=["v"])
        g.clear_refined_unrefined_data()
    np.testing.assert_array_equal(a.get("v", a.plan.cells),
                                  b.get("v", b.plan.cells))
    cells, owner, pdig, v, new = _merged_reference({0: picks})
    np.testing.assert_array_equal(a.plan.cells, cells)
    np.testing.assert_array_equal(a.plan.owner, owner)
    assert distamr.plan_digest(a.plan) == pdig
    np.testing.assert_array_equal(a.get("v", cells), v)
    np.testing.assert_array_equal(np.sort(ra), new)
    # enable, then disable: the group is gone and the commit is local
    a.enable_distributed_amr(kv=coord.InMemoryKV(), rank=0, n_ranks=1)
    a.disable_distributed_amr()
    assert a._amr_group is None


def test_one_rank_group_commits_like_the_local_commit():
    """A group of one rank (the process-group default in one process:
    ``coord.process_count()`` ranks) commits the local commit's bytes."""
    a, b = _mk(), _mk()
    group = a.enable_distributed_amr(kv=coord.InMemoryKV())
    assert group.n_ranks == 1 and group.rank == 0
    picks = [int(c) for c in a.plan.cells[1:20:4]]
    for g in (a, b):
        for c in picks:
            g.refine_completely(c)
    ra = a.stop_refining()
    rb = b.stop_refining()
    np.testing.assert_array_equal(ra, rb)
    a.disable_distributed_amr()
    for g in (a, b):
        g.assign_children_from_parents(fields=["v"])
    assert state_digest(a) == state_digest(b)
    assert distamr.plan_digest(a.plan) == distamr.plan_digest(b.plan)


def test_fleet_refuses_a_per_host_swap_of_a_distributed_grid(monkeypatch):
    """A distributed-AMR grid with a deferred plan build must never be
    swapped at a per-host quantum boundary."""
    g = _mk()
    g.enable_distributed_amr(kv=coord.InMemoryKV(), rank=0, n_ranks=1)
    batch = fleet.GridBatch.__new__(fleet.GridBatch)
    batch.grid = g
    monkeypatch.setattr(g, "bg_pending", lambda: True)
    with pytest.raises(RuntimeError, match="distributed-AMR"):
        batch.step(np.ones(1, dtype=np.int32))
