"""The port's background recommit and async checkpoint save
(dccrg_tpu_torch.background) against the reference, on the CPU.

tests/test_bgrecommit.py's recommit scenarios on the port's grid of
four partitions: plans built on the background worker equal the
synchronous builds bit for bit (``plan_fingerprint``, the reference
test's SHA-256 over the layout and every hood table), and both equal
the reference's synchronous plans, across refine, unrefine and balance
epochs, with steps served on the live plan while the worker builds; a
finished plan installs only at a step boundary (or a data access that
needs the new epoch, or a fleet quantum boundary); a transaction abort
mid-build, a worker crash and a swap abort leave the grid bit for bit
as the synchronous path would. Then ``AsyncSaver`` against a
synchronous ``save_checkpoint`` (file and sidecar bytes), a torn write
surfacing at the drain, and a ``freeze_grid`` snapshot that a later
in-place ``set`` does not reach.
"""

import hashlib
import os
import threading

import numpy as np
import pytest
import torch

from test_recommit import make_grid as ref_make_grid
from test_recommit import plan_fingerprint

from dccrg_tpu_torch import Grid, MutationAbortedError, telemetry, verify
from dccrg_tpu_torch import checkpoint as checkpoint_mod
from dccrg_tpu_torch import resilience
from dccrg_tpu_torch.background import (AsyncSaver, PlanBuildWorker,
                                        PrewarmWorker, freeze_grid)
from dccrg_tpu_torch.faults import FaultPlan
from dccrg_tpu_torch.fleet import FleetJob, GridBatch
from dccrg_tpu_torch.txn import grid_state_bytes, grid_transaction

pytestmark = pytest.mark.bgrecommit


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("DCCRG_BG_RECOMMIT", raising=False)
    monkeypatch.delenv("DCCRG_ASYNC_SAVE", raising=False)
    telemetry.registry().reset()


def make_grid(length=(6, 5, 4), periodic=(False, True, False), n_dev=4,
              max_ref=2):
    """tests/test_recommit.py's grid, on ``n_dev`` partitions of the
    CPU."""
    return (Grid(cell_data={"v": torch.float32})
            .set_initial_length(length)
            .set_periodic(*periodic)
            .set_maximum_refinement_level(max_ref)
            .set_neighborhood_length(1)
            .initialize(["cpu"] * n_dev))


def _kernel(cell, nbr, offs, mask, *extra):
    d = torch.where(mask, nbr["v"] - cell["v"][:, None],
                    torch.zeros((), dtype=torch.float32))
    return {"v": cell["v"] + np.float32(0.01) * d.sum(dim=1)}


def _seed(g):
    cells = g.plan.cells
    g.set("v", cells, (cells.astype(np.float64) % 29).astype(np.float32))
    g.update_copies_of_remote_neighbors()


def _step(g, n=1):
    g.run_steps(_kernel, ["v"], ["v"], n)


def _adapt_balance_sequence(g, flush_fn):
    """refine -> recommit -> balance -> unrefine (the reference test's
    sequence), a plan fingerprint after every commit."""
    out = []

    def flush():
        flush_fn(g)
        out.append(plan_fingerprint(g))

    for c in (1, 2, 3):
        g.refine_completely(c)
    g.stop_refining()
    flush()
    for c in g.plan.cells[:6]:
        g.refine_completely(int(c))
    g.stop_refining()
    flush()
    g.balance_load()
    out.append(plan_fingerprint(g))  # balance installs synchronously
    lvl = g.mapping.get_refinement_level(g.plan.cells)
    deepest = g.plan.cells[lvl == lvl.max()]
    g.unrefine_completely(int(deepest[0]))
    g.stop_refining()
    flush()
    return out


def _port_sequence(bg, monkeypatch, steps_between=0, build_first=False):
    """The sequence on the port; with ``steps_between``, that many steps
    are served at each commit's swap. By default the plan-build worker
    is held on an event until they have run, so every one of them steps
    the old plan; with ``build_first`` the build finishes before them,
    so the first step's own swap point installs the new plan and they
    all step it."""
    monkeypatch.setenv("DCCRG_BG_RECOMMIT", "1" if bg else "0")
    gate = threading.Event()
    if steps_between and not build_first:
        work = PlanBuildWorker._work

        def held(self):
            assert gate.wait(60), "the held build was never released"
            work(self)

        monkeypatch.setattr(PlanBuildWorker, "_work", held)
    g = make_grid()
    _seed(g)

    def flush(g):
        if steps_between and g.bg_pending():
            if build_first:
                assert g._bg_build.wait(60)
            _step(g, steps_between)
            if build_first:
                assert not g.bg_pending()  # the step's swap installed it
            else:
                assert g.bg_pending()  # served on the live plan
                gate.set()
        g.bg_install(wait=True)
        gate.clear()

    fps = _adapt_balance_sequence(g, flush)
    return fps, checkpoint_mod.state_digest(g)


def _sync_twin(steps_between, commit_first):
    """The synchronous run of the sequence, ``steps_between`` steps
    served at each commit: before it (``commit_first=False``, the old
    plan) or after it (the new plan)."""
    g = make_grid()
    _seed(g)

    def commit():
        if commit_first:
            g.stop_refining()
            _step(g, steps_between)
        else:
            _step(g, steps_between)
            g.stop_refining()

    for c in (1, 2, 3):
        g.refine_completely(c)
    commit()
    for c in g.plan.cells[:6]:
        g.refine_completely(int(c))
    commit()
    g.balance_load()
    lvl = g.mapping.get_refinement_level(g.plan.cells)
    g.unrefine_completely(int(g.plan.cells[lvl == lvl.max()][0]))
    commit()
    return checkpoint_mod.state_digest(g)


@pytest.fixture(scope="module")
def ref_fingerprints():
    """The reference's synchronous plans of the same sequence."""
    g = ref_make_grid()
    return _adapt_balance_sequence(g, lambda g: None)


# -- plan identity ------------------------------------------------------

def test_bg_plan_parity_across_refine_unrefine_balance(monkeypatch,
                                                       ref_fingerprints):
    sync, _ = _port_sequence(False, monkeypatch)
    bg, _ = _port_sequence(True, monkeypatch)
    assert sync == bg
    assert sync == ref_fingerprints


@pytest.mark.parametrize("steps_between", [1, 2])
def test_bg_parity_with_serving_between(monkeypatch, ref_fingerprints,
                                        steps_between):
    """Steps served on the live plan while the worker builds (held on an
    event until they have run) change nothing about the plan the swap
    installs; the state equals a synchronous run that served the same
    steps on the old plan first."""
    bg, bg_digest = _port_sequence(True, monkeypatch, steps_between)
    assert bg == ref_fingerprints
    monkeypatch.setenv("DCCRG_BG_RECOMMIT", "0")
    assert _sync_twin(steps_between, commit_first=False) == bg_digest


@pytest.mark.parametrize("steps_between", [1, 2])
def test_bg_parity_build_done_before_serving(monkeypatch, ref_fingerprints,
                                             steps_between):
    """A build that finished before the served steps installs at the
    first step's own swap point, so every step runs the new plan; the
    state equals a synchronous run that committed first."""
    bg, bg_digest = _port_sequence(True, monkeypatch, steps_between,
                                   build_first=True)
    assert bg == ref_fingerprints
    monkeypatch.setenv("DCCRG_BG_RECOMMIT", "0")
    assert _sync_twin(steps_between, commit_first=True) == bg_digest


def test_prewarm_derives_the_first_steps_host_tables(monkeypatch):
    """On four partitions with the overlap on, the worker derives the
    new plan's exchange tables and outer re-pass rows; the first step
    after the swap finds them, and the capacity memo and the state end
    equal to the synchronous run's."""
    from dccrg_tpu_torch.grid import DEFAULT_NEIGHBORHOOD_ID as HID

    monkeypatch.setenv("DCCRG_OVERLAP", "1")
    out = {}
    for bg in (False, True):
        monkeypatch.setenv("DCCRG_BG_RECOMMIT", "1" if bg else "0")
        # z slabs thick enough that the overlap engages
        g = (Grid(cell_data={"v": torch.float32})
             .set_initial_length((6, 5, 24)).set_periodic(False, True, True)
             .set_maximum_refinement_level(1).set_neighborhood_length(1)
             .set_load_balancing_method("block").initialize(["cpu"] * 4))
        _seed(g)
        _step(g, 2)
        assert g.last_overlap["mode"] == "full"
        for c in (1, 2, 3):
            g.refine_completely(c)
        g.stop_refining()
        if bg:
            assert g._bg_build.wait(60)
            hood = g._bg_build.plan.hoods[HID]
            assert any(k[0] == "peer" for k in hood._pair_host)
            assert getattr(hood, "_outer_host", None) is not None
        _step(g, 3)
        out[bg] = (dict(g._cap_memo), checkpoint_mod.state_digest(g),
                   plan_fingerprint(g))
    assert out[True] == out[False]


def test_bg_negative_pin(monkeypatch):
    """Unset, stop_refining never leaves a pending build."""
    g = make_grid()
    for c in (1, 2, 3):
        g.refine_completely(c)
    g.stop_refining()
    assert not g.bg_pending()
    assert telemetry.registry().counter_total(
        "dccrg_recommit_bg_builds_total") == 0


# -- the swap points ----------------------------------------------------

def test_swap_only_at_step_boundary(monkeypatch):
    monkeypatch.setenv("DCCRG_BG_RECOMMIT", "1")
    g = make_grid()
    _seed(g)
    n_before = len(g.plan.cells)
    fp_before = plan_fingerprint(g)
    for c in (1, 2, 3):
        g.refine_completely(c)
    new_cells = g.stop_refining()
    assert g.bg_pending()
    g._bg_build.wait()  # finished, not installed
    assert g.bg_pending()
    assert len(g.plan.cells) == n_before  # the old epoch still serves
    assert plan_fingerprint(g) == fp_before
    assert not np.isin(new_cells, g.plan.cells).any()
    _step(g)  # the boundary
    assert not g.bg_pending()
    assert len(g.plan.cells) == n_before + len(new_cells) - 3
    assert np.isin(new_cells, g.plan.cells).all()
    assert set(g.last_bg_install) == {"wait", "swap", "build"}


def test_data_access_to_new_cells_is_a_boundary(monkeypatch):
    monkeypatch.setenv("DCCRG_BG_RECOMMIT", "1")
    g = make_grid()
    _seed(g)
    for c in (1, 2, 3):
        g.refine_completely(c)
    new_cells = g.stop_refining()
    assert g.bg_pending()
    vals = g.get("v", new_cells[:4])  # needs the new epoch: installs
    assert not g.bg_pending()
    assert np.all(vals == 0.0)  # fresh children zero-initialized
    g.set("v", new_cells, np.ones(len(new_cells), dtype=np.float32))
    assert np.all(g.get("v", new_cells) == 1.0)


def test_fleet_quantum_boundary_installs(monkeypatch):
    """GridBatch.step is a swap point: a pending build of its scratch
    grid installs at the quantum boundary; with none pending the poll
    leaves the quantum unchanged."""
    monkeypatch.setenv("DCCRG_BG_RECOMMIT", "1")
    job = FleetJob("j0", length=(6, 6, 6), n_steps=4, seed=1,
                   params=(0.03,))
    batch = GridBatch(job, capacity=2, device="cpu")
    job.apply_init(batch.grid)
    slot = batch.admit(job)
    assert not batch.grid.bg_pending()
    batch.step(np.array([2, 0], dtype=np.int32))
    want = batch.digest(slot)
    # a deferred build on the scratch grid (same cells: a no-op epoch)
    g = batch.grid
    g._restructure(g.plan.cells.copy(), g.plan.owner.copy(), defer_ok=True)
    assert g.bg_pending()
    g._bg_build.wait()
    epoch = g.plan.epoch
    batch.step(np.array([0, 0], dtype=np.int32))  # q == 0: still a boundary
    assert not g.bg_pending() and g.plan.epoch == epoch + 1
    assert batch.digest(slot) == want


# -- aborts and failures ------------------------------------------------

def test_txn_abort_mid_build_discards_and_restores_bitwise(
        monkeypatch, ref_fingerprints):
    monkeypatch.setenv("DCCRG_BG_RECOMMIT", "1")
    g = make_grid()
    _seed(g)
    for c in (1, 2, 3):
        g.refine_completely(c)
    before = grid_state_bytes(g)
    with pytest.raises(MutationAbortedError):
        with grid_transaction(g, op="outer"):
            g.stop_refining()
            assert g.bg_pending()  # submitted inside the transaction
            raise RuntimeError("abort with the build in flight")
    assert not g.bg_pending()  # discarded, worker joined
    assert grid_state_bytes(g) == before
    # the requests survived the rollback: the retry reconverges to the
    # synchronous build's plan
    g.stop_refining()
    g.bg_install(wait=True)
    assert plan_fingerprint(g) == ref_fingerprints[0]


def test_worker_crash_falls_back_to_inline(monkeypatch, ref_fingerprints):
    monkeypatch.setenv("DCCRG_BG_RECOMMIT", "1")
    g = make_grid()
    _seed(g)
    for c in (1, 2, 3):
        g.refine_completely(c)
    plan = FaultPlan(seed=3)
    plan.mutation_error(site="hybrid.recommit", phase="tables")
    with plan:
        g.stop_refining()
        g._bg_build.wait()
        assert g._bg_build.error is not None  # the worker crashed
        _step(g)  # boundary: inline rebuild + install
    assert plan.fired("hybrid.recommit") == 1
    assert not g.bg_pending()
    assert plan_fingerprint(g) == ref_fingerprints[0]
    assert telemetry.registry().counter_total(
        "dccrg_recommit_bg_errors_total") == 1


def test_swap_abort_leaves_live_epoch_bitwise(monkeypatch):
    monkeypatch.setenv("DCCRG_BG_RECOMMIT", "1")
    g = make_grid()
    _seed(g)
    for c in (1, 2, 3):
        g.refine_completely(c)
    g.stop_refining()
    g._bg_build.wait()
    before = grid_state_bytes(g)
    plan = FaultPlan(seed=4)
    plan.mutation_error(site="grid.restructure", phase="planned")
    with plan, pytest.raises(MutationAbortedError):
        _step(g)
    assert grid_state_bytes(g) == before
    assert not g.bg_pending()
    _step(g, 2)  # the old epoch still serves


def test_balance_drains_pending_build_first(monkeypatch):
    monkeypatch.setenv("DCCRG_BG_RECOMMIT", "1")
    g = make_grid()
    _seed(g)
    for c in (1, 2, 3):
        g.refine_completely(c)
    g.stop_refining()
    assert g.bg_pending()
    g.balance_load()  # the entry barrier installs, then rebalances
    assert not g.bg_pending()
    verify.verify_all(g, check_pins=False)


def test_data_items_recomputed_at_bg_install(monkeypatch):
    """Cached cell items are recomputed at the swap, as at a
    synchronous commit."""
    monkeypatch.setenv("DCCRG_BG_RECOMMIT", "1")
    g = make_grid()
    g.add_cell_data_item("lvl", lambda g, ids:
                         g.mapping.get_refinement_level(ids))
    n0 = len(g.cell_data_item("lvl"))
    g.refine_completely(1)
    g.stop_refining()
    assert len(g.cell_data_item("lvl")) == n0  # old epoch until the swap
    g.bg_install(wait=True)
    assert len(g.cell_data_item("lvl")) == n0 + 7
    np.testing.assert_array_equal(
        g.cell_data_item("lvl"), g.mapping.get_refinement_level(g.plan.cells))


def test_plan_arena_lock_and_prefault():
    """The arena's pool is guarded for a worker and the step loop; a
    prefaulted fresh take has the same shape and pooling."""
    from dccrg_tpu_torch.hybrid import PlanArena

    a = PlanArena()
    a.begin()
    a.prefault = True
    v = a.take((1000, 3), np.int32)
    assert v.shape == (1000, 3) and a.misses == 1
    a.prefault = False
    plan = type("P", (), {})()
    a.bind(plan)
    a.begin()  # plan not protected: its buffer returns to the pool
    w = a.take((10,), np.int32, fill=0)
    assert a.hits == 1 and np.all(w == 0)
    assert a.stats()["owned_bytes"] == 0


def test_plan_arena_concurrent_takes_never_share_a_buffer():
    """Threads taking and binding at once (a background build against
    the live plan's lazy thunks), with a short switch interval: no
    buffer is handed out twice while owned, and every take is counted."""
    import sys
    import threading

    from dccrg_tpu_torch.hybrid import PlanArena

    a = PlanArena()
    a.begin()
    n_threads, rounds = 8, 200
    live, errors = {}, []
    guard = threading.Lock()

    def worker(k):
        owned = []
        try:
            for i in range(rounds):
                v = a.take((int(7 + (i * k) % 300),), np.int64, owner=owned)
                base = v.base if v.base is not None else v
                with guard:
                    if id(base) in live:
                        errors.append((k, i))
                    live[id(base)] = base
                v[:] = k
                assert np.all(v == k)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker, args=(k,))
              for k in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert errors == []
    assert a.hits + a.misses == n_threads * rounds


def test_prewarm_worker_captures_failure_and_stops():
    seen = []

    def fn(abort):
        seen.append(abort.is_set())
        raise ValueError("boom")

    w = PrewarmWorker(fn).start()
    assert w.wait(5.0)
    assert isinstance(w.error, ValueError) and seen == [False]
    w2 = PrewarmWorker(lambda abort: abort.wait(5.0)).start()
    assert w2.stop(5.0) and w2.error is None


# -- async checkpoint saves ---------------------------------------------

def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _mk_uniform(n_dev=2):
    g = (Grid(cell_data={"rho": torch.float32, "aux": torch.float32})
         .set_initial_length((6, 6, 2))
         .set_periodic(True, True, False)
         .set_load_balancing_method("block")
         .initialize(["cpu"] * n_dev))
    cells = g.plan.cells
    g.set("rho", cells, (cells.astype(np.float64) % 17).astype(np.float32))
    g.set("aux", cells, np.ones(len(cells), dtype=np.float32))
    g.update_copies_of_remote_neighbors()
    return g


def _rho_kernel(c, nbr, offs, mask):
    s = torch.where(mask, nbr["rho"], torch.zeros((), dtype=torch.float32))
    return {"rho": np.float32(0.5) * c["rho"] + np.float32(0.125) * s.sum(dim=1)}


def _rho_step(grid, n=1):
    grid.run_steps(_rho_kernel, ["rho"], ["rho"], n)


@pytest.mark.parametrize("n_dev", [1, 2])
def test_async_save_bitwise_equals_sync_save(tmp_path, n_dev):
    """A frozen snapshot written on the writer thread while steps run
    gives the .dc and sidecar bytes of a synchronous save at the freeze
    point."""
    g = _mk_uniform(n_dev)
    _rho_step(g, 2)
    sync = str(tmp_path / "sync.dc")
    resilience.save_checkpoint(g, sync)
    saver = AsyncSaver()
    path = str(tmp_path / "async.dc")
    snap = freeze_grid(g)
    saver.submit(lambda: resilience.save_checkpoint(snap, path),
                 label=path)
    _rho_step(g, 3)  # the live grid moves on while the writer writes
    saver.drain()
    assert not saver.pending()
    assert _sha(path) == _sha(sync)
    assert _sha(resilience.sidecar_path(path)) == \
        _sha(resilience.sidecar_path(sync))
    assert resilience.verify_checkpoint(path) == []
    assert telemetry.registry().counter_total(
        "dccrg_ckpt_async_saves_total") == 1


def test_async_torn_write_surfaces_at_drain(tmp_path):
    g = _mk_uniform()
    saver = AsyncSaver()
    failed = []
    path = str(tmp_path / "c.dc")
    plan = FaultPlan(seed=5)
    plan.io_error(times=3)  # every attempt of one save
    with plan:
        snap = freeze_grid(g)
        saver.submit(lambda: resilience.save_checkpoint(snap, path,
                                                        backoff=0.0),
                     on_fail=failed.append, label=path)
        with pytest.raises(OSError):
            saver.drain()
    assert len(failed) == 1 and isinstance(failed[0], OSError)
    assert not os.path.exists(path)  # never under its final name
    assert not saver.pending()
    assert telemetry.registry().counter_total(
        "dccrg_ckpt_async_errors_total") == 1
    # the next save goes through
    snap = freeze_grid(g)
    saver.submit(lambda: resilience.save_checkpoint(snap, path))
    saver.drain()
    assert resilience.verify_checkpoint(path) == []


def test_submit_drains_the_previous_write(tmp_path):
    """At most one write in flight: a second submit waits for the first
    and surfaces its failure at that save boundary."""
    saver = AsyncSaver()
    order = []
    saver.submit(lambda: order.append("a"))
    saver.submit(lambda: order.append("b"))
    saver.drain()
    assert order == ["a", "b"]

    def bad():
        raise RuntimeError("first write failed")

    saver.submit(bad)
    with pytest.raises(RuntimeError):
        saver.submit(lambda: order.append("c"))
    assert order == ["a", "b"]


def test_freeze_grid_unaffected_by_later_inplace_set(tmp_path):
    """On the CPU ``tensor.numpy()`` aliases the live tensor and ``set``
    writes in place: the snapshot holds copies, so a later ``set`` and
    halo exchange leave its bytes, and its save, unchanged."""
    g = _mk_uniform()
    want = checkpoint_mod.state_digest(g)
    sync = str(tmp_path / "sync.dc")
    resilience.save_checkpoint(g, sync)
    snap = freeze_grid(g)
    cells = g.plan.cells
    g.set("rho", cells, np.full(len(cells), 7.0, dtype=np.float32))
    g.update_copies_of_remote_neighbors()
    assert checkpoint_mod.state_digest(snap) == want
    frozen = str(tmp_path / "frozen.dc")
    resilience.save_checkpoint(snap, frozen)
    assert _sha(frozen) == _sha(sync)
    for n in snap.data:
        assert snap.data[n].data_ptr() != g.data[n].data_ptr()
