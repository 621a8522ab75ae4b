"""The port's run supervision (``dccrg_tpu_torch/supervise.py``) on the
CPU: the counterparts of ``tests/test_supervise.py``'s cases, the real
``SIGTERM`` and the maintenance CLI included, plus the knobs and the
store's listing held against the reference's.

A preemption signal (faked or real) produces a CRC-verified checkpoint
and a resumable exit, and ``resume_latest`` reconverges bit for bit
with an uninterrupted run of the same seed; an injected step hang
raises ``StepTimeoutError`` within the deadline; retention GC never
deletes the only checkpoint that passes verification. Grids of two
partitions.
"""

import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from dccrg_tpu import supervise as ref_sup

import torch

from dccrg_tpu_torch import Grid, coord, faults, resilience, supervise
from dccrg_tpu_torch.supervise import (
    RESUMABLE_EXIT, CheckpointStore, PreemptedError, StepTimeoutError,
    SupervisedRunner, gc_checkpoints, list_checkpoints, resume_latest,
    retention_plan)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL_DATA = {"v": torch.float32}


def _mk(seed=0):
    g = (Grid(cell_data=CELL_DATA)
         .set_initial_length((8, 8, 4))
         .set_periodic(True, True, False)
         .set_maximum_refinement_level(0)
         .set_neighborhood_length(1)
         .set_load_balancing_method("block")
         .initialize(["cpu"] * 2))
    cells = g.plan.cells
    g.set("v", cells, ((cells.astype(np.float64) * (seed + 7) % 31) / 31)
          .astype(np.float32))
    g.update_copies_of_remote_neighbors()
    return g


def _kernel(c, nbr, offs, mask):
    return {"v": 0.5 * c["v"] + 0.125 * torch.sum(
        torch.where(mask, nbr["v"], torch.zeros_like(nbr["v"])), dim=1)}


def _step_fn(grid, _i):
    grid.run_steps(_kernel, ["v"], ["v"], 1)


def _sup(tmp_path, name, grid=None, step_fn=_step_fn, **kw):
    kw.setdefault("check_every", 100)
    kw.setdefault("checkpoint_every", 3)
    kw.setdefault("backoff", 0.0)
    kw.setdefault("keep_last", 99)
    return SupervisedRunner(grid if grid is not None else _mk(), step_fn,
                            str(tmp_path / name), **kw)


def _state(sup):
    g = sup.grid
    return np.asarray(g.get("v", g.plan.cells)).tobytes()


def _resume(d):
    info = resume_latest(str(d), CELL_DATA, device="cpu")
    return info


# -- preemption -------------------------------------------------------

def test_fake_preempt_emergency_checkpoint_and_resumable_exit(tmp_path):
    sup = _sup(tmp_path, "pre")
    plan = faults.FaultPlan(seed=1)
    plan.preempt_signal(step=4)
    with plan, pytest.raises(PreemptedError) as ei:
        sup.run(10)
    e = ei.value
    assert plan.fired("supervise.preempt") == 1
    assert e.exit_code == RESUMABLE_EXIT == ref_sup.RESUMABLE_EXIT == 75
    assert e.step == 5 and e.clean
    assert sup.preempted and sup.step == 5
    assert e.checkpoint == sup.store.path_for(5)
    assert resilience.verify_checkpoint(e.checkpoint) == []


def test_preempt_resume_reconverges_bitwise(tmp_path):
    ref = _sup(tmp_path, "ref")
    ref.run(12)
    want = _state(ref)
    sup = _sup(tmp_path, "pre")
    plan = faults.FaultPlan(seed=2)
    plan.preempt_signal(step=5)
    with plan, pytest.raises(PreemptedError):
        sup.run(12)
    info = _resume(tmp_path / "pre")
    assert info is not None and not info.salvaged
    assert info.step == 6 and info.report.clean
    info.grid.update_copies_of_remote_neighbors()
    sup2 = _sup(tmp_path, "pre", grid=info.grid, start_step=info.step)
    sup2.run(12)
    assert sup2.step == 12
    assert _state(sup2) == want


def test_real_sigterm_mid_step_preempts_at_boundary(tmp_path):
    def step_fn(grid, i):
        _step_fn(grid, i)
        if i == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    sup = _sup(tmp_path, "sig", step_fn=step_fn)
    with pytest.raises(PreemptedError) as ei:
        sup.run(10)
    assert ei.value.step == 4
    assert resilience.verify_checkpoint(ei.value.checkpoint) == []
    assert not supervise.preempt_requested()


def test_second_sigint_escalates_to_keyboard_interrupt(tmp_path):
    def step_fn(grid, i):
        _step_fn(grid, i)
        if i == 1:
            os.kill(os.getpid(), signal.SIGINT)
            os.kill(os.getpid(), signal.SIGINT)

    sup = _sup(tmp_path, "int", step_fn=step_fn)
    with pytest.raises(KeyboardInterrupt):
        sup.run(10)
    supervise.clear_preempt()


def test_handlers_restored_and_off_main_thread_degrade(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    _sup(tmp_path, "h").run(2)
    assert signal.getsignal(signal.SIGTERM) is before
    import threading

    errs = []

    def worker():
        try:
            with supervise.preemption_handlers():
                supervise.request_preempt()
                assert supervise.preempt_requested()
        except Exception as e:  # noqa: BLE001 - inspected below
            errs.append(e)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert not errs and not supervise.preempt_requested()


def test_preempt_loses_consensus_to_a_real_trip(tmp_path, monkeypatch):
    remote = []

    def fake_consensus(grid, code):
        if code == resilience._TRIP_INTERRUPT and not remote:
            remote.append(code)
            return resilience._TRIP_NUMERICS
        return int(code)

    monkeypatch.setattr(coord, "trip_consensus", fake_consensus)
    sup = _sup(tmp_path, "race")
    plan = faults.FaultPlan(seed=3)
    plan.preempt_signal(step=4)
    with plan, pytest.raises(PreemptedError) as ei:
        sup.run(10)
    assert remote == [resilience._TRIP_INTERRUPT]
    assert sup.rollbacks == 1
    assert ei.value.step == 4
    assert resilience.verify_checkpoint(ei.value.checkpoint) == []


def test_preempt_never_checkpoints_poisoned_state(tmp_path):
    poisoned = []

    def step_fn(grid, i):
        _step_fn(grid, i)
        if i == 4 and not poisoned:
            poisoned.append(i)
            grid.set("v", grid.plan.cells[:1], np.array([np.nan], np.float32))

    sup = _sup(tmp_path, "poison", step_fn=step_fn, fields=("v",),
               checkpoint_every=3)
    plan = faults.FaultPlan(seed=11)
    plan.preempt_signal(step=4)
    with plan, pytest.raises(PreemptedError) as ei:
        sup.run(10)
    assert sup.rollbacks == 1
    assert resilience.verify_checkpoint(ei.value.checkpoint) == []
    info = _resume(tmp_path / "poison")
    assert info.step == ei.value.step
    assert resilience.check_finite(info.grid)


def test_transient_error_after_state_mutation_does_not_double_apply(
        tmp_path):
    ref = _sup(tmp_path, "mref")
    ref.run(6)
    failed = []

    def step_fn(grid, i):
        _step_fn(grid, i)
        if i == 3 and not failed:
            failed.append(i)
            raise faults.InjectedDispatchError("post-mutation")

    sup = _sup(tmp_path, "mut", step_fn=step_fn, dispatch_backoff=0.0)
    sup.run(6)
    assert sup.dispatch_retried == 1 and sup.rollbacks == 0
    assert _state(sup) == _state(ref)


def test_transient_error_after_in_place_write_does_not_double_apply(
        tmp_path):
    """The port's writers may change a tensor in place (``Grid.set``):
    the dispatch snapshot's tensors are frozen for the step, so the
    rewind still restores the pre-step bytes."""
    def inplace_step(grid, i):
        cells = grid.plan.cells
        grid.set("v", cells, np.asarray(grid.get("v", cells)) * 2 + 1)

    ref = _sup(tmp_path, "iref", step_fn=inplace_step)
    ref.run(5)
    failed = []

    def step_fn(grid, i):
        inplace_step(grid, i)
        if i == 2 and not failed:
            failed.append(i)
            raise faults.InjectedDispatchError("after an in-place write")

    sup = _sup(tmp_path, "imut", step_fn=step_fn, dispatch_backoff=0.0)
    sup.run(5)
    assert sup.dispatch_retried == 1
    assert _state(sup) == _state(ref)
    assert sup.grid._txn_frozen is None


def test_emergency_save_shortens_the_barrier_timeout(tmp_path,
                                                     monkeypatch):
    seen = []
    real_save = resilience.save_checkpoint

    def spy_save(grid, path, **kw):
        seen.append(coord.barrier_timeout())
        return real_save(grid, path, **kw)

    monkeypatch.setattr(resilience, "save_checkpoint", spy_save)
    monkeypatch.setenv("DCCRG_BARRIER_TIMEOUT", "120")
    sup = _sup(tmp_path, "grace", grace=8.0)
    plan = faults.FaultPlan(seed=4)
    plan.preempt_signal(step=2)
    with plan, pytest.raises(PreemptedError):
        sup.run(10)
    assert seen[-1] == 2.0
    assert all(t == 120.0 for t in seen[:-1])
    assert coord.barrier_timeout() == 120.0


def test_emergency_save_failure_falls_back_to_periodic(tmp_path,
                                                       monkeypatch):
    real_save = resilience.save_checkpoint

    def flaky_save(grid, path, **kw):
        if "00000005" in path:
            raise OSError("disk gone")
        return real_save(grid, path, **kw)

    monkeypatch.setattr(resilience, "save_checkpoint", flaky_save)
    sup = _sup(tmp_path, "fb")
    plan = faults.FaultPlan(seed=5)
    plan.preempt_signal(step=4)
    with plan, pytest.raises(PreemptedError) as ei:
        sup.run(10)
    assert not ei.value.clean
    assert ei.value.checkpoint == sup.store.path_for(3)
    assert resilience.verify_checkpoint(ei.value.checkpoint) == []


# -- step-hang watchdog + transient dispatch retry --------------------

def test_step_hang_raises_typed_timeout_within_deadline(tmp_path):
    g = _mk()
    _step_fn(g, 0)
    sup = _sup(tmp_path, "hang", grid=g, step_timeout=0.5)
    plan = faults.FaultPlan(seed=6)
    plan.step_hang(step=2)
    t0 = time.monotonic()
    with plan, pytest.raises(StepTimeoutError) as ei:
        sup.run(10)
    assert time.monotonic() - t0 < 10.0
    assert ei.value.step == 2
    assert "step 2" in str(ei.value)
    assert plan.fired("supervise.hang") == 1


def test_slow_but_alive_step_completes_under_deadline(tmp_path):
    sup = _sup(tmp_path, "slow", step_timeout=30.0)
    plan = faults.FaultPlan(seed=7)
    plan.step_hang(step=1, hang_s=0.05)
    with plan:
        sup.run(4)
    assert sup.step == 4 and sup.rollbacks == 0


def test_step_timeout_env_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("DCCRG_STEP_TIMEOUT", "0.4")
    g = _mk()
    _step_fn(g, 0)
    sup = _sup(tmp_path, "env", grid=g)
    assert sup.step_timeout == 0.4
    plan = faults.FaultPlan(seed=8)
    plan.step_hang(step=1)
    with plan, pytest.raises(StepTimeoutError):
        sup.run(4)


def test_no_deadline_adds_no_thread(tmp_path, monkeypatch):
    """Unset, the step path runs on the caller's thread: no deadline
    thread, no synchronization."""
    monkeypatch.delenv("DCCRG_STEP_TIMEOUT", raising=False)
    import threading

    threads = []

    def step_fn(grid, i):
        threads.append(threading.current_thread())
        _step_fn(grid, i)

    monkeypatch.setattr(coord, "run_with_deadline",
                        lambda *a, **k: pytest.fail("deadline thread"))
    _sup(tmp_path, "nothread", step_fn=step_fn).run(3)
    assert threads == [threading.current_thread()] * 3


def test_injected_hang_without_deadline_refuses(tmp_path):
    plan = faults.FaultPlan(seed=8)
    plan.step_hang(step=0)
    with plan, pytest.raises(RuntimeError, match="no step deadline"):
        _sup(tmp_path, "nodl", step_timeout=0).run(2)


def test_transient_dispatch_errors_retry_without_rollback(tmp_path):
    ref = _sup(tmp_path, "dref")
    ref.run(6)
    sup = _sup(tmp_path, "disp", dispatch_backoff=0.0)
    plan = faults.FaultPlan(seed=9)
    plan.dispatch_error(times=2, step=3)
    with plan:
        sup.run(6)
    assert plan.fired("supervise.dispatch") == 2
    assert sup.dispatch_retried == 2
    assert sup.rollbacks == 0 and not sup.trips
    assert _state(sup) == _state(ref)


def test_persistent_dispatch_errors_exhaust_and_surface(tmp_path):
    sup = _sup(tmp_path, "dead", dispatch_retries=2, dispatch_backoff=0.0)
    plan = faults.FaultPlan(seed=10)
    plan.dispatch_error(times=faults.EVERY)
    with plan, pytest.raises(faults.InjectedDispatchError):
        sup.run(6)
    assert sup.dispatch_retried == 2


@pytest.mark.parametrize("err,want", [
    (faults.InjectedDispatchError("x"), True),
    (RuntimeError("UNAVAILABLE: link flap"), True),
    (RuntimeError("DEADLINE_EXCEEDED"), True),
    (RuntimeError("RESOURCE_EXHAUSTED: UNAVAILABLE"), False),
    (faults.SimulatedResourceExhausted("x"), False),
    (torch.OutOfMemoryError("CUDA out of memory. UNAVAILABLE"), False),
    (resilience.NumericsError("UNAVAILABLE"), False),
    (ValueError("boom"), False),
])
def test_transient_classification(err, want):
    assert supervise._is_transient_dispatch(err) is want


# -- checkpoint store, resume ordering, retention GC ------------------

def test_store_paths_and_listing(tmp_path):
    store = CheckpointStore(tmp_path / "s", stem="run")
    ref = ref_sup.CheckpointStore(tmp_path / "s", stem="run")
    assert store.path_for(7).endswith("run_00000007.dc")
    assert store.path_for(7, delta=True) == ref.path_for(7, delta=True)
    for s in (3, 11, 7):
        with open(store.path_for(s), "wb") as f:
            f.write(b"x")
    assert [s for s, _ in store.list()] == [11, 7, 3]
    with open(os.path.join(store.dir, "other_00000099.dc"), "wb") as f:
        f.write(b"x")
    assert [s for s, _ in store.list()] == [11, 7, 3]
    assert list_checkpoints(store.dir) == ref_sup.list_checkpoints(store.dir)
    assert [s for s, _ in list_checkpoints(store.dir)] == [99, 11, 7, 3]


@pytest.mark.parametrize("steps,keep_last,keep_every", [
    (range(1, 11), 2, 4), ([5], 0, 0), ([], 3, 0), ([3, 9, 12, 4], 1, 3)])
def test_retention_plan_policy(steps, keep_last, keep_every):
    got = retention_plan(steps, keep_last=keep_last, keep_every=keep_every)
    assert got == ref_sup.retention_plan(steps, keep_last, keep_every)
    if list(steps) == list(range(1, 11)):
        assert got == ([10, 9, 8, 4], [7, 6, 5, 3, 2, 1])


def _plant_store(tmp_path, steps, seed=0):
    store = CheckpointStore(tmp_path / f"plant{seed}")
    g = _mk(seed)
    proto = os.path.join(store.dir, "proto.bin")
    resilience.save_checkpoint(g, proto)
    for s in steps:
        shutil.copy(proto, store.path_for(s))
        shutil.copy(resilience.sidecar_path(proto),
                    resilience.sidecar_path(store.path_for(s)))
    os.unlink(proto)
    os.unlink(resilience.sidecar_path(proto))
    return store


def _corrupt_payload(path):
    rec = resilience.read_sidecar(path)
    faults.flip_bit(path, int(rec["payload_start"]) + 5, 1)


def test_resume_ordering_prefers_newest_verified(tmp_path):
    store = _plant_store(tmp_path, (2, 4, 6, 8))
    _corrupt_payload(store.path_for(8))
    os.unlink(resilience.sidecar_path(store.path_for(6)))
    info = resume_latest(store.dir, CELL_DATA, stem=store.stem,
                         device="cpu")
    assert info is not None and not info.salvaged
    assert info.step == 4
    g0 = _mk(0)
    np.testing.assert_array_equal(
        np.asarray(info.grid.get("v", g0.plan.cells)),
        np.asarray(g0.get("v", g0.plan.cells)))


def test_resume_salvages_newest_when_nothing_verifies(tmp_path):
    store = _plant_store(tmp_path, (2, 4))
    _corrupt_payload(store.path_for(2))
    _corrupt_payload(store.path_for(4))
    info = resume_latest(store.dir, CELL_DATA, stem=store.stem,
                         device="cpu")
    assert info is not None and info.salvaged
    assert info.step == 4
    assert len(info.report.corrupt_cells)
    assert resume_latest(store.dir, CELL_DATA, stem=store.stem,
                         salvage=False, device="cpu") is None
    assert resume_latest(str(tmp_path / "empty"), CELL_DATA,
                         device="cpu") is None


def test_gc_applies_policy_and_removes_sidecars(tmp_path):
    store = _plant_store(tmp_path, (1, 2, 3, 4, 5, 6))
    rep = store.gc(keep_last=2, keep_every=3, apply=False)
    assert [s for s, _ in rep.kept] == [6, 5, 3]
    assert os.path.exists(store.path_for(1))
    rep = store.gc(keep_last=2, keep_every=3, apply=True)
    assert rep.applied
    assert [s for s, _ in store.list()] == [6, 5, 3]
    for s, path in rep.dropped:
        assert not os.path.exists(path)
        assert not os.path.exists(resilience.sidecar_path(path))


def test_gc_never_deletes_the_only_verified_checkpoint(tmp_path):
    store = _plant_store(tmp_path, (1, 2, 3, 4, 5))
    for s in (4, 5):
        _corrupt_payload(store.path_for(s))
    rep = store.gc(keep_last=2, apply=True)
    assert rep.rescued == 3
    assert [s for s, _ in store.list()] == [5, 4, 3]
    assert resilience.verify_checkpoint(store.path_for(3)) == []


def test_gc_refuses_when_nothing_verifies(tmp_path):
    store = _plant_store(tmp_path, (1, 2, 3))
    for s in (1, 2, 3):
        _corrupt_payload(store.path_for(s))
    rep = store.gc(keep_last=1, apply=True)
    assert rep.refused and not rep.dropped
    assert [s for s, _ in store.list()] == [3, 2, 1]


@pytest.mark.parametrize("trial", range(8))
def test_gc_verification_property_under_fuzzed_directories(tmp_path,
                                                           trial):
    rng = np.random.default_rng(42 + trial)
    steps = sorted(rng.choice(np.arange(1, 30), replace=False,
                              size=int(rng.integers(1, 8))).tolist())
    store = _plant_store(tmp_path / f"t{trial}", steps, seed=trial)
    corrupt = [s for s in steps if rng.random() < 0.5]
    for s in corrupt:
        _corrupt_payload(store.path_for(s))
    any_ok_before = len(corrupt) < len(steps)
    store.gc(keep_last=int(rng.integers(1, 4)),
             keep_every=int(rng.integers(0, 6)), apply=True)
    left_ok = [s for s, p in store.list()
               if not resilience.verify_checkpoint(p)]
    if any_ok_before:
        assert left_ok, (steps, corrupt)
    else:
        assert [s for s, _ in store.list()] == sorted(steps, reverse=True)


def test_preempt_flag_consumed_without_signal_handlers(tmp_path):
    sup = _sup(tmp_path, "nohandler", install_signal_handlers=False)
    supervise.request_preempt()
    with pytest.raises(PreemptedError) as ei:
        sup.run(10)
    assert ei.value.step == 1
    assert not supervise.preempt_requested()
    info = _resume(tmp_path / "nohandler")
    info.grid.update_copies_of_remote_neighbors()
    sup2 = _sup(tmp_path, "nohandler", grid=info.grid,
                start_step=info.step, install_signal_handlers=False)
    sup2.run(10)
    assert sup2.step == 10 and not sup2.preempted


def test_gc_treats_each_stem_as_its_own_sequence(tmp_path):
    a = _plant_store(tmp_path, (1, 2, 3))
    b = CheckpointStore(a.dir, stem="other")
    g = _mk(1)
    for s in (2, 3, 4):
        resilience.save_checkpoint(g, b.path_for(s))
    for s in (3, 4):
        _corrupt_payload(b.path_for(s))
    rep = gc_checkpoints(a.dir, keep_last=2, apply=True)
    assert [s for s, _ in a.list()] == [3, 2]
    assert [s for s, _ in b.list()] == [4, 3, 2]
    assert rep.rescued == 2
    assert resilience.verify_checkpoint(b.path_for(2)) == []


def test_gc_sweeps_stale_temp_files(tmp_path):
    store = _plant_store(tmp_path, (1, 2))
    mp_tmp = store.path_for(1) + ".mp-tmp"
    dead = os.path.join(store.dir, "x.dc.tmp.999999999")
    alive = os.path.join(store.dir, f"y.dc.salvage.{os.getpid()}")
    for p in (mp_tmp, dead, alive):
        with open(p, "wb") as f:
            f.write(b"t")
    rep = store.gc(keep_last=5, apply=True)
    assert sorted(rep.stale_temps) == sorted([mp_tmp, dead])
    assert not os.path.exists(mp_tmp) and not os.path.exists(dead)
    assert os.path.exists(alive)


def test_runner_prunes_as_it_goes(tmp_path):
    sup = _sup(tmp_path, "gc", keep_last=2, checkpoint_every=2)
    sup.run(10)
    assert [s for s, _ in sup.store.list()] == [10, 8]


def test_store_run_lists_like_the_reference(tmp_path):
    """The same supervised schedule (cadence 3, keep-last 2, keyframe
    every 4, a preemption after step 7) leaves the same files as the
    reference's runner."""
    import jax.numpy as jnp
    from dccrg_tpu import faults as ref_faults
    from dccrg_tpu.grid import Grid as RefGrid
    from test_torch_delta_checkpoint import _ref_mesh

    def names(d):
        return sorted(os.listdir(d))

    sup = _sup(tmp_path, "p", keep_last=2)
    sup.store.keyframe_every = 4
    plan = faults.FaultPlan(seed=1)
    plan.preempt_signal(step=7)
    with plan, pytest.raises(PreemptedError):
        sup.run(12)

    rg = (RefGrid(cell_data={"v": jnp.float32})
          .set_initial_length((8, 8, 4)).set_periodic(True, True, False)
          .set_maximum_refinement_level(0).set_neighborhood_length(1)
          .set_load_balancing_method("block").initialize(_ref_mesh()))
    cells = rg.plan.cells
    rg.set("v", cells, ((cells.astype(np.float64) * 7 % 31) / 31)
           .astype(np.float32))

    def ref_step(grid, _i):
        grid.run_steps(lambda c, n, o, m: {
            "v": jnp.float32(0.5) * c["v"] + jnp.float32(0.125)
            * jnp.sum(jnp.where(m, n["v"], jnp.float32(0)), axis=1)},
            ["v"], ["v"], 1)

    rsup = ref_sup.SupervisedRunner(rg, ref_step, str(tmp_path / "r"),
                                    check_every=100, checkpoint_every=3,
                                    backoff=0.0, keep_last=2)
    rsup.store.keyframe_every = 4
    rplan = ref_faults.FaultPlan(seed=1)
    rplan.preempt_signal(step=7)
    with rplan, pytest.raises(ref_sup.PreemptedError):
        rsup.run(12)
    assert names(tmp_path / "p") == names(tmp_path / "r")
    # the states agree to float32 rounding (26-slot sums in another
    # order): rtol 1e-6
    np.testing.assert_allclose(np.asarray(sup.grid.get("v", cells)),
                               np.asarray(rg.get("v", cells)), rtol=1e-6)


def test_knobs_equal_reference(monkeypatch):
    for var, fn in (("DCCRG_STEP_TIMEOUT", "step_timeout_default"),
                    ("DCCRG_CKPT_SECONDS", "ckpt_seconds_default"),
                    ("DCCRG_PREEMPT_GRACE", "preempt_grace"),
                    ("DCCRG_KEEP_LAST", "keep_last_default"),
                    ("DCCRG_DELTA", "delta_enabled")):
        for val in ("", "0", "2.5", "7", "junk"):
            monkeypatch.setenv(var, val)
            try:
                want = getattr(ref_sup, fn)()
            except ValueError:
                continue
            assert getattr(supervise, fn)() == want, (var, val)


# -- the maintenance CLI ----------------------------------------------

def test_cli_verify_and_gc(tmp_path, capsys):
    store = _plant_store(tmp_path, (1, 2, 3))
    good = store.path_for(3)
    assert resilience._main(["verify", good]) == 0
    assert "OK" in capsys.readouterr().out
    _corrupt_payload(store.path_for(2))
    assert resilience._main(["verify", store.path_for(2)]) == 1
    assert "CORRUPT" in capsys.readouterr().out
    assert resilience._main(["gc", store.dir, "--keep-last", "1"]) == 0
    out = capsys.readouterr().out
    assert "dry-run" in out and "--apply" in out
    assert [s for s, _ in store.list()] == [3, 2, 1]
    assert resilience._main(["gc", store.dir, "--keep-last", "1",
                             "--apply"]) == 0
    assert "applied" in capsys.readouterr().out
    assert [s for s, _ in store.list()] == [3]


def test_cli_audit_and_module_entry(tmp_path):
    """``python -m dccrg_tpu_torch.resilience`` as a shell would run it:
    the audit subcommand and the CPU probe."""
    store = _plant_store(tmp_path, (1,))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "dccrg_tpu_torch.resilience", "audit",
         store.path_for(1)], capture_output=True, text=True, env=env,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout and "field v" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "dccrg_tpu_torch.resilience", "--platform",
         "cpu", "--timeout", "60"], capture_output=True, text=True, env=env,
        timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("OK"), out


# -- wall-clock checkpoint cadence (DCCRG_CKPT_SECONDS) ---------------

def test_wall_clock_cadence_checkpoints_between_step_marks(tmp_path):
    def slow_step(grid, i):
        _step_fn(grid, i)
        time.sleep(0.03)

    sup = _sup(tmp_path, "wc", step_fn=slow_step,
               checkpoint_every=10**9, checkpoint_seconds=0.02)
    sup.run(4)
    assert sorted(s for s, _ in sup.store.list()) == [0, 1, 2, 3, 4]


def test_wall_clock_cadence_off_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv("DCCRG_CKPT_SECONDS", raising=False)
    sup = _sup(tmp_path, "off", checkpoint_every=3)
    assert sup.runner.checkpoint_seconds == 0.0
    sup.run(6)
    assert sorted(s for s, _ in sup.store.list()) == [0, 3, 6]


def test_wall_clock_cadence_env_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("DCCRG_CKPT_SECONDS", "7.5")
    sup = _sup(tmp_path, "env")
    assert sup.runner.checkpoint_seconds == 7.5
    sup2 = _sup(tmp_path, "env2", checkpoint_seconds=1.25)
    assert sup2.runner.checkpoint_seconds == 1.25


def test_wall_clock_cadence_never_saves_mid_step(tmp_path):
    calls = []

    def one_slow_step(grid, i):
        calls.append(i)
        time.sleep(0.05)

    sup = _sup(tmp_path, "mid", step_fn=one_slow_step,
               checkpoint_every=10**9, checkpoint_seconds=0.01)
    sup.run(1)
    assert calls == [0]
    assert sorted(s for s, _ in sup.store.list()) == [0, 1]


# -- per-step latency histogram ---------------------------------------

def test_latency_histogram_counts_every_step(tmp_path):
    sup = _sup(tmp_path, "lat")
    sup.run(5)
    buckets = sup.latency_histogram()
    assert sum(c for _lo, _hi, c in buckets) == 5
    los = [lo for lo, _hi, _c in buckets]
    his = [hi for _lo, hi, _c in buckets]
    assert all(a < b for a, b in zip(his, his[1:]))
    assert los[0] == 0.0 and los[1:] == his[:-1]


def test_latency_histogram_places_slow_step_right(tmp_path):
    def slow_step(grid, i):
        time.sleep(0.06)

    sup = _sup(tmp_path, "lat2", step_fn=slow_step)
    sup.run(2)
    mass = [(lo, hi, c) for lo, hi, c in sup.latency_histogram() if c]
    assert sum(c for _l, _h, c in mass) == 2
    for lo, hi, _c in mass:
        assert hi > 0.06 * 0.5
    assert sup._latency.quantile(0.5) >= 0.06
    assert sup._latency.max_seconds >= 0.06


def test_latency_summary_logged_on_step_timeout(tmp_path, caplog):
    import logging

    g = _mk()
    _step_fn(g, 0)
    plan = faults.FaultPlan(seed=4)
    plan.step_hang(step=2)
    sup = _sup(tmp_path, "wedge", grid=g, step_timeout=0.5)
    with caplog.at_level(logging.WARNING, logger="dccrg_tpu_torch.supervise"):
        with plan, pytest.raises(StepTimeoutError) as ei:
            sup.run(5)
    assert ei.value.step == 2
    assert any("latency so far" in r.message for r in caplog.records)
    assert sum(c for _l, _h, c in sup.latency_histogram()) == 3
