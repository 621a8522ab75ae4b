"""The port's auto-rollback runner, OOM fallback chain and device probes
(``dccrg_tpu_torch/resilience.py``) on the CPU, against the reference
where the reference answers the same question.

The counterparts of ``tests/test_resilience.py``'s runner,
fallback-chain and ``safe_devices`` cases that
``tests/test_torch_resilience.py`` does not hold, of the zoo's runner
cases (``tests/test_models.py``: ``GridMHD`` and ``GridVlasov`` rolled
back bit for bit) and of the async-save cases that drive
``CheckpointStore``, ``ResilientRunner`` and ``SupervisedRunner``
(``tests/test_bgrecommit.py``). A real ``torch.OutOfMemoryError`` walks
the chain like the injected one, and the failed modes' tensors are
freed before the next mode runs.
"""

import glob
import hashlib
import json
import os
import weakref

import numpy as np
import pytest

import jax.numpy as jnp

from dccrg_tpu import faults as ref_faults
from dccrg_tpu import resilience as ref_res
from dccrg_tpu.models.advection import GridAdvection as RefAdvection
from torch_amr_fixture import mesh1

import torch

from dccrg_tpu_torch import Grid, faults, resilience, telemetry
from dccrg_tpu_torch import checkpoint as checkpoint_mod
from dccrg_tpu_torch.grid import SlotwiseKernel
from dccrg_tpu_torch.models import GridMHD, GridVlasov
from dccrg_tpu_torch.models.advection import GridAdvection
from dccrg_tpu_torch.models.mhd import MHD_ALL
from dccrg_tpu_torch.resilience import (ResilienceExhaustedError,
                                        ResilientRunner)
from dccrg_tpu_torch.supervise import (CheckpointStore, PreemptedError,
                                       SupervisedRunner, resume_latest)

_INIT = {}


def _advection(n=8, nz=4):
    """Small advection model + a one-step step_fn for the runner; every
    build starts from the first build's density bytes."""
    s = GridAdvection(n=n, nz=nz, device="cpu")
    key = (n, nz)
    if key not in _INIT:
        _INIT[key] = s.grid.data["density"].clone()
    s.grid.data["density"] = _INIT[key].clone()
    dt = 0.5 * s.max_time_step()
    ex = (torch.tensor(dt, dtype=torch.float32),)

    def step_fn(grid, _i):
        grid.run_steps(s._kernel, ["density", "vx", "vy"], ["density"], 1,
                       extra_args=ex)

    return s, step_fn, ex


def _density(s):
    return np.asarray(s.grid.get("density", s.grid.plan.cells))


def _run(tmp_path, name, n_steps=12, plan=None, **kw):
    s, step_fn, _ = _advection()
    runner = ResilientRunner(
        s.grid, step_fn, str(tmp_path / f"{name}.dc"),
        fields=("density",), check_every=1, checkpoint_every=5,
        backoff=0.0, diagnostics_dir=str(tmp_path), **kw)
    if plan is not None:
        with plan:
            runner.run(n_steps)
    else:
        runner.run(n_steps)
    return runner, _density(s)


# -- auto-rollback ----------------------------------------------------

def test_nan_rollback_reconverges_bitwise(tmp_path):
    _, ref = _run(tmp_path, "ref")
    plan = faults.FaultPlan(seed=3)
    plan.nan_poison("density", step=8)
    runner, got = _run(tmp_path, "inj", plan=plan)
    assert plan.fired("step.poison") == 1
    assert runner.rollbacks == 1 and len(runner.trips) == 1
    assert runner.trips[0]["step"] == 8
    assert runner.trips[0]["rollback_to"] == 5
    assert got.tobytes() == ref.tobytes()


def test_poison_trip_matches_reference_runner(tmp_path):
    """The same plan trips the reference's runner at the same step, to
    the same rollback target, naming the same cell."""
    plan = faults.FaultPlan(seed=3)
    plan.nan_poison("density", step=8)
    runner, _ = _run(tmp_path, "p", plan=plan)

    s = RefAdvection(n=8, nz=4, mesh=mesh1())
    dt = jnp.float32(0.5 * s.max_time_step())
    rplan = ref_faults.FaultPlan(seed=3)
    rplan.nan_poison("density", step=8)
    r = ref_res.ResilientRunner(
        s.grid, lambda g, i: g.run_steps(
            s._kernel, ["density", "vx", "vy"], ["density"], 1,
            extra_args=(dt,)),
        str(tmp_path / "r.dc"), fields=("density",), check_every=1,
        checkpoint_every=5, backoff=0.0, diagnostics_dir=str(tmp_path))
    with rplan:
        r.run(12)
    for key in ("step", "rollback_to", "retry", "fields"):
        assert runner.trips[0][key] == r.trips[0][key], key
    assert (runner.rollbacks, runner.checkpoints, runner.step) == \
        (r.rollbacks, r.checkpoints, r.step)


def test_checkpoint_step_checks_before_saving(tmp_path):
    s, step_fn, _ = _advection()
    ResilientRunner(s.grid, step_fn, str(tmp_path / "r.dc"),
                    fields=("density",), check_every=3, checkpoint_every=10,
                    backoff=0.0, diagnostics_dir=str(tmp_path)).run(12)
    s2, step_fn2, _ = _advection()
    plan = faults.FaultPlan(seed=9)
    plan.nan_poison("density", step=10)
    runner = ResilientRunner(
        s2.grid, step_fn2, str(tmp_path / "i.dc"), fields=("density",),
        check_every=3, checkpoint_every=10, backoff=0.0,
        diagnostics_dir=str(tmp_path))
    with plan:
        runner.run(12)
    assert runner.rollbacks == 1
    assert _density(s2).tobytes() == _density(s).tobytes()


def test_trip_dumps_diagnostic_bundle(tmp_path):
    plan = faults.FaultPlan(seed=1)
    plan.nan_poison("density", step=3)
    _run(tmp_path, "diag", n_steps=6, plan=plan)
    paths = glob.glob(str(tmp_path / "dccrg_diag_step3_*.json"))
    assert len(paths) == 1
    bundle = json.load(open(paths[0]))
    assert bundle["step"] == 3 and bundle["rollback_to"] == 0
    assert bundle["fields"]["density"]


def test_persistent_nan_exhausts_retries(tmp_path):
    plan = faults.FaultPlan(seed=2)
    plan.nan_poison("density", step=3, times=8)
    with pytest.raises(ResilienceExhaustedError, match="step 3"):
        _run(tmp_path, "persist", n_steps=6, plan=plan, max_retries=2)
    assert plan.fired("step.poison") == 3


def test_rollback_refuses_corrupt_checkpoint(tmp_path):
    s, step_fn, _ = _advection()
    ck = str(tmp_path / "cc.dc")
    runner = ResilientRunner(s.grid, step_fn, ck, fields=("density",),
                             check_every=1, checkpoint_every=100,
                             backoff=0.0, diagnostics_dir=str(tmp_path))
    runner.run(2)
    faults.flip_bit(ck, os.path.getsize(ck) - 5, 1)
    s.grid.set("density", s.grid.get_cells()[:1],
               np.array([np.nan], np.float32))
    with pytest.raises(resilience.CheckpointCorruptionError):
        runner.run(4)


def test_runner_survives_failed_adapt(tmp_path):
    s, base_step, _ = _advection()
    adapted = []

    def step_fn(grid, i):
        base_step(grid, i)
        if i == 3 and not adapted:
            grid.refine_completely(int(grid.get_cells()[0]))
            grid.stop_refining()
            grid.assign_children_from_parents()
            adapted.append(i)

    runner = ResilientRunner(s.grid, step_fn, str(tmp_path / "adapt.ckpt"),
                             check_every=1, checkpoint_every=2, backoff=0.0)
    plan = faults.FaultPlan(seed=9)
    plan.mutation_error(site="adapt.commit", times=1, phase="resolved")
    with plan:
        runner.run(6)
    assert plan.fired("adapt.commit") == 1
    assert runner.rollbacks == 1 and runner.step == 6 and adapted
    assert "mutation" in runner.trips[0]["fields"]
    from dccrg_tpu_torch import verify

    verify.verify_all(s.grid, check_pins=False)


def test_runner_survives_watchdog_hook_numerics_error(tmp_path, monkeypatch):
    s, base_step, _ = _advection()
    monkeypatch.setenv("DCCRG_WATCHDOG", "1")
    poisoned = []

    def step_fn(grid, i):
        if i == 2 and not poisoned:
            poisoned.append(i)
            grid.set("density", grid.get_cells()[:1],
                     np.array([np.nan], np.float32))
        base_step(grid, i)

    runner = ResilientRunner(s.grid, step_fn, str(tmp_path / "wd.ckpt"),
                             check_every=100, checkpoint_every=100,
                             backoff=0.0)
    runner.run(5)
    assert runner.rollbacks == 1 and runner.step == 5
    assert "density" in runner.trips[0]["fields"]
    assert resilience.check_finite(s.grid)


@pytest.mark.parametrize("kind", ["injected", "torch"])
def test_runner_recovers_from_transient_oom_trip(tmp_path, kind):
    _, ref = _run(tmp_path, "oomref")
    s, base_step, _ = _advection()
    fired = []

    def step_fn(grid, i):
        if i == 4 and not fired:
            fired.append(i)
            if kind == "torch":
                raise torch.OutOfMemoryError("CUDA out of memory (test)")
            raise faults.SimulatedResourceExhausted("transient, step 4")
        base_step(grid, i)

    runner = ResilientRunner(
        s.grid, step_fn, str(tmp_path / "oom.dc"), fields=("density",),
        check_every=1, checkpoint_every=5, backoff=0.0,
        diagnostics_dir=str(tmp_path))
    runner.run(12)
    assert runner.rollbacks == 1
    assert runner.trips[0]["fields"].get("resource_exhausted") == []
    assert _density(s).tobytes() == ref.tobytes()


def test_runner_persistent_oom_exhausts_retries(tmp_path):
    s, _, _ = _advection()

    def step_fn(grid, i):
        raise faults.SimulatedResourceExhausted("every time")

    runner = ResilientRunner(
        s.grid, step_fn, str(tmp_path / "oomx.dc"), fields=("density",),
        check_every=1, checkpoint_every=5, backoff=0.0, max_retries=2,
        diagnostics_dir=str(tmp_path))
    with pytest.raises(ResilienceExhaustedError):
        runner.run(3)


def test_conserved_drift_trips_a_corrupt_rollback(tmp_path):
    """A finite silent flip of a conserved field is a corrupt trip
    (the finite check cannot see it), rolled back bit for bit."""
    def run(plan, name):
        s, step_fn, _ = _advection()
        r = ResilientRunner(s.grid, step_fn, str(tmp_path / f"{name}.dc"),
                            fields=("density",), check_every=1,
                            checkpoint_every=4, backoff=0.0,
                            conserved_fields=("density",),
                            diagnostics_dir=str(tmp_path))
        if plan is None:
            r.run(8)
        else:
            with plan:
                r.run(8)
        return r, _density(s)

    _, ref = run(None, "c0")
    plan = faults.FaultPlan(seed=4)
    plan.silent_flip("density", step=6, bit=30)
    r, got = run(plan, "c1")
    assert r.rollbacks == 1
    assert got.tobytes() == ref.tobytes()


# -- OOM fallback chain -----------------------------------------------

def _guarded(s, ex, n_steps=3):
    return resilience.guarded_step(
        s.grid, s._kernel, ["density", "vx", "vy"], ["density"],
        n_steps=n_steps, extra_args=ex)


def test_resource_exhausted_falls_back_and_matches(tmp_path):
    s_ref, step_fn, ex = _advection()
    s_ref.grid.run_steps(s_ref._kernel, ["density", "vx", "vy"],
                         ["density"], 3, extra_args=ex)
    s, _, ex = _advection()
    plan = faults.FaultPlan()
    plan.resource_exhausted(times=1, mode="current")
    with plan:
        mode = _guarded(s, ex)
    assert mode == "roll" and s.grid.last_step_path == "roll"
    assert plan.fired("step.dispatch") == 1
    assert _density(s).tobytes() == _density(s_ref).tobytes()
    assert s.grid._sticky_gather_mode == "roll"
    assert _guarded(s, ex, 1) == "roll"


def test_forced_env_mode_is_not_retried(monkeypatch):
    """Under DCCRG_FORCE_TABLES=1 the grid's plan is already the table
    plan ``current`` ran on, so the chain skips the identical ``tables``
    retry; the failed call leaves that plan in place."""
    monkeypatch.setenv("DCCRG_FORCE_TABLES", "1")
    s, _, ex = _advection()
    assert s.grid._plan_gather_mode == "tables"
    plan = faults.FaultPlan()
    plan.resource_exhausted(times=faults.EVERY)
    with plan, pytest.raises(ResilienceExhaustedError):
        _guarded(s, ex, 1)
    assert [l[2].get("mode") for l in plan.log] == ["current", "roll"]
    assert s.grid._plan_gather_mode == "tables"
    assert os.environ.get("DCCRG_FORCE_TABLES") == "1"


@pytest.mark.parametrize("knob", ["DCCRG_ROLL_STENCIL", "DCCRG_BULK"])
def test_reference_only_knobs_skip_nothing(monkeypatch, knob):
    """The port reads neither of the reference's program pins, so they
    neither skip ``roll`` nor send the dispatch to a table rebuild; the
    roll step runs on the plan the grid has."""
    monkeypatch.delenv("DCCRG_FORCE_TABLES", raising=False)
    monkeypatch.setenv(knob, "1")
    s, _, ex = _advection()
    plan_before = s.grid.plan
    plan = faults.FaultPlan()
    plan.resource_exhausted(times=1, mode="current")
    with plan:
        mode = _guarded(s, ex, 1)
    assert mode == "roll" and s.grid.last_step_path == "roll"
    assert s.grid.plan is plan_before
    assert os.environ.get(knob) == "1"


def test_fallback_reaches_tables_and_matches():
    s_ref, _, ex = _advection()
    s_ref.grid.run_steps(s_ref._kernel, ["density", "vx", "vy"],
                         ["density"], 3, extra_args=ex)
    s, _, ex = _advection()
    plan = faults.FaultPlan()
    plan.resource_exhausted(times=1, mode="current")
    plan.resource_exhausted(times=1, mode="roll")
    with plan:
        mode = s.grid.run_steps_guarded(
            s._kernel, ["density", "vx", "vy"], ["density"], 3,
            extra_args=ex)
    assert mode == "tables" and s.grid.last_step_path == "table"
    assert s.grid._plan_gather_mode == "tables"
    assert _density(s).tobytes() == _density(s_ref).tobytes()
    # the downgrade keeps the table plan for plain steps too
    s.grid.run_steps(s._kernel, ["density", "vx", "vy"], ["density"], 1,
                     extra_args=ex)
    assert s.grid.last_step_path == "table"


def test_fallback_chain_exhausted():
    s, _, ex = _advection()
    plan = faults.FaultPlan()
    plan.resource_exhausted(times=faults.EVERY)
    with plan, pytest.raises(ResilienceExhaustedError):
        _guarded(s, ex, 1)


def test_gather_mode_env_restored():
    s, _, ex = _advection()
    os.environ.pop("DCCRG_FORCE_TABLES", None)
    names = ("DCCRG_FORCE_TABLES", "DCCRG_ROLL_STENCIL", "DCCRG_BULK")
    before = {v: os.environ.get(v) for v in names}
    plan = faults.FaultPlan()
    plan.resource_exhausted(times=1, mode="current")
    plan.resource_exhausted(times=1, mode="roll")
    with plan:
        s.grid.run_steps_guarded(s._kernel, ["density", "vx", "vy"],
                                 ["density"], 1, extra_args=ex)
    assert {v: os.environ.get(v) for v in names} == before


def test_unrelated_errors_are_not_swallowed():
    s, _, ex = _advection()
    with pytest.raises(KeyError):
        resilience.guarded_step(s.grid, s._kernel, ["density", "nope"],
                                ["density"], n_steps=1, extra_args=ex)


_PLANS = {
    "none": [],
    "current": [dict(mode="current")],
    "current+roll": [dict(mode="current"), dict(mode="roll")],
}


@pytest.mark.parametrize("which", sorted(_PLANS))
@pytest.mark.parametrize("roll_env", [None, "1"])
def test_guarded_modes_equal_reference(monkeypatch, which, roll_env):
    """The same injected OOMs make both packages finish in the same
    mode, the reference run without the knob the port does not read."""
    monkeypatch.delenv("DCCRG_FORCE_TABLES", raising=False)
    if roll_env is None:
        monkeypatch.delenv("DCCRG_ROLL_STENCIL", raising=False)
    else:
        monkeypatch.setenv("DCCRG_ROLL_STENCIL", roll_env)
    s, _, ex = _advection()
    plan = faults.FaultPlan()
    for kw in _PLANS[which]:
        plan.resource_exhausted(times=1, **kw)
    with plan:
        got = _guarded(s, ex, 1)

    r = RefAdvection(n=8, nz=4, mesh=mesh1())
    rplan = ref_faults.FaultPlan()
    for kw in _PLANS[which]:
        rplan.resource_exhausted(times=1, **kw)
    assert os.environ.get("DCCRG_ROLL_STENCIL") == roll_env
    # the port reads no DCCRG_ROLL_STENCIL (its "roll" is bulk=False,
    # not a program pin), so under it the port finishes where the
    # reference does without it
    monkeypatch.delenv("DCCRG_ROLL_STENCIL", raising=False)
    with rplan:
        want = ref_res.guarded_step(
            r.grid, r._kernel, ["density", "vx", "vy"], ["density"],
            n_steps=1,
            extra_args=(jnp.float32(0.5 * r.max_time_step()),))
    assert got == want


def test_real_torch_oom_walks_the_chain_and_frees_tensors():
    """A ``torch.OutOfMemoryError`` in every mode: ResilienceExhaustedError
    chained to it, the failed tensors freed (the exceptions keep no
    traceback), the env restored."""
    s, _, ex = _advection()
    refs = []

    def init(cell, *extra):
        t = torch.ones(1 << 16)
        refs.append(weakref.ref(t))
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                     "allocate 2 x the card")

    def slot(acc, cell, nbr, offs, mask, *extra):
        return acc

    def finish(acc, cell, *extra):
        return {"density": cell["density"]}

    oom = SlotwiseKernel(init, slot, finish)
    with pytest.raises(ResilienceExhaustedError) as ei:
        resilience.guarded_step(s.grid, oom, ["density", "vx", "vy"],
                                ["density"], n_steps=1, extra_args=ex)
    assert isinstance(ei.value.__cause__, torch.OutOfMemoryError)
    assert ei.value.__cause__.__traceback__ is None
    assert len(refs) == 3 and all(r() is None for r in refs)
    assert "current" in str(ei.value) and "tables" in str(ei.value)
    assert os.environ.get("DCCRG_FORCE_TABLES") is None
    # the grid is back on the closed-form plan it came in with: a plain
    # run_steps takes the bulk path again
    assert s.grid._plan_gather_mode is None
    s.grid.run_steps(s._kernel, ["density", "vx", "vy"], ["density"], 1,
                     extra_args=ex)
    assert s.grid.last_step_path == "bulk"


@pytest.mark.parametrize("err,want", [
    (torch.OutOfMemoryError("CUDA out of memory"), True),
    (faults.SimulatedResourceExhausted("x"), True),
    (RuntimeError("RESOURCE_EXHAUSTED: out of HBM"), True),
    (RuntimeError("UNAVAILABLE"), False),
    (MemoryError("host"), False),
])
def test_resource_exhausted_classification(err, want):
    assert resilience._is_resource_exhausted(err) is want


# -- device probing ---------------------------------------------------

def test_safe_devices_cpu():
    assert resilience.safe_devices(timeout=120, retries=0,
                                   platform="cpu") == [torch.device("cpu")]


def test_safe_devices_hung_probe_times_out_with_backoff():
    plan = faults.FaultPlan()
    plan.probe_hang(times=faults.EVERY)
    with plan, pytest.raises(resilience.DeviceProbeError, match="probe"):
        resilience.safe_devices(timeout=1, retries=2, backoff=0.0,
                                platform="cpu")
    assert plan.fired("device.probe") == 3


def test_safe_devices_recovers_after_transient_hang():
    plan = faults.FaultPlan()
    plan.probe_hang(times=1)
    with plan:
        devs = resilience.safe_devices(timeout=120, retries=1, backoff=0.0,
                                       platform="cpu")
    assert devs == [torch.device("cpu")]


def test_safe_devices_without_a_card_never_falls_back(monkeypatch):
    """The card probe on a machine without one raises; it never hands
    back the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card answers here")
    with pytest.raises(resilience.DeviceProbeError, match="CUDA"):
        resilience.safe_devices(timeout=120, retries=0)
    with pytest.raises(ValueError):
        resilience.safe_devices(platform="tpu")


def test_probed_devices_memoized(monkeypatch):
    calls = []
    real = resilience.safe_devices
    monkeypatch.setattr(resilience, "safe_devices",
                        lambda **kw: calls.append(kw) or real(**kw))
    monkeypatch.setattr(resilience, "_PROBED_DEVICES", {})
    a = resilience.probed_devices(platform="cpu")
    b = resilience.probed_devices(platform="cpu")
    assert a == b == [torch.device("cpu")] and len(calls) == 1


# -- the zoo under the runner (tests/test_models.py) ------------------

def _zoo_state(m, names):
    return b"".join(np.asarray(m.grid.get(n, m.grid.plan.cells)).tobytes()
                    for n in names)


@pytest.mark.parametrize("model", ["mhd", "vlasov"])
def test_zoo_resilient_runner_rollback_bitwise(tmp_path, model):
    def mk():
        if model == "mhd":
            m = GridMHD(n=6, device="cpu")
            return m, lambda g, i: m.run(1, dt=0.01), MHD_ALL
        v = GridVlasov(n=6, nv=10, device="cpu")
        return v, lambda g, i: v.run(1, dt=0.04), sorted(v.grid.fields)

    ref, ref_step, names = mk()
    ResilientRunner(ref.grid, ref_step, str(tmp_path / "ref.dc"),
                    check_every=1, checkpoint_every=4, backoff=0.0,
                    diagnostics_dir=str(tmp_path)).run(10)
    inj, inj_step, _ = mk()
    plan = faults.FaultPlan(seed=2)
    plan.nan_poison("rho" if model == "mhd" else "f", step=6)
    runner = ResilientRunner(inj.grid, inj_step, str(tmp_path / "i.dc"),
                             check_every=1, checkpoint_every=4, backoff=0.0,
                             diagnostics_dir=str(tmp_path))
    with plan:
        runner.run(10)
    assert runner.rollbacks == 1
    assert _zoo_state(inj, names) == _zoo_state(ref, names)


# -- async saves (tests/test_bgrecommit.py) ---------------------------

def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _mk_uniform():
    g = (Grid(cell_data={"rho": torch.float32, "aux": torch.float32})
         .set_initial_length((6, 6, 2))
         .set_periodic(True, True, False)
         .set_load_balancing_method("block")
         .initialize(["cpu"] * 2))
    cells = g.plan.cells
    g.set("rho", cells, (cells.astype(np.float64) % 17).astype(np.float32))
    g.set("aux", cells, np.ones(len(cells), dtype=np.float32))
    g.update_copies_of_remote_neighbors()
    return g


def _rho_kernel(c, nbr, offs, mask):
    return {"rho": 0.5 * c["rho"] + 0.125 * torch.sum(
        torch.where(mask, nbr["rho"], torch.zeros_like(nbr["rho"])), dim=1)}


def _rho_step(grid, _i):
    grid.run_steps(_rho_kernel, ["rho"], ["rho"], 1)


CELLS = {"rho": torch.float32, "aux": torch.float32}


@pytest.fixture
def _registry():
    telemetry.registry().reset()
    yield
    telemetry.registry().reset()


def test_async_store_saves_bitwise_identical(monkeypatch, tmp_path,
                                             _registry):
    def run(async_on, d):
        monkeypatch.setenv("DCCRG_ASYNC_SAVE", "1" if async_on else "0")
        g = _mk_uniform()
        store = CheckpointStore(str(d), stem="j")
        for i in range(6):
            _rho_step(g, i)
            store.save(g, i + 1)
        store.drain()
        return {n: _sha(os.path.join(str(d), n))
                for n in sorted(os.listdir(str(d)))}

    sync = run(False, tmp_path / "sync")
    asy = run(True, tmp_path / "async")
    assert sync == asy
    assert any(n.endswith(".dcd") for n in sync)
    assert telemetry.registry().counter_total(
        "dccrg_ckpt_async_saves_total") == 6


def test_async_torn_write_surfaces_at_drain_and_recovers(monkeypatch,
                                                         tmp_path,
                                                         _registry):
    monkeypatch.setenv("DCCRG_ASYNC_SAVE", "1")
    g = _mk_uniform()
    store = CheckpointStore(str(tmp_path), stem="j")
    store.save(g, 1)
    store.drain()
    plan = faults.FaultPlan(seed=5)
    plan.io_error(times=3)
    with plan:
        _rho_step(g, 0)
        path2 = store.save(g, 2)
        with pytest.raises(OSError):
            store.drain()
    assert not os.path.exists(path2)
    assert store._parent is None
    assert g._ckpt_dirty is None
    _rho_step(g, 1)
    path3 = store.save(g, 3)
    store.drain()
    assert path3.endswith(".dc")
    info = resume_latest(str(tmp_path), CELLS, stem="j", device="cpu")
    assert info is not None and info.step == 3
    assert telemetry.registry().counter_total(
        "dccrg_ckpt_async_errors_total") == 1


def test_async_gc_race_drains_before_pruning(monkeypatch, tmp_path):
    monkeypatch.setenv("DCCRG_ASYNC_SAVE", "1")
    g = _mk_uniform()
    store = CheckpointStore(str(tmp_path), stem="j")
    for i in range(4):
        _rho_step(g, i)
        store.save(g, i + 1, force_keyframe=True)
    rep = store.gc(keep_last=1)
    assert not store.pending()
    assert store.path_for(4) in [p for _s, p in rep.kept]
    assert resilience.verify_checkpoint(store.path_for(4)) == []


def test_async_runner_trip_rollback_reconverges(monkeypatch, tmp_path):
    def run(async_on, d):
        monkeypatch.setenv("DCCRG_ASYNC_SAVE", "1" if async_on else "0")
        d.mkdir()
        g = _mk_uniform()
        plan = faults.FaultPlan(seed=6)
        plan.nan_poison("rho", step=7)
        with plan:
            r = ResilientRunner(g, _rho_step, str(d / "c.dc"),
                                checkpoint_every=3, check_every=1,
                                backoff=0)
            r.run(12)
        return checkpoint_mod.state_digest(g), r.rollbacks

    sync = run(False, tmp_path / "s")
    asy = run(True, tmp_path / "a")
    assert sync == asy and sync[1] == 1


def test_async_preempt_emergency_save_then_resume_bitwise(monkeypatch,
                                                          tmp_path):
    monkeypatch.setenv("DCCRG_ASYNC_SAVE", "0")
    ref = SupervisedRunner(_mk_uniform(), _rho_step, str(tmp_path / "ref"),
                           check_every=100, checkpoint_every=3, backoff=0.0)
    ref.run(12)
    cells = ref.grid.plan.cells
    want = np.asarray(ref.grid.get("rho", cells)).tobytes()

    monkeypatch.setenv("DCCRG_ASYNC_SAVE", "1")
    sup = SupervisedRunner(_mk_uniform(), _rho_step, str(tmp_path / "pre"),
                           check_every=100, checkpoint_every=3, backoff=0.0)
    plan = faults.FaultPlan(seed=7)
    plan.preempt_signal(step=5)
    with plan, pytest.raises(PreemptedError) as ei:
        sup.run(12)
    assert ei.value.clean
    assert resilience.verify_checkpoint(ei.value.checkpoint) == []
    info = resume_latest(str(tmp_path / "pre"), CELLS, device="cpu")
    assert info is not None and not info.salvaged
    g = _mk_uniform()  # two partitions, as the run before the preemption
    for n in CELLS:
        g.set(n, cells, np.asarray(info.grid.get(n, cells)))
    g.update_copies_of_remote_neighbors()
    sup2 = SupervisedRunner(g, _rho_step, str(tmp_path / "pre"),
                            check_every=100, checkpoint_every=3,
                            backoff=0.0, start_step=info.step)
    sup2.run(12)
    assert np.asarray(g.get("rho", cells)).tobytes() == want


def test_async_negative_pin(monkeypatch, tmp_path, _registry):
    monkeypatch.delenv("DCCRG_ASYNC_SAVE", raising=False)
    g = _mk_uniform()
    store = CheckpointStore(str(tmp_path), stem="j")
    store.save(g, 1)
    assert not store.pending()
    assert telemetry.registry().counter_total(
        "dccrg_ckpt_async_saves_total") == 0


def test_async_runner_file_equals_sync(monkeypatch, tmp_path):
    """ResilientRunner's own async path (no store) publishes the bytes
    of the synchronous save."""
    out = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("DCCRG_ASYNC_SAVE", mode)
        g = _mk_uniform()
        p = tmp_path / f"m{mode}.dc"
        ResilientRunner(g, _rho_step, str(p), checkpoint_every=4,
                        check_every=1, backoff=0).run(8)
        out[mode] = (p.read_bytes(), json.loads(
            (tmp_path / f"m{mode}.dc.crc").read_text()))
    assert out["0"] == out["1"]


@pytest.mark.parametrize("n_dev", [1, 2, 3])
def test_find_nonfinite_cells_on_partitions_equals_reference(n_dev):
    """The trip's search, done on the grid's device, names the
    reference's cells (id-sorted) on a refined grid of ``n_dev``
    partitions, a scalar and a vector field, NaN and Inf."""
    import jax
    from jax.sharding import Mesh

    from dccrg_tpu import verify as ref_verify
    from dccrg_tpu.grid import Grid as RefGrid

    from dccrg_tpu_torch import verify

    def build(g, dev):
        g = (g.set_initial_length((4, 4, 4)).set_periodic(True, False, True)
             .set_maximum_refinement_level(1).set_neighborhood_length(1)
             .set_load_balancing_method("block").initialize(dev))
        g.refine_completely(int(g.plan.cells[5]))
        g.stop_refining()
        return g

    r = build(RefGrid(cell_data={"a": jnp.float32,
                                 "v": ((3,), jnp.float32)}),
              Mesh(np.array(jax.devices()[:n_dev]), ("dev",)))
    p = build(Grid(cell_data={"a": torch.float32,
                              "v": ((3,), torch.float32)}), ["cpu"] * n_dev)
    cells = p.plan.cells
    np.testing.assert_array_equal(cells, r.plan.cells)
    rng = np.random.default_rng(n_dev)
    pick = np.sort(rng.choice(len(cells), 5, replace=False))
    for g in (r, p):
        g.set("a", cells[pick[:3]], np.array([np.nan, np.inf, -np.inf],
                                             np.float32))
        v = np.zeros((2, 3), np.float32)
        v[0, 2] = np.nan
        v[1, 0] = np.inf
        g.set("v", cells[pick[3:]], v)
    got = verify.find_nonfinite_cells(p)
    want = ref_verify.find_nonfinite_cells(r)
    assert got.keys() == want.keys() == {"a", "v"}
    for name in got:
        np.testing.assert_array_equal(got[name], want[name])
    assert verify.find_nonfinite_cells(p, ["v"]).keys() == {"v"}
