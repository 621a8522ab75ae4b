"""Shared helpers of the port's scheduler parity tests
(test_torch_scheduler.py, test_torch_autopilot.py,
test_torch_fleet_elastic.py): one scenario function, run once with the
reference's modules and once with the port's on the same job set, fault
plan and fake clock, and the comparison of what the two report.

A :class:`Side` bundles one package's modules. The reference schedules
on its default device (the conftest's first virtual CPU device); the
port on the CPU with ``bulk=False``, the table program, whose slots
digest equal to the port's ``run_solo`` bit for bit. :func:`observe`
instruments a scheduler instance (admissions with their slot, bucket
capacity and lane; trips; requeued and parked victims; each finished
job's final state) without changing what it does.

Tolerance between the packages: the port's float32 fleet tolerance,
``rtol 1e-6, atol 1e-4`` (tests/test_torch_fleet.py: values lie in
[0, 100] and the reference's own solo and batch runs of ``advect_x``
differ by about 3 float32 ulps); everything else compares exactly.
"""

import os

import numpy as np

import jax

from dccrg_tpu import autopilot as r_autopilot
from dccrg_tpu import checkpoint as r_checkpoint
from dccrg_tpu import coord as r_coord
from dccrg_tpu import faults as r_faults
from dccrg_tpu import fleet as r_fleet
from dccrg_tpu import integrity as r_integrity
from dccrg_tpu import resilience as r_resilience
from dccrg_tpu import scheduler as r_scheduler
from dccrg_tpu import supervise as r_supervise
from dccrg_tpu import telemetry as r_telemetry

from dccrg_tpu_torch import autopilot as p_autopilot
from dccrg_tpu_torch import checkpoint as p_checkpoint
from dccrg_tpu_torch import coord as p_coord
from dccrg_tpu_torch import faults as p_faults
from dccrg_tpu_torch import fleet as p_fleet
from dccrg_tpu_torch import integrity as p_integrity
from dccrg_tpu_torch import resilience as p_resilience
from dccrg_tpu_torch import scheduler as p_scheduler
from dccrg_tpu_torch import supervise as p_supervise
from dccrg_tpu_torch import telemetry as p_telemetry

F32_TOL = dict(rtol=1e-6, atol=1e-4)


class Side:
    """One package's modules and the way its scheduler runs here."""

    def __init__(self, port: bool):
        self.port = port
        self.name = "port" if port else "ref"
        if port:
            (self.autopilot, self.checkpoint, self.coord, self.faults,
             self.fleet, self.integrity, self.resilience, self.scheduler,
             self.supervise, self.telemetry) = (
                p_autopilot, p_checkpoint, p_coord, p_faults, p_fleet,
                p_integrity, p_resilience, p_scheduler, p_supervise,
                p_telemetry)
        else:
            (self.autopilot, self.checkpoint, self.coord, self.faults,
             self.fleet, self.integrity, self.resilience, self.scheduler,
             self.supervise, self.telemetry) = (
                r_autopilot, r_checkpoint, r_coord, r_faults, r_fleet,
                r_integrity, r_resilience, r_scheduler, r_supervise,
                r_telemetry)

    def __repr__(self):
        return self.name

    @property
    def device(self):
        return "cpu" if self.port else jax.devices()[0]

    def job(self, name, **kw):
        """A FleetJob; ``cell_data`` dtypes are names, which both
        packages read."""
        return self.fleet.FleetJob(name, **kw)

    def sched(self, checkpoint_dir, jobs=(), **kw):
        """A FleetScheduler over ``checkpoint_dir``; the port's on the
        CPU with the table program unless told otherwise. ``devices``
        gives the number of lanes, all on this side's device."""
        lanes = len(kw.get("devices") or [None])
        kw["devices"] = [self.device] * lanes  # lanes on one device
        if self.port:
            kw.setdefault("bulk", False)
        return self.scheduler.FleetScheduler(str(checkpoint_dir), jobs, **kw)

    def solo(self, jobs) -> dict:
        """``run_solo`` digests of ``jobs`` (fresh copies: the scheduler
        mutates a job's runtime state), one template grid per bucket."""
        grids, out = {}, {}
        for j in jobs:
            g = grids.get(j.bucket_key())
            if g is None:
                g = grids[j.bucket_key()] = self.fleet.template_grid(
                    j, self.device)
            j.apply_init(g)
            if j.n_steps:
                g.run_steps(j.resolved_kernel(), j.fields_in, j.fields_out,
                            j.n_steps, extra_args=self.extras(j))
            out[j.name] = self.checkpoint.state_digest(g)
        return out

    def extras(self, job):
        if self.port:
            import torch

            return tuple(torch.tensor(p, dtype=torch.float32)
                         for p in job.params)
        import jax.numpy as jnp

        return tuple(jnp.float32(p) for p in job.params)

    def reset_telemetry(self):
        t = self.telemetry
        t.configure(trace=False)
        t.clear_trace()
        t.registry().reset()
        t._METRICS_STATE["last"] = None


REF, PORT = Side(False), Side(True)
SIDES = (REF, PORT)


def as_f64(a):
    return np.asarray(a, dtype=np.float64)


def observe(sched):
    """Instrument one scheduler instance and return its log: ``admit``
    [(tick, name, slot, capacity, lane, steps_done)], ``trips`` [(tick,
    name, kind, steps_done)], ``requeued`` [(tick, names)] of the OOM
    and SLO-shed requeues, ``parked`` [(tick, name)], and ``states``
    {name: {field: float64 array}} of every job at its finish."""
    log = {"admit": [], "trips": [], "requeued": [], "parked": [],
           "states": {}}
    orig_admit, orig_trip = sched._admit_into, sched._trip
    orig_finish, orig_requeue = sched._finish, sched._requeue_keyframed
    orig_lane = sched._shed_for_lane

    def admit(batch, job):
        orig_admit(batch, job)
        slot = next((s for s, j in enumerate(batch.slots) if j is job), None)
        log["admit"].append((sched.ticks, job.name, slot, batch.capacity,
                             getattr(batch, "lane", 0), job.steps_done))

    def trip(batch, slot, job, kind):
        log["trips"].append((sched.ticks, job.name, kind, job.steps_done))
        orig_trip(batch, slot, job, kind)

    def finish(batch, slot, job, status="done"):
        state = (batch.extract(slot) if batch is not None
                 and status == "done" else None)
        orig_finish(batch, slot, job, status)
        if state is not None and job.status == "done":
            log["states"][job.name] = {n: as_f64(v) for n, v in state.items()}

    def requeue(batch, victims):
        log["requeued"].append((sched.ticks, sorted(j.name for _s, j in victims)))
        orig_requeue(batch, victims)

    def lane():
        before = {id(e["job"]) for e in sched._parked}
        orig_lane()
        log["parked"] += [(sched.ticks, e["job"].name) for e in sched._parked
                          if id(e["job"]) not in before]

    sched._admit_into, sched._trip = admit, trip
    sched._finish, sched._requeue_keyframed = finish, requeue
    sched._shed_for_lane = lane
    return log


def rows(report):
    """Report rows without the digest (compared apart)."""
    return {n: {k: v for k, v in r.items() if k != "digest"}
            for n, r in report.items()}


def stem_files(d):
    return sorted(f for f in os.listdir(str(d)) if not f.startswith("."))


def assert_same_run(ref, port, tol=F32_TOL):
    """``ref`` and ``port`` are ``(report, log, workdir)`` of one
    scenario: equal rows, admissions, trips, victims and stem files,
    and every finished job's state within ``tol``."""
    r_rep, r_log, r_dir = ref
    p_rep, p_log, p_dir = port
    assert rows(p_rep) == rows(r_rep)
    for key in ("admit", "trips", "requeued", "parked"):
        assert p_log[key] == r_log[key], key
    if r_dir is not None:
        assert stem_files(p_dir) == stem_files(r_dir)
    assert sorted(p_log["states"]) == sorted(r_log["states"])
    for name, fields in r_log["states"].items():
        for f, want in fields.items():
            np.testing.assert_allclose(p_log["states"][name][f], want,
                                       err_msg=f"{name}.{f}", **tol)


def both(tmp_path, scenario, *args, **kw):
    """Run ``scenario(side, workdir, *args, **kw)`` for both packages,
    each in its own directory; returns {side: result}."""
    out = {}
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir(exist_ok=True)
        side.reset_telemetry()
        out[side] = scenario(side, d, *args, **kw)
    return out
