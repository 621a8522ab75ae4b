"""The port's fleet scheduler against the reference's, on the CPU.

Each case runs one scenario (job set, fault plan, fake clock) through
``dccrg_tpu.scheduler.FleetScheduler`` and through
``dccrg_tpu_torch.scheduler.FleetScheduler`` (the CPU, the table
program) and holds them to each other (tests/torch_sched_fixture.py):
statuses, steps, trips, retries, rollbacks, requeues, admission order,
slot and bucket assignment, shed victims and every stem's files after
GC equal; final states within the port's fleet tolerance (rtol 1e-6,
atol 1e-4). Inside the port every digest equals its own ``run_solo``
and its own uninterrupted run bit for bit.

The cases are those of tests/test_fleet.py (the scheduler's),
tests/test_integrity.py (the SDC defence under the scheduler),
tests/test_telemetry.py (SLO policy and fleet traces) and
tests/test_models.py (mixed-kernel fleets; held to the port's own
``run_solo``, not to the reference's bitwise asserts, which fail on the
reference itself: ROADMAP.md section 3), at 6^3-12^3. Plus a fleet
directory the reference's scheduler left at a preemption, resumed by
the port's, and the intake and warm-pool hooks, whose construction from
the environment waits for ROADMAP.md queue 1, item 7b.
"""

import glob
import json
import os

import numpy as np
import pytest

from torch_sched_fixture import (PORT, REF, SIDES, assert_same_run, both,
                                 observe, rows, stem_files)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("DCCRG_INTEGRITY", "DCCRG_AUDIT_EVERY", "DCCRG_AUTOPILOT",
                "DCCRG_RANK_AWARE", "DCCRG_INTAKE", "DCCRG_COMPILE_CACHE",
                "DCCRG_ASYNC_SAVE", "DCCRG_FLEET_MAX_BATCH",
                "DCCRG_FLEET_QUANTUM", "DCCRG_BULK"):
        monkeypatch.delenv(var, raising=False)
    for side in SIDES:
        side.reset_telemetry()
    yield
    for side in SIDES:
        side.reset_telemetry()


def _specs(side, count=33, steps=14, kernel="diffuse", **kw):
    return [side.job(f"j{i:03d}", length=(8, 8, 8), kernel=kernel,
                     n_steps=steps, params=(0.02 + 0.005 * (i % 5),), seed=i,
                     checkpoint_every=5, **kw)
            for i in range(count)]


def _serve(side, d, jobs, plan=None, **kw):
    """One scheduler run under ``plan``: ``(report, log, workdir)`` and
    the scheduler."""
    sched = side.sched(d, jobs, **kw)
    log = observe(sched)
    if plan is None:
        report = sched.run()
    else:
        with plan:
            report = sched.run()
    return (report, log, d), sched


def _digests(report):
    return {n: r["digest"] for n, r in report.items()}


# ---------------------------------------------------------------------
# tests/test_fleet.py: the 33-job acceptance fleet
# ---------------------------------------------------------------------

N_BIG = 33


@pytest.fixture(scope="module")
def big(tmp_path_factory):
    """The no-fault fleet of both packages, and the port's solo
    digests: every port digest equals its run_solo bit for bit, and all
    33 jobs ran concurrently in one bucket."""
    out = {}
    for side in SIDES:
        d = tmp_path_factory.mktemp(f"big_{side.name}")
        side.reset_telemetry()
        run, sched = _serve(side, d, _specs(side), quantum=4)
        insts = [b for bs in sched.buckets.values() for b in bs]
        assert len(insts) == 1 and insts[0].capacity >= N_BIG
        out[side] = run
    assert_same_run(out[REF], out[PORT])
    solo = PORT.solo(_specs(PORT))
    assert _digests(out[PORT][0]) == solo
    return {"ref": out[REF], "port": out[PORT], "solo": solo}


def _isolation(tmp_path, big, make_plan, victim, site):
    runs, scheds, plans = {}, {}, {}
    for side in SIDES:
        d = tmp_path / side.name
        plan = make_plan(side.faults.FaultPlan)
        runs[side], scheds[side] = _serve(side, d, _specs(side), plan,
                                          quantum=4)
        plans[side] = plan
        assert plan.fired(site) == 1
    assert_same_run(runs[REF], runs[PORT])
    report = runs[PORT][0]
    assert all(r["status"] == "done" for r in report.values())
    assert {n for n, r in report.items() if r["trips"]} == {victim}
    nofault = _digests(big["port"][0])
    for n, r in report.items():
        if n != victim:
            assert r["digest"] == nofault[n], n
    assert report[victim]["digest"] == big["solo"][victim]
    return runs, scheds


def test_nan_trip_isolates_one_job(tmp_path, big):
    def plan(FaultPlan):
        p = FaultPlan(seed=1)
        p.nan_poison("rho", step=9, job="j017")
        return p

    _isolation(tmp_path, big, plan, "j017", "step.poison")


def test_silent_flip_isolates_one_job(tmp_path, big):
    def plan(FaultPlan):
        p = FaultPlan(seed=4)
        p.silent_flip("rho", step=9, job="j011")
        return p

    runs, scheds = _isolation(tmp_path, big, plan, "j011", "step.flip")
    assert runs[PORT][0]["j011"]["sdc_trips"] == 1
    assert scheds[PORT].suspects == scheds[REF].suspects == [1]


def test_oom_isolates_one_job(tmp_path, big):
    def plan(FaultPlan):
        p = FaultPlan(seed=2)
        p.resource_exhausted(job="j005")
        return p

    runs, _ = _isolation(tmp_path, big, plan, "j005", "step.dispatch")
    assert runs[PORT][0]["j005"]["requeues"] == 1


# ---------------------------------------------------------------------
# tests/test_fleet.py: the smaller scheduler cases
# ---------------------------------------------------------------------

def _failing_step(side, monkeypatch, when):
    real = side.fleet.GridBatch.step

    def step(self, budget):
        if when(self):
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory (injected)")
        return real(self, budget)

    monkeypatch.setattr(side.fleet.GridBatch, "step", step)


def test_real_batch_oom_shrinks_the_bucket(tmp_path, monkeypatch):
    runs = {}
    for side in SIDES:
        _failing_step(side, monkeypatch, lambda b: b.capacity > 4)
        runs[side], sched = _serve(side, tmp_path / side.name,
                                   _specs(side, count=8, steps=10), quantum=4)
        insts = [b for bs in sched.buckets.values() for b in bs]
        assert len(insts) == 1 and insts[0].capacity <= 4
    assert_same_run(runs[REF], runs[PORT])
    report = runs[PORT][0]
    assert _digests(report) == PORT.solo(_specs(PORT, count=8, steps=10))
    assert any(r["requeues"] for r in report.values())
    assert runs[PORT][1]["requeued"]


def test_no_resume_purges_stale_stems(tmp_path):
    def scenario(side, d):
        side.sched(d, _specs(side, count=2, steps=8), quantum=4).run()
        assert glob.glob(os.path.join(str(d), "j000_*"))
        plan = side.faults.FaultPlan(seed=7)
        plan.nan_poison("rho", step=5, job="j000")
        run, _ = _serve(side, d, _specs(side, count=2, steps=8), plan,
                        quantum=4, resume=False)
        return run

    runs = both(tmp_path, scenario)
    assert_same_run(runs[REF], runs[PORT])
    report = runs[PORT][0]
    assert report["j000"]["trips"] == 1
    assert _digests(report) == PORT.solo(_specs(PORT, count=2, steps=8))


def test_batch_oom_with_one_job_surfaces(tmp_path, monkeypatch):
    for side in SIDES:
        _failing_step(side, monkeypatch, lambda b: True)
        sched = side.sched(tmp_path / side.name,
                           _specs(side, count=4, steps=6), quantum=4)
        with pytest.raises(side.resilience.ResilienceExhaustedError):
            sched.run()


def test_per_slot_roundtrip_resumes_into_different_slot(tmp_path):
    def mk(side, prios):
        return [side.job(n, length=(8, 8, 8), n_steps=20, params=(0.03,),
                         seed=i, checkpoint_every=4, priority=p)
                for i, (n, p) in enumerate(zip("abcd", prios))]

    def scenario(side, d):
        sched = side.sched(d, mk(side, (0, 0, 0, 0)), quantum=4)
        sched.run(max_ticks=2)
        assert {j.name: s for _b, s, j in sched.active_jobs()} == \
            {"a": 0, "b": 1, "c": 2, "d": 3}
        del sched
        sched2 = side.sched(d, mk(side, (0, 1, 2, 3)), quantum=4)
        log = observe(sched2)
        sched2._admit_pending()
        assert {j.name: s for _b, s, j in sched2.active_jobs()} == \
            {"d": 0, "c": 1, "b": 2, "a": 3}
        resumed = {j.name: j.steps_done for _b, _s, j in sched2.active_jobs()}
        assert all(0 < v < 20 for v in resumed.values()), resumed
        return sched2.run(), log, d

    runs = both(tmp_path, scenario)
    assert_same_run(runs[REF], runs[PORT])
    assert _digests(runs[PORT][0]) == PORT.solo(mk(PORT, (0, 0, 0, 0)))


def test_backfill_drains_past_capacity(tmp_path):
    runs = {}
    for side in SIDES:
        runs[side], sched = _serve(side, tmp_path / side.name,
                                   _specs(side, count=10, steps=8),
                                   max_batch=4, quantum=3)
        insts = [b for bs in sched.buckets.values() for b in bs]
        assert len(insts) == 1 and insts[0].capacity == 4
    assert_same_run(runs[REF], runs[PORT])
    assert _digests(runs[PORT][0]) == PORT.solo(_specs(PORT, count=10, steps=8))
    # ten admissions into four slots, in priority-FIFO order
    assert [a[1] for a in runs[PORT][1]["admit"]] == \
        [f"j{i:03d}" for i in range(10)]


def test_job_scoped_rules_do_not_leak():
    faults, fleet = PORT.faults, PORT.fleet
    plan = faults.FaultPlan(seed=0)
    plan.nan_poison("rho", step=3, job="right")
    plan.resource_exhausted(job="right")
    with plan:
        g = fleet.template_grid(fleet.FleetJob("x", length=(4, 4, 4)), "cpu")
        assert faults.poison_step(g, 3) == []
        assert faults.poison_fleet("wrong", 0, 10) == []
        hits = faults.poison_fleet("right", 0, 10)
        assert [(h[0], h[3]) for h in hits] == [("rho", 3)]
        faults.fire("step.dispatch", mode="fleet", job="wrong", step=0)
        with pytest.raises(faults.SimulatedResourceExhausted):
            faults.fire("step.dispatch", mode="fleet", job="right", step=0)


def test_transient_dispatch_error_retries_in_place(tmp_path):
    runs = {}
    for side in SIDES:
        plan = side.faults.FaultPlan(seed=3)
        plan.dispatch_error(job="j002")
        runs[side], _ = _serve(side, tmp_path / side.name,
                               _specs(side, count=4, steps=10), plan,
                               quantum=4)
        assert plan.fired("supervise.dispatch") == 1
    assert_same_run(runs[REF], runs[PORT])
    report = runs[PORT][0]
    assert report["j002"]["transient_retries"] == 1
    assert all(r["trips"] == 0 for r in report.values())
    assert _digests(report) == PORT.solo(_specs(PORT, count=4, steps=10))


def test_unrecoverable_nan_fails_only_that_job(tmp_path):
    runs = {}
    for side in SIDES:
        specs = _specs(side, count=6, steps=12)
        for j in specs:
            j.max_retries = 2
        plan = side.faults.FaultPlan(seed=4)
        plan.nan_poison("rho", step=7, job="j001", times=side.faults.EVERY)
        runs[side], _ = _serve(side, tmp_path / side.name, specs, plan,
                               quantum=4)
    assert_same_run(runs[REF], runs[PORT])
    report = runs[PORT][0]
    solo = PORT.solo(_specs(PORT, count=6, steps=12))
    assert report["j001"]["status"] == "failed"
    assert report["j001"]["trips"] == 3
    for n, r in report.items():
        if n != "j001":
            assert r["status"] == "done" and r["digest"] == solo[n]


def _preempted(side, d, count=6, steps=16):
    """A fleet preempted at its second tick: exit code 75, every stem's
    emergency checkpoint verifying. Returns the requeued names."""
    plan = side.faults.FaultPlan(seed=5)
    plan.preempt_signal(step=1)
    sched = side.sched(d, _specs(side, count=count, steps=steps), quantum=3)
    with plan:
        with pytest.raises(side.scheduler.FleetPreemptedError) as ei:
            sched.run()
    assert ei.value.exit_code == side.supervise.RESUMABLE_EXIT == 75
    for i in range(count):
        entries = side.supervise.list_checkpoints(str(d), f"j{i:03d}")
        assert entries
        side.resilience.verify_chain(entries[0][1])
    return ei.value.requeued


def test_preempt_emergency_saves_and_resumes_bitwise(tmp_path):
    def scenario(side, d):
        requeued = _preempted(side, d)
        assert len(requeued) == 6
        files = stem_files(d)
        run, _ = _serve(side, d, _specs(side, count=6, steps=16), quantum=3)
        return run, files, requeued

    out = both(tmp_path, scenario)
    assert_same_run(out[REF][0], out[PORT][0])
    assert out[PORT][1] == out[REF][1] and out[PORT][2] == out[REF][2]
    assert _digests(out[PORT][0][0]) == PORT.solo(_specs(PORT, count=6, steps=16))


def test_reference_preempted_fleet_resumes_in_the_port(tmp_path):
    """The reference's scheduler leaves a fleet directory at a
    preemption; the port's resumes every job from those ``.dc`` files
    and sidecars, each from the step the reference saved, and finishes
    within the fleet tolerance of the reference's uninterrupted run."""
    d = tmp_path / "shared"
    d.mkdir()
    _preempted(REF, d)
    saved = {i: REF.supervise.list_checkpoints(str(d), f"j{i:03d}")[0][0]
             for i in range(6)}
    resumed = PORT.sched(d, _specs(PORT, count=6, steps=16), quantum=3)
    log = observe(resumed)
    report = resumed.run()
    assert [a[5] for a in sorted(log["admit"], key=lambda a: a[1])] == \
        [saved[i] for i in range(6)]
    want = observe_uninterrupted(tmp_path / "ref_whole")
    assert rows(report) == rows(want[0])
    for name, fields in want[1]["states"].items():
        np.testing.assert_allclose(log["states"][name]["rho"],
                                   fields["rho"], rtol=1e-6, atol=1e-4)


def observe_uninterrupted(d):
    d.mkdir()
    run, _ = _serve(REF, d, _specs(REF, count=6, steps=16), quantum=3)
    return run[0], run[1]


def test_delta_chains_and_retention_per_stem(tmp_path):
    def specs(side):
        return [side.job(f"m{i}", length=(6, 6, 6), n_steps=30,
                         params=(0.02,), seed=i, checkpoint_every=3,
                         cell_data={"rho": "float32", "aux": ((4,), "int32")})
                for i in range(3)]

    runs = {}
    for side in SIDES:
        d = tmp_path / side.name
        runs[side], _ = _serve(side, d, specs(side), quantum=3, keep_last=2)
        assert glob.glob(os.path.join(str(d), "m0_*.dcd"))
        for i in range(3):
            chains = side.supervise.chain_report(str(d), stem=f"m{i}")
            assert chains
            for _stem, links in chains:
                assert all(status == "OK" for _s, _p, _k, status in links)
            steps = {s for s, _p in side.supervise.list_checkpoints(
                str(d), f"m{i}")}
            assert len(steps) <= 4
    assert_same_run(runs[REF], runs[PORT])
    assert _digests(runs[PORT][0]) == PORT.solo(specs(PORT))


def test_run_solo_matches_batch_of_one(tmp_path):
    """A fleet of one job digests equal to run_solo (held in the port
    alone: the reference's advect_x batch is not bitwise its solo run,
    ROADMAP.md section 3)."""
    def job(side):
        return side.job("one", length=(8, 8, 8), n_steps=9, params=(0.07,),
                        seed=42, kernel="advect_x")

    runs = {}
    for side in SIDES:
        runs[side], _ = _serve(side, tmp_path / side.name, [job(side)],
                               quantum=4)
    assert_same_run(runs[REF], runs[PORT])
    assert runs[PORT][0]["one"]["digest"] == PORT.fleet.run_solo(job(PORT), "cpu")


# ---------------------------------------------------------------------
# tests/test_integrity.py: the SDC defence under the scheduler
# ---------------------------------------------------------------------

def _sjobs(side, count, steps=12, **kw):
    return [side.job(f"s{i:02d}", length=(8, 8, 8), n_steps=steps,
                     params=(0.02 + 0.004 * (i % 4),), seed=i,
                     checkpoint_every=4, **kw)
            for i in range(count)]


def _sdc(tmp_path, count, steps, flips, **kw):
    runs, scheds = {}, {}
    for side in SIDES:
        plan = None
        if flips:
            plan = side.faults.FaultPlan(seed=flips[0])
            for job, step in flips[1:]:
                plan.silent_flip("rho", step=step, job=job)
        runs[side], scheds[side] = _serve(side, tmp_path / side.name,
                                          _sjobs(side, count, steps), plan,
                                          **kw)
        if plan is not None:
            assert plan.fired("step.flip") == len(flips) - 1
    assert_same_run(runs[REF], runs[PORT])
    for attr in ("suspects", "quarantined", "audits", "audit_failures"):
        assert getattr(scheds[PORT], attr) == getattr(scheds[REF], attr), attr
    return runs[PORT][0], scheds[PORT], PORT.solo(_sjobs(PORT, count, steps))


def test_silent_flip_detected_within_one_quantum(tmp_path):
    report, sched, solo = _sdc(tmp_path, 6, 12, (1, ("s03", 6)), quantum=4)
    assert {n for n, r in report.items() if r["trips"]} == {"s03"}
    assert report["s03"]["sdc_trips"] == 1
    assert _digests(report) == solo
    assert sched.suspects[0] == 1


def test_corruption_between_quanta_detected(tmp_path):
    def scenario(side, d):
        sched = side.sched(d, _sjobs(side, 3, steps=8), quantum=2)
        log = observe(sched)
        sched._admit_pending()
        batch = next(b for bs in sched.buckets.values() for b in bs)
        sched._quantum(batch)
        sched.ticks += 1
        victim_slot, victim = batch.jobs[1]
        batch.flip(victim_slot, "rho", [int(batch.grid.plan.cells[5])], 23)
        return sched.run(), log, d

    runs = both(tmp_path, scenario)
    assert_same_run(runs[REF], runs[PORT])
    report = runs[PORT][0]
    assert report["s01"]["sdc_trips"] >= 1
    assert {n for n, r in report.items() if r["trips"]} == {"s01"}
    assert _digests(report) == PORT.solo(_sjobs(PORT, 3, steps=8))


def test_negative_pin_integrity_off_flip_undetected(tmp_path, monkeypatch):
    monkeypatch.setenv("DCCRG_INTEGRITY", "0")
    report, _sched, solo = _sdc(tmp_path, 4, 12, (2, ("s02", 6)), quantum=4)
    assert all(r["status"] == "done" and r["trips"] == 0
               for r in report.values())
    assert report["s02"]["digest"] != solo["s02"]
    assert all(report[n]["digest"] == solo[n] for n in solo if n != "s02")
    batch = PORT.fleet.GridBatch(_sjobs(PORT, 1)[0], 4, device="cpu",
                                 bulk=False)
    batch.step(np.array([1, 0, 0, 0], dtype=np.int32))
    assert batch.last_inv is None
    with pytest.raises(RuntimeError, match="DCCRG_INTEGRITY"):
        batch.fingerprint_slots()


def test_shadow_audit_detects_with_invariants_off(tmp_path, monkeypatch):
    monkeypatch.setenv("DCCRG_INTEGRITY", "0")
    report, sched, solo = _sdc(tmp_path, 4, 12, (3, ("s00", 2)), quantum=2,
                               audit_every=1)
    assert sched.audits > 0 and sched.audit_failures >= 1
    assert report["s00"]["sdc_trips"] >= 1
    assert {n for n, r in report.items() if r["trips"]} == {"s00"}
    assert _digests(report) == solo


def test_shadow_audit_clean_run_no_false_alarms(tmp_path):
    report, sched, solo = _sdc(tmp_path, 5, 10, (), quantum=2, audit_every=1)
    assert sched.audits > 0 and sched.audit_failures == 0
    assert all(r["trips"] == 0 for r in report.values())
    assert _digests(report) == solo


def test_audit_solo_path_when_batch_is_full(tmp_path):
    """Every slot taken: the audit re-executes through Grid.run_steps
    (bulk=False), bit for bit with the table program."""
    report, sched, solo = _sdc(tmp_path, 4, 8, (), quantum=2, max_batch=4,
                               audit_every=1)
    assert sched.audits > 0 and sched.audit_failures == 0
    assert _digests(report) == solo


def test_audit_skipped_on_a_full_bulk_bucket(tmp_path):
    """The port's bulk bucket (kernel A' through its plain version on
    the CPU) with no spare slot skips the audit and counts it; with a
    spare slot the audit runs the same program, bit for bit."""
    sched = PORT.sched(tmp_path / "full", _sjobs(PORT, 4, 8), quantum=2,
                       max_batch=4, audit_every=1, bulk=True)
    report = sched.run()
    assert all(r["status"] == "done" for r in report.values())
    assert sched.audits == 0
    assert PORT.telemetry.registry().counter_total(
        "dccrg_audits_skipped_total") > 0
    spare = PORT.sched(tmp_path / "spare", _sjobs(PORT, 4, 8), quantum=2,
                       audit_every=1, bulk=True)
    report = spare.run()
    assert spare.audits > 0 and spare.audit_failures == 0
    assert all(b.bulk_active() for bs in spare.buckets.values() for b in bs)


def test_dmr_redundancy_runs_clean_and_detects_flip(tmp_path, monkeypatch):
    runs = {}
    for side in SIDES:
        runs[side], _ = _serve(side, tmp_path / "clean" / side.name,
                               _sjobs(side, 2, 8, redundancy=2), quantum=2)
    assert_same_run(runs[REF], runs[PORT])
    solo = PORT.solo(_sjobs(PORT, 2, 8))
    assert all(r["trips"] == 0 and r["digest"] == solo[n]
               for n, r in runs[PORT][0].items())
    monkeypatch.setenv("DCCRG_INTEGRITY", "0")
    runs = {}
    for side in SIDES:
        plan = side.faults.FaultPlan(seed=4)
        plan.silent_flip("rho", step=3, job="s00")
        runs[side], _ = _serve(side, tmp_path / "flip" / side.name,
                               _sjobs(side, 2, 8, redundancy=2), plan,
                               quantum=2)
        assert plan.fired("step.flip") == 1
    assert_same_run(runs[REF], runs[PORT])
    rep2 = runs[PORT][0]
    assert rep2["s00"]["sdc_trips"] >= 1 and rep2["s01"]["trips"] == 0
    assert all(rep2[n]["digest"] == solo[n] for n in solo)


def test_repeat_offender_lane_quarantined_and_migrated(tmp_path):
    report, sched, solo = _sdc(tmp_path, 8, 16, (5, ("s02", 5), ("s04", 9)),
                               quantum=4, devices=[0, 1], quarantine_after=2)
    assert sched.quarantined == {0} and sched.suspects[0] == 2
    assert all(r["status"] == "done" for r in report.values())
    assert _digests(report) == solo
    assert {n for n, r in report.items() if r["trips"]} == {"s02", "s04"}
    for insts in sched.buckets.values():
        for b in insts:
            assert b.lane == 1


def test_single_lane_cannot_be_quarantined(tmp_path):
    report, sched, _solo = _sdc(tmp_path, 3, 12, (6, ("s00", 3), ("s01", 7)),
                                quantum=4, quarantine_after=2)
    assert sched.quarantined == set() and sched.suspects[0] == 2
    assert all(r["status"] == "done" for r in report.values())


# ---------------------------------------------------------------------
# tests/test_telemetry.py: the SLO policy and the fleet's traces
# ---------------------------------------------------------------------

def _policy(side, quantum=8, hand_fed=True, **kw):
    """An SLOPolicy on a fake clock at 0; ``hand_fed`` keeps the
    scheduler's measured latencies out of the EWMA, so only the
    test's observations move it (the same decisions in both packages,
    whatever the two hosts measure)."""
    pol = side.scheduler.SLOPolicy(quantum=quantum, clock=lambda: 0.0, **kw)
    if hand_fed:
        feed = pol.observe
        pol.feed = feed
        pol.observe = lambda key, seconds: None
    return pol


def _slo_jobs(side):
    return [side.job("slo_a", length=(8, 8, 8), n_steps=16, priority=2,
                     seed=1, checkpoint_every=100),
            side.job("slo_b", length=(8, 8, 8), n_steps=16, priority=1,
                     seed=2, checkpoint_every=100),
            side.job("slo_c", length=(8, 8, 8), n_steps=16, priority=0,
                     seed=3, checkpoint_every=100, slo_ms=1000.0)]


def test_slo_policy_ewma_projection_and_slack():
    for side in SIDES:
        clk = {"t": 0.0}
        pol = side.scheduler.SLOPolicy(quantum=8, alpha=0.5,
                                       clock=lambda: clk["t"])
        a, _b, c = _slo_jobs(side)
        key = c.bucket_key()
        assert pol.quantum_latency(key) is None
        assert pol.projected_completion_s(c) == 0.0
        pol.observe(key, 2.0)
        pol.observe(key, 4.0)
        assert pol.quantum_latency(key) == pytest.approx(3.0)
        assert pol.projected_completion_s(c) == pytest.approx(6.0)
        c.slo_t0 = 0.0
        clk["t"] = 0.25
        assert pol.slack_s(c) == pytest.approx(-5.25)
        assert pol.slack_s(a) is None
        assert pol.admission_key(c, 99) < pol.admission_key(a, 0)
        clk["t"] = 0.0
        pol.reset_key(key)
        assert pol.admission_key(a, 0) < pol.admission_key(c, 99)


def test_slo_admission_reorders_vs_priority_baseline(tmp_path):
    def scenario(side, d):
        base = side.sched(d / "base", _slo_jobs(side), max_batch=2, quantum=8,
                          slo_policy=_policy(side))
        base._admit_pending()
        jobs = _slo_jobs(side)
        pol = _policy(side)
        pol.feed(jobs[2].bucket_key(), 10.0)
        slo = side.sched(d / "slo", jobs, max_batch=2, quantum=8,
                         slo_policy=pol)
        slo._admit_pending()
        return ({j.name: j.status for j in base._by_name.values()},
                {j.name: j.status for j in slo._by_name.values()})

    out = both(tmp_path, scenario)
    assert out[PORT] == out[REF] == (
        {"slo_a": "running", "slo_b": "running", "slo_c": "queued"},
        {"slo_a": "running", "slo_b": "queued", "slo_c": "running"})


def test_slo_shed_requeues_to_smaller_bucket(tmp_path):
    def jobs(side):
        return [side.job(f"shed{i}", length=(8, 8, 8), n_steps=16,
                         priority=i, seed=i, checkpoint_every=4,
                         params=(0.01,), slo_ms=(100.0 if i == 3 else None))
                for i in range(4)]

    def scenario(side, d):
        js = jobs(side)
        pol = _policy(side)
        sched = side.sched(d, js, max_batch=8, quantum=8, slo_policy=pol)
        log = observe(sched)
        sched._admit_pending()
        (batch,) = [b for bs in sched.buckets.values() for b in bs]
        cap0 = batch.capacity
        pol.feed(batch.key, 10.0)
        pre = {j.name: batch.digest(s) for s, j in batch.jobs}
        sched._shed_for_slo(batch)
        shed = sorted(j.name for j in js if j.status == "queued")
        assert len(shed) == 2 and all(j.requeues == 1 for j in js
                                      if j.name in shed)
        (small,) = [b for bs in sched.buckets.values() for b in bs]
        assert small is not batch and small.capacity < cap0
        assert "shed3" in {j.name for _s, j in small.jobs}
        for s, j in small.jobs:
            assert small.digest(s) == pre[j.name]
        assert side.telemetry.registry().counter_total(
            "dccrg_fleet_slo_sheds_total") == 2
        assert pol.quantum_latency(batch.key) is None
        report = sched.run()
        assert report["shed3"]["slo_met"] is True
        return (report, log, d), shed, small.capacity

    out = both(tmp_path, scenario)
    assert_same_run(out[REF][0], out[PORT][0])
    assert out[PORT][1:] == out[REF][1:]
    report = out[PORT][0][0]
    assert _digests(report) == PORT.solo(
        [PORT.job(f"shed{i}", length=(8, 8, 8), n_steps=16, seed=i,
                  params=(0.01,)) for i in range(4)])


def test_priority_only_baseline_unchanged_without_slo(tmp_path):
    def scenario(side, d):
        jobs = [side.job(f"pb{i}", length=(8, 8, 8), n_steps=8,
                         priority=i % 3, seed=i, checkpoint_every=100)
                for i in range(5)]
        pol = _policy(side)
        pol.feed(jobs[0].bucket_key(), 1e6)
        sched = side.sched(d, jobs, max_batch=3, quantum=8, slo_policy=pol)
        sched._admit_pending()
        for bs in sched.buckets.values():
            for b in bs:
                assert pol.shed_victims(b.key, b.jobs) == []
        return sorted(j.name for j in jobs if j.status == "running")

    out = both(tmp_path, scenario)
    assert out[PORT] == out[REF] == ["pb1", "pb2", "pb4"]


def test_fleet_trace_covers_step_wall_clock(tmp_path):
    """The port's fleet spans cover the serving wall (>= 95% at depth
    0), with admission, quanta and job-tagged saves as distinct spans,
    the same span names and exposition series as the reference's."""
    import time

    names, series = {}, {}
    for side in SIDES:
        tel = side.telemetry
        tel.configure(trace=True, ring=max(tel.trace_ring_default(), 1 << 16))
        jobs = [side.job(f"cov{i}", length=(12, 12, 12), n_steps=12,
                         priority=i % 2, seed=i, checkpoint_every=4,
                         params=(0.01,)) for i in range(4)]
        sched = side.sched(tmp_path / side.name, jobs, quantum=4)
        t0 = time.perf_counter()
        report = sched.run()
        wall = time.perf_counter() - t0
        assert all(r["status"] == "done" for r in report.values())
        evs = tel.events()
        names[side] = {e["name"] for e in evs}
        assert {"fleet.admit", "fleet.quantum", "ckpt.save"} <= names[side]
        assert any(e.get("job", "").startswith("cov")
                   for e in evs if e["name"] == "ckpt.save")
        if side is PORT:
            cov = tel.root_coverage(evs, wall)
            assert cov >= 0.95, f"spans cover only {cov:.1%} of {wall:.3f}s"
            trace = tmp_path / "fleet_trace.jsonl"
            assert tel.flush_trace(str(trace)) == len(evs)
            assert len(tel.read_trace(str(trace))) == len(evs)
        text = tel.dump_prometheus()
        series[side] = {m for m in ("dccrg_saves_total",
                                    "dccrg_fleet_quantum_seconds",
                                    "dccrg_fleet_admissions_total",
                                    "dccrg_integrity_checks_total")
                        if m in text}
        reg = tel.registry()
        assert reg.counter_total("dccrg_fleet_admissions_total") == 4
        h = reg.histogram("dccrg_fleet_quantum_seconds", job="cov0")
        assert h is not None and h.total >= 3
        tel.configure(trace=False)
    assert names[PORT] == names[REF]
    assert series[PORT] == series[REF] and len(series[PORT]) == 4


def test_fleet_trip_and_rollback_counters(tmp_path):
    runs = {}
    for side in SIDES:
        jobs = [side.job(f"ctr{i}", length=(8, 8, 8), n_steps=12, seed=i,
                         params=(0.01,), checkpoint_every=4)
                for i in range(3)]
        plan = side.faults.FaultPlan(seed=3)
        plan.nan_poison("rho", step=6, job="ctr1")
        runs[side], _ = _serve(side, tmp_path / side.name, jobs, plan,
                               quantum=4)
        reg = side.telemetry.registry()
        assert reg.counter_value("dccrg_fleet_trips_total", job="ctr1",
                                 kind="nan") == 1
        assert reg.counter_value("dccrg_fleet_rollbacks_total",
                                 job="ctr1") == 1
        assert reg.counter_total("dccrg_fleet_trips_total", job="ctr0") == 0
        text = side.telemetry.dump_prometheus()
        assert "dccrg_fleet_trips_total" in text
        assert "dccrg_fleet_rollbacks_total" in text
    assert_same_run(runs[REF], runs[PORT])
    assert runs[PORT][0]["ctr1"]["rollbacks"] == 1


# ---------------------------------------------------------------------
# tests/test_models.py: mixed-kernel fleets (the port's own run_solo)
# ---------------------------------------------------------------------

def _zoo(side, kernels=("advect_x", "mhd", "vlasov"), count=2, steps=10,
         length=(6, 6, 6), every=4, seed=lambda k, i: 17 * i + 3,
         prefix=None):
    return [side.job(f"{prefix or k}{i}", kernel=k, length=length,
                     n_steps=steps,
                     seed=seed(k, i), checkpoint_every=every)
            for k in kernels for i in range(count)]


def test_mixed_kernel_fleet_isolation(tmp_path):
    runs = {}
    for side in SIDES:
        plan = side.faults.FaultPlan(seed=5)
        plan.nan_poison("rho", step=4, job="mhd1")
        runs[side], _ = _serve(side, tmp_path / side.name, _zoo(side), plan,
                               quantum=4)
        assert plan.fired("step.poison") == 1
    assert_same_run(runs[REF], runs[PORT])
    jobs = _zoo(PORT)
    assert len({j.bucket_key() for j in jobs}) == 3
    report, solo = runs[PORT][0], PORT.solo(_zoo(PORT))
    for j in jobs:
        assert report[j.name]["status"] == "done"
        assert report[j.name]["digest"] == solo[j.name], j.name
        if j.name != "mhd1":
            assert not report[j.name]["trips"]
    assert report["mhd1"]["trips"] >= 1


def test_mixed_kernel_fleet_checkpoint_resume(tmp_path):
    def jobs(side):
        return [side.job(f"r_{k}", kernel=k, length=(6, 6, 6), n_steps=10,
                         seed=23, checkpoint_every=4)
                for k in ("advect_x", "mhd", "vlasov")]

    def scenario(side, d):
        side.sched(d, jobs(side), quantum=2).run(max_ticks=2)
        run, _ = _serve(side, d, jobs(side), quantum=4, resume=True)
        return run

    runs = both(tmp_path, scenario)
    assert_same_run(runs[REF], runs[PORT])
    report, solo = runs[PORT][0], PORT.solo(jobs(PORT))
    for name, r in report.items():
        assert r["status"] == "done" and r["digest"] == solo[name], name
    # every job resumed from the step its first scheduler saved
    assert all(a[5] > 0 for a in runs[PORT][1]["admit"])


def test_mixed_kernel_lane_slo_shed(tmp_path):
    def jobs(side):
        return [side.job("be_adv", kernel="advect_x", length=(6, 6, 6),
                         n_steps=12, seed=1, checkpoint_every=4),
                side.job("slo_mhd", kernel="mhd", length=(6, 6, 6),
                         n_steps=12, seed=2, checkpoint_every=4,
                         slo_ms=100.0)]

    def scenario(side, d):
        js = jobs(side)
        pol = _policy(side, quantum=4)
        sched = side.sched(d, js, quantum=4, slo_policy=pol)
        log = observe(sched)
        sched._admit_pending()
        batches = [b for bs in sched.buckets.values() for b in bs]
        assert len(batches) == 2
        for b in batches:
            pol.feed(b.key, 0.02)
        sched._shed_for_lane()
        by_name = {j.name: j for j in js}
        assert by_name["be_adv"].status == "parked"
        assert by_name["slo_mhd"].status == "running"
        assert side.telemetry.registry().counter_total(
            "dccrg_fleet_lane_sheds_total") == 1
        report = sched.run()
        assert report["slo_mhd"]["slo_met"] is True
        return report, log, d

    runs = both(tmp_path, scenario)
    assert_same_run(runs[REF], runs[PORT])
    assert runs[PORT][1]["parked"] == [(0, "be_adv")]
    report, solo = runs[PORT][0], PORT.solo(jobs(PORT))
    for name, r in report.items():
        assert r["status"] == "done" and r["digest"] == solo[name], name


def test_lane_shed_negative_pin_without_slo(tmp_path):
    for side in SIDES:
        jobs = [side.job("a", kernel="advect_x", length=(6, 6, 6),
                         n_steps=6, seed=1),
                side.job("m", kernel="mhd", length=(6, 6, 6), n_steps=6,
                         seed=2)]
        pol = _policy(side, quantum=4)
        sched = side.sched(tmp_path / side.name, jobs, quantum=4,
                           slo_policy=pol)
        sched._admit_pending()
        for bs in sched.buckets.values():
            for b in bs:
                pol.feed(b.key, 99.0)
        sched._shed_for_lane()
        assert not sched._parked
        assert all(j.status == "running" for j in jobs)


def test_fleet_sdc_fingerprints_cover_wide_field(tmp_path):
    runs = {}
    for side in SIDES:
        plan = side.faults.FaultPlan(seed=9)
        plan.silent_flip("f", step=5, job="vl1")
        runs[side], _ = _serve(
            side, tmp_path / side.name,
            _zoo(side, ("vlasov",), count=3, every=3,
                 seed=lambda k, i: 5 + i, prefix="vl"), plan, quantum=3)
        assert plan.fired("step.flip") == 1
    assert_same_run(runs[REF], runs[PORT])
    report = runs[PORT][0]
    solo = PORT.solo(_zoo(PORT, ("vlasov",), count=3, every=3,
                          seed=lambda k, i: 5 + i, prefix="vl"))
    assert report["vl1"]["sdc_trips"] >= 1
    for name, r in report.items():
        assert r["status"] == "done" and r["digest"] == solo[name], name
        if name != "vl1":
            assert not r["trips"]


def test_jobs_from_spec_names_zoo_kernels(tmp_path):
    spec = {"jobs": [
        {"name": "jm", "kernel": "mhd", "n": 6, "steps": 4},
        {"name": "jv", "kernel": "vlasov", "n": 6, "steps": 4},
        {"name": "jd", "kernel": "diffuse", "n": 6, "steps": 4},
    ]}
    runs = {}
    for side in SIDES:
        jobs = side.fleet._jobs_from_spec(spec)
        assert "f" in jobs[1].cell_data and jobs[2].params == (0.1,)
        runs[side], _ = _serve(side, tmp_path / side.name, jobs, quantum=4)
    assert_same_run(runs[REF], runs[PORT])
    assert all(r["status"] == "done" for r in runs[PORT][0].values())
    json.dumps(_digests(runs[PORT][0]))


# ---------------------------------------------------------------------
# the port's own: the bulk program under the scheduler, the 7b hooks
# ---------------------------------------------------------------------

def test_bulk_scheduler_matches_the_table_scheduler(tmp_path):
    """bulk=True: every diffuse and advect_x bucket takes the bulk
    program (kernel A' through its plain version on the CPU), a NaN
    trip and a flip are contained alike, and the states agree with the
    table scheduler's within the bulk rule (rtol 1e-5, atol 1e-6)."""
    out = {}
    for bulk in (False, True):
        jobs = (_specs(PORT, count=6, steps=10)
                + [PORT.job(f"x{i}", length=(8, 8, 8), kernel="advect_x",
                            n_steps=10, params=(0.3,), seed=40 + i,
                            checkpoint_every=5) for i in range(3)])
        plan = PORT.faults.FaultPlan(seed=1)
        plan.nan_poison("rho", step=5, job="j002")
        plan.silent_flip("rho", step=6, job="x1")
        out[bulk], sched = _serve(PORT, tmp_path / str(bulk), jobs, plan,
                                  quantum=4, bulk=bulk)
        assert all(b.bulk_active() is bulk
                   for bs in sched.buckets.values() for b in bs)
    assert rows(out[True][0]) == rows(out[False][0])
    for name, fields in out[False][1]["states"].items():
        np.testing.assert_allclose(out[True][1]["states"][name]["rho"],
                                   fields["rho"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("var,value", [("DCCRG_INTAKE", "1"),
                                       ("DCCRG_COMPILE_CACHE", "/nowhere")])
def test_intake_and_warm_pool_wait_for_item_7b(tmp_path, monkeypatch, var,
                                               value):
    monkeypatch.setenv(var, value)
    with pytest.raises(NotImplementedError, match="queue 1, item 7b"):
        PORT.sched(tmp_path, [])
    monkeypatch.delenv(var)
    sched = PORT.sched(tmp_path, [])
    assert sched.intake is None and sched.warm is None

