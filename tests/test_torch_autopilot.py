"""The port's fleet autopilot against the reference's, on the CPU.

Every rule function of ``dccrg_tpu_torch.autopilot`` derives the same
action as the reference's on a seeded grid of inputs; ``key_id`` of a
port bucket key equals the reference's for the same job; the
scheduler-driven cases of tests/test_autopilot.py run on both packages
(fake clock, hand-fed observations, tests/torch_sched_fixture.py) and
journal the same decisions: equal rule, knob, before, after and
inputs, but for the inputs a host measures (save, rollback and quantum
seconds of a real dispatch), which are compared only where the case
feeds them by hand. A journal written by either package replays in the
other with zero divergence.
"""

import json
import os

import numpy as np
import pytest

from torch_sched_fixture import PORT, REF, SIDES, both, rows

#: decision inputs a host measures (real save, rollback and dispatch
#: timings), dropped where a case lets the scheduler measure them
MEASURED = ("save_cost_s", "rollback_s", "quantum_latency_s",
            "slo_slack_min_s", "step_seconds")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("DCCRG_AUTOPILOT", "DCCRG_DECISION_FILE",
                "DCCRG_STATUS_FILE", "DCCRG_INTEGRITY", "DCCRG_BULK"):
        monkeypatch.delenv(var, raising=False)
    for side in SIDES:
        side.reset_telemetry()
    yield
    for side in SIDES:
        side.reset_telemetry()


def _jobs(side, count=4, steps=16, slo_ms=None, **kw):
    return [side.job(f"a{i:02d}", length=(8, 8, 8), n_steps=steps, seed=i,
                     params=(0.03,), checkpoint_every=4, slo_ms=slo_ms, **kw)
            for i in range(count)]


def _sched(side, d, jobs, ap=None, quantum=4, **kw):
    pol = side.scheduler.SLOPolicy(quantum=quantum, clock=lambda: 0.0)
    return side.sched(d / "work", jobs, quantum=quantum, slo_policy=pol,
                      autopilot=ap, **kw), pol


def _ap(side, **kw):
    kw.setdefault("clock", lambda: 0.0)
    return side.autopilot.Autopilot(**kw)


def _tick(sched, ap, n=1):
    for _ in range(n):
        ap.tick(sched)
        sched.ticks += 1


def decisions(recs, measured=False):
    """Decision records without their wall-clock stamp; ``measured``
    also drops the host-measured inputs."""
    out = []
    for r in recs:
        r = {k: v for k, v in r.items() if k != "ts"}
        if measured:
            r["inputs"] = {k: v for k, v in r["inputs"].items()
                           if k not in MEASURED}
        out.append(r)
    return out


def same_decisions(out, measured=False, key=lambda o: o):
    a = decisions(key(out[REF]), measured)
    b = decisions(key(out[PORT]), measured)
    assert b == a
    return b


# ---------------------------------------------------------------------
# the rules and key_id
# ---------------------------------------------------------------------

def _rule_inputs(rng, rule):
    maybe = lambda v: None if rng.random() < 0.2 else v  # noqa: E731
    lo, hi = 1, int(rng.integers(2, 512))
    inp = {
        "lo": lo, "hi": hi,
        "slo_slack_min_s": maybe(float(rng.normal(0, 50))),
        "quantum_latency_s": maybe(float(abs(rng.normal(0, 10)))),
        "trip_rate": float(abs(rng.normal(0, 0.05))),
        "save_cost_s": maybe(float(abs(rng.normal(0, 10)))),
        "step_seconds": maybe(float(abs(rng.normal(0, 1)))),
        "new_suspects": int(rng.integers(-1, 5)),
        "clean_streak": int(rng.integers(0, 20)),
        "relax_after": 8, "baseline": int(rng.integers(0, 17)),
        "warm_start": 8, "streak": int(rng.integers(0, 10)),
        "patience": int(rng.integers(1, 5)),
        "trip_warm": 0.02, "trip_cool": 0.005, "slack_factor": 8.0,
        "deadband": 0.25, "observed_capacity": int(rng.integers(1, 256)),
        "learned_capacity": maybe(int(rng.integers(1, 256))),
        "rollback_s": maybe(float(abs(rng.normal(0, 10)))),
        "learned_quantum": maybe(int(rng.integers(1, 512))),
        "final_quantum": maybe(int(rng.integers(1, 512))),
        "configured": int(rng.integers(1, 512)),
        "clean_run": bool(rng.integers(0, 2)),
        "default_capacity": maybe(int(rng.integers(1, 256))),
        "new_sheds": int(rng.integers(-1, 3)),
        "shed_clean_streak": int(rng.integers(0, 12)),
        "repeat_trips": int(rng.integers(0, 6)),
        "recovered": int(rng.integers(0, 6)),
        "n": int(rng.integers(-1, 4)), "jobs": [], "dead_rank": 1,
        "lease_s": 8.0,
        "ratio": maybe(float(abs(rng.normal(1.0, 0.3)))),
        "queue_age_s": float(abs(rng.normal(0, 40))),
        "age_bound_s": 30.0,
        "name": maybe("j1"),
        "decision": ["warm", "cold", "reject", "quarantine", "other"][
            int(rng.integers(0, 5))],
    }
    if rule == "intake.backpressure":
        inp["hi"], inp["lo"] = 1.2, 0.9
    return inp


def _before(rng, rule):
    if rule in ("capacity.learn", "quantum.learn") and rng.random() < 0.3:
        return None
    if rule.startswith(("audit.", "intake.", "fleet.", "warmstart.")):
        return int(rng.integers(0, 17))
    return int(rng.integers(1, 65))


@pytest.mark.parametrize("rule", sorted(REF.autopilot.RULES))
def test_rule_matches_reference(rule):
    """400 seeded inputs per rule, and their JSON round trips: the same
    action (or the same refusal) in both packages, and the same
    expected-effect text."""
    assert sorted(PORT.autopilot.RULES) == sorted(REF.autopilot.RULES)
    rng = np.random.default_rng(sorted(REF.autopilot.RULES).index(rule))
    fired = 0
    for _ in range(400):
        inp = _rule_inputs(rng, rule)
        before = _before(rng, rule)
        want = REF.autopilot.RULES[rule](before, inp)
        assert PORT.autopilot.RULES[rule](before, inp) == want, inp
        rt = json.loads(json.dumps(inp))
        assert PORT.autopilot.RULES[rule](before, rt) == want
        fired += want is not None
    assert fired > 0
    assert PORT.autopilot.EXPECTED[rule] == REF.autopilot.EXPECTED[rule]


def _key_jobs(side):
    def kern(c, nbr, offs, mask, dt):
        return {"rho": c["rho"]}

    return [side.job("a", length=(8, 8, 8)),
            side.job("b", length=(6, 5, 7), kernel="advect_x",
                     periodic=(True, False, True)),
            side.job("c", length=(8, 8, 8), cell_data={"rho": "bfloat16"}),
            side.job("d", length=(6, 6, 6), kernel="mhd"),
            side.job("e", length=(6, 6, 6), kernel="vlasov"),
            side.job("f", length=(8, 8, 8), kernel=kern,
                     cell_data={"rho": "float32", "aux": ((4,), "int32")})]


def test_key_id_equal_for_the_same_job():
    """A port bucket key (torch dtypes in its schema, a kernel name or a
    callable's qualname) has the reference's id, so a journal's
    capacity history carries across."""
    for r, p in zip(_key_jobs(REF), _key_jobs(PORT)):
        assert PORT.autopilot.key_id(p.bucket_key()) == \
            REF.autopilot.key_id(r.bucket_key()), r.name
    import torch

    assert PORT.autopilot.key_id(("x", torch.float32)) == \
        REF.autopilot.key_id(("x", "float32"))


def test_knobs_and_explain_match_reference(monkeypatch):
    for side in SIDES:
        monkeypatch.setenv("DCCRG_DECISION_RING", "3")
        assert side.autopilot.decision_ring_default() == 16
        monkeypatch.setenv("DCCRG_AUTOPILOT", "off")
        assert side.autopilot.autopilot_enabled() is False
    rec = {"seq": 0, "tick": 3, "rank": 1, "rule": "audit.tighten",
           "knob": "audit_every", "before": 8, "after": 4,
           "inputs": {"new_suspects": 2}, "expected": "x"}
    line = PORT.autopilot.explain_decision(rec)
    assert line == REF.autopilot.explain_decision(rec)
    for frag in ("tick 3", "rank 1", "audit.tighten", "8 -> 4",
                 "new_suspects=2", "expected: x"):
        assert frag in line


# ---------------------------------------------------------------------
# knob convergence under injected histories (tests/test_autopilot.py)
# ---------------------------------------------------------------------

def test_quantum_shortens_under_slo_violation(tmp_path):
    def scenario(side, d):
        jobs = _jobs(side, 2, slo_ms=100.0)
        ap = _ap(side, quantum=16)
        sched, pol = _sched(side, d, jobs, ap, quantum=16)
        sched._admit_pending()
        for j in jobs:
            j.slo_t0 = 0.0
        pol.observe(jobs[0].bucket_key(), 10.0)
        _tick(sched, ap, 8)
        assert sched.quantum == ap.bounds["quantum"][0] == 1
        assert pol.quantum == 1
        return list(ap.decisions)

    recs = same_decisions(both(tmp_path, scenario), measured=True)
    assert [(r["before"], r["after"]) for r in recs] == \
        [(16, 8), (8, 4), (4, 2), (2, 1)]


def test_quantum_lengthens_with_comfortable_slack(tmp_path):
    def scenario(side, d):
        jobs = _jobs(side, 2)
        ap = _ap(side, quantum=4, lengthen_patience=3)
        sched, pol = _sched(side, d, jobs, ap, quantum=4)
        sched._admit_pending()
        pol.observe(jobs[0].bucket_key(), 1e-4)
        _tick(sched, ap, 2)
        assert sched.quantum == 4
        _tick(sched, ap, 20)
        assert sched.quantum == ap.bounds["quantum"][1] == 32
        return list(ap.decisions)

    recs = same_decisions(both(tmp_path, scenario), measured=True)
    assert {r["rule"] for r in recs} == {"quantum.lengthen"}


def test_shed_cooldown_follows_shed_churn(tmp_path):
    def scenario(side, d):
        ap = _ap(side, quantum=4, relax_after=2)
        sched, pol = _sched(side, d, _jobs(side, 2), ap, quantum=4)
        sched._admit_pending()
        seen = [pol.shed_cooldown]
        for shed in (True, True, False, False, False, False) + (False,) * 6:
            if shed:
                side.telemetry.inc("dccrg_fleet_slo_sheds_total", job="x")
            _tick(sched, ap)
            seen.append(pol.shed_cooldown)
        return list(ap.decisions), seen

    out = both(tmp_path, scenario)
    same_decisions(out, measured=True, key=lambda o: o[0])
    seen = out[PORT][1]
    assert seen == out[REF][1]
    assert (seen[1], seen[2], seen[4], seen[6], seen[-1]) == (8, 16, 8, 4, 4)


def test_retry_budget_follows_trip_history(tmp_path):
    def scenario(side, d):
        jobs = _jobs(side, 2)
        ap = _ap(side, quantum=4)
        sched, _pol = _sched(side, d, jobs, ap, quantum=4)
        sched._admit_pending()
        doomed, healthy = jobs
        doomed.trips = [("nan", 5)] * 3
        doomed.retries = 3
        healthy.trips = [("nan", 2)]
        healthy.retries = 0
        _tick(sched, ap)
        assert (doomed.max_retries, healthy.max_retries) == (2, 4)
        _tick(sched, ap, 4)
        for _ in range(6):
            doomed.trips.append(("nan", 5))
            doomed.retries += 1
            _tick(sched, ap)
        assert doomed.max_retries == ap.bounds["max_retries"][0] == 1
        assert side.autopilot.replay(list(ap.decisions)) == []
        return list(ap.decisions)

    same_decisions(both(tmp_path, scenario), measured=True)


def test_reclaim_records_narrate_and_replay(tmp_path):
    def scenario(side, d):
        jf = d / "rec.jsonl"
        ap = _ap(side, quantum=4, decision_file=str(jf), load_history=False)
        ap.record_reclaim(1, ["jB", "jA"], 8.0)
        ap.record_reclaim(2, ["jC"], 8.0)
        assert ap.reclaims == 3
        return side.autopilot.read_journal(str(jf))

    out = both(tmp_path, scenario)
    recs = same_decisions(out)
    assert recs[0]["inputs"]["jobs"] == ["jA", "jB"]
    line = PORT.autopilot.explain_decision(out[PORT][0])
    assert "fleet.reclaim" in line and "dead_rank=1" in line


def test_checkpoint_cadence_follows_trip_history(tmp_path):
    def scenario(side, d):
        jobs = _jobs(side, 2, steps=400)
        for j in jobs:
            j.checkpoint_every = 32
        ap = _ap(side, quantum=4, adjust_every=1)
        sched, pol = _sched(side, d, jobs, ap, quantum=4)
        sched._admit_pending()
        pol.observe(jobs[0].bucket_key(), 0.04)
        side.telemetry.registry().reset()
        for _ in range(6):
            side.telemetry.observe("dccrg_ckpt_save_seconds", 0.05,
                                   kind="keyframe")
        calm, tripping = jobs
        calm.steps_done = tripping.steps_done = 64
        tripping.trips = [("nan", i) for i in range(8)]
        _tick(sched, ap)
        assert calm.checkpoint_every == 256
        assert tripping.checkpoint_every == 9
        return [r for r in ap.decisions if r["rule"] == "checkpoint.retune"]

    recs = same_decisions(both(tmp_path, scenario))
    assert len(recs) == 2


def test_audit_cadence_warm_then_clean(tmp_path):
    def scenario(side, d):
        ap = _ap(side, quantum=4, audit_every=8, relax_after=2)
        sched, _pol = _sched(side, d, _jobs(side, 2), ap, quantum=4,
                             audit_every=8)
        sched._admit_pending()
        seen = []
        for suspects, n in ((1, 1), (2, 1), (2, 2), (2, 2), (2, 6)):
            sched.suspects[0] = suspects
            _tick(sched, ap, n)
            seen.append(sched.audit_every)
        return list(ap.decisions), seen

    out = both(tmp_path, scenario)
    same_decisions(out, measured=True, key=lambda o: o[0])
    assert out[PORT][1] == out[REF][1] == [4, 2, 4, 8, 8]


def test_audit_cadence_switches_on_from_zero_baseline(tmp_path):
    def scenario(side, d):
        ap = _ap(side, quantum=4, audit_every=0, relax_after=1)
        sched, _pol = _sched(side, d, _jobs(side, 2), ap, quantum=4,
                             audit_every=0)
        sched._admit_pending()
        sched.suspects[0] = 1
        seen = []
        for _ in range(3):
            _tick(sched, ap)
            seen.append(sched.audit_every)
        return list(ap.decisions), seen

    out = both(tmp_path, scenario)
    same_decisions(out, measured=True, key=lambda o: o[0])
    assert out[PORT][1] == [8, 16, 0]


def test_capacity_seeded_from_oom_history(tmp_path, monkeypatch):
    """The journal of an OOM-halving run seeds the next run's bucket,
    in both packages; and a journal written by one package seeds the
    other's (the key ids agree)."""
    def scenario(side, d, journal):
        real = side.fleet.GridBatch.step

        def step(self, budget):
            if self.capacity > 4:
                raise RuntimeError(
                    "RESOURCE_EXHAUSTED: out of memory (injected)")
            return real(self, budget)

        monkeypatch.setattr(side.fleet.GridBatch, "step", step)
        jobs = _jobs(side, 8, steps=10)
        ap1 = _ap(side, quantum=4, decision_file=journal)
        sched1, _ = _sched(side, d / "one", jobs, ap1, quantum=4)
        report = sched1.run()
        kid = side.autopilot.key_id(jobs[0].bucket_key())
        assert ap1.capacity[kid] <= 4
        monkeypatch.setattr(side.fleet.GridBatch, "step", real)
        return report, list(ap1.decisions)

    out = {}
    for side in SIDES:
        side.reset_telemetry()
        out[side] = scenario(side, tmp_path / side.name,
                             str(tmp_path / f"{side.name}.jsonl"))
    assert rows(out[PORT][0]) == rows(out[REF][0])
    same_decisions(out, measured=True, key=lambda o: o[1])
    solo = PORT.solo(_jobs(PORT, 8, steps=10))
    assert {n: r["digest"] for n, r in out[PORT][0].items()} == solo
    # run 2 of each package over the OTHER package's journal
    for side, other in ((PORT, REF), (REF, PORT)):
        ap2 = _ap(side, quantum=4,
                  decision_file=str(tmp_path / f"{other.name}.jsonl"))
        sched2, _ = _sched(side, tmp_path / f"two_{side.name}",
                           _jobs(side, 8, steps=10), ap2, quantum=4)
        sched2._admit_pending()
        caps = [b.capacity for bs in sched2.buckets.values() for b in bs]
        assert caps and all(c <= 4 for c in caps)
        assert any(r["rule"] == "capacity.seed" for r in ap2.decisions)
        if side is PORT:
            report2 = sched2.run()
            assert {n: r["digest"] for n, r in report2.items()} == solo


def test_shed_history_recorded():
    for side in SIDES:
        ap = _ap(side, quantum=4)
        key = _jobs(side, 1)[0].bucket_key()
        ap.record_shed(key, 6)
        ap.record_oom(key, 3)
        ap.record_oom(key, 5)
        assert ap.capacity[side.autopilot.key_id(key)] == 3
        assert [r["inputs"]["event"] for r in ap.decisions] == ["shed", "oom"]


def test_seed_floor_never_strips_a_dmr_shadow(tmp_path):
    def scenario(side, d):
        ap = _ap(side, quantum=4)
        dmr = side.job("dmr0", length=(8, 8, 8), n_steps=8, seed=1,
                       params=(0.03,), checkpoint_every=4, redundancy=2)
        ap.capacity[side.autopilot.key_id(dmr.bucket_key())] = 1
        sched, _pol = _sched(side, d, [dmr], ap, quantum=4)
        sched._admit_pending()
        (batch,) = [b for bs in sched.buckets.values() for b in bs]
        assert batch.capacity >= 2 and batch.shadow_of
        return list(ap.decisions)

    recs = same_decisions(both(tmp_path, scenario), measured=True)
    (rec,) = [r for r in recs if r["rule"] == "capacity.seed"]
    assert rec["after"] == 2 and rec["inputs"]["lo"] == 2


def test_checkpoint_retune_uses_each_buckets_own_latency(tmp_path):
    def scenario(side, d):
        fast = side.job("fastj", length=(8, 8, 8), n_steps=400, seed=1,
                        params=(0.03,), checkpoint_every=64)
        slow = side.job("slowj", length=(12, 12, 12), n_steps=400, seed=2,
                        params=(0.03,), checkpoint_every=64)
        ap = _ap(side, quantum=4, adjust_every=1)
        sched, pol = _sched(side, d, [fast, slow], ap, quantum=4)
        sched._admit_pending()
        side.telemetry.registry().reset()
        side.telemetry.observe("dccrg_ckpt_save_seconds", 0.05,
                               kind="keyframe")
        pol.observe(fast.bucket_key(), 0.004)
        pol.observe(slow.bucket_key(), 0.4)
        for j in (fast, slow):
            j.steps_done = 64
            j.trips = [("nan", i) for i in range(8)]
        _tick(sched, ap)
        assert (fast.checkpoint_every, slow.checkpoint_every) == (28, 3)
        return [r for r in ap.decisions if r["rule"] == "checkpoint.retune"]

    assert len(same_decisions(both(tmp_path, scenario))) == 2


def test_capacity_floor_recovers_after_clean_runs(tmp_path):
    def scenario(side, d):
        journal = str(d / "j.jsonl")
        ap = _ap(side, quantum=4, decision_file=journal)
        key = _jobs(side, 1)[0].bucket_key()
        kid = side.autopilot.key_id(key)
        ap.record_oom(key, 4)
        ap.end_of_run()
        for seeded, recovered in ((4, 8), (8, 16), (16, 16)):
            assert ap.seed_capacity(key, 16) == seeded
            ap.end_of_run()
            assert ap.capacity[kid] == recovered
        ap2 = _ap(side, quantum=4, decision_file=journal)
        assert ap2.capacity[kid] == 16
        assert side.autopilot.replay(side.autopilot.read_journal(journal)) \
            == []
        return side.autopilot.read_journal(journal)

    same_decisions(both(tmp_path, scenario))


def test_quantum_warm_starts_from_journal(tmp_path):
    def scenario(side, d):
        journal = str(d / "j.jsonl")
        ap = _ap(side, quantum=16, decision_file=journal)
        sched, pol = _sched(side, d / "one", _jobs(side, 2, slo_ms=100.0),
                            ap, quantum=16)
        sched._admit_pending()
        for _b, _s, j in sched.active_jobs():
            j.slo_t0 = 0.0
        pol.observe(_jobs(side, 1)[0].bucket_key(), 10.0)
        _tick(sched, ap, 8)
        assert sched.quantum == 1
        ap.end_of_run()
        ap2 = _ap(side, quantum=16, decision_file=journal)
        assert ap2.learned_quantum == 1
        sched2, _ = _sched(side, d / "two", _jobs(side, 2), ap2, quantum=16)
        sched2._admit_pending()
        _tick(sched2, ap2, 1)
        assert sched2.quantum == 1
        j3 = str(d / "j3.jsonl")
        _ap(side, quantum=16, decision_file=j3).end_of_run()
        assert not os.path.exists(j3)
        return side.autopilot.read_journal(journal)

    recs = same_decisions(both(tmp_path, scenario), measured=True)
    assert [(r["before"], r["after"]) for r in recs
            if r["rule"] in ("quantum.learn", "quantum.warm_start")] == \
        [(None, 1), (16, 1)]


def test_checkpoint_retune_prices_measured_rollback_cost(tmp_path):
    def scenario(side, d):
        journal = str(d / "j.jsonl")
        jobs = _jobs(side, 2, steps=400)
        sched, pol = _sched(side, d, jobs, None, quantum=4)
        sched._admit_pending()
        pol.observe(jobs[0].bucket_key(), 0.04)
        side.telemetry.registry().reset()
        ap = _ap(side, quantum=4, adjust_every=1, decision_file=journal)
        sched.autopilot = ap
        for _ in range(6):
            side.telemetry.observe("dccrg_ckpt_save_seconds", 0.05,
                                   kind="keyframe")
        side.telemetry.observe("dccrg_rollback_seconds", 0.4)
        side.telemetry.observe("dccrg_rollback_seconds", 0.4)
        jobs[0].steps_done = 64
        jobs[0].trips = [("nan", i) for i in range(8)]
        _tick(sched, ap)
        assert jobs[0].checkpoint_every == round((2 * 5 * (8 + 40)) ** 0.5)
        return side.autopilot.read_journal(journal)

    recs = same_decisions(both(tmp_path, scenario))
    assert recs and all(abs(r["inputs"]["rollback_s"] - 0.4) < 1e-9
                        for r in recs if r["rule"] == "checkpoint.retune")


# ---------------------------------------------------------------------
# the negative pin, the env opt-in, and the journal
# ---------------------------------------------------------------------

def test_off_by_default_negative_pin(tmp_path):
    def scenario(side, d):
        jobs = _jobs(side, 4)
        plan = side.faults.FaultPlan(seed=3)
        plan.nan_poison("rho", step=7, job="a01")
        sched, _pol = _sched(side, d, jobs, quantum=4, audit_every=2)
        assert sched.autopilot is None
        with plan:
            report = sched.run()
        assert sched.quantum == 4 and sched.audit_every == 2
        assert all(j.checkpoint_every == 4 for j in jobs)
        assert side.telemetry.registry().counter_total(
            "dccrg_autopilot_decisions_total") == 0
        assert [f for f in os.listdir(d)
                if "decision" in f or "status" in f] == []
        return report

    out = both(tmp_path, scenario)
    assert rows(out[PORT]) == rows(out[REF])
    assert out[PORT]["a01"]["trips"] == 1
    assert {n: r["digest"] for n, r in out[PORT].items()} == \
        PORT.solo(_jobs(PORT, 4))


def test_autopilot_on_preserves_results(tmp_path, monkeypatch):
    """DCCRG_AUTOPILOT=1: the scheduler builds the controller, the run
    journals its decisions, every digest is still the port's run_solo,
    the status file is written, and the journal replays with zero
    divergence in both packages (the decisions themselves follow the
    host's measured latencies, so they are not compared)."""
    journal = str(tmp_path / "decisions.jsonl")
    status = str(tmp_path / "status.txt")
    monkeypatch.setenv("DCCRG_AUTOPILOT", "1")
    monkeypatch.setenv("DCCRG_DECISION_FILE", journal)
    monkeypatch.setenv("DCCRG_STATUS_FILE", status)
    plan = PORT.faults.FaultPlan(seed=5)
    plan.nan_poison("rho", step=9, job="a02")
    sched, _pol = _sched(PORT, tmp_path, _jobs(PORT, 4, steps=24), quantum=4)
    assert sched.autopilot is not None
    with plan:
        report = sched.run()
    assert all(r["status"] == "done" for r in report.values())
    assert {n: r["digest"] for n, r in report.items()} == \
        PORT.solo(_jobs(PORT, 4, steps=24))
    text = open(status).read()
    assert "quantum=" in text and "suspects:" in text and "buckets:" in text
    recs = PORT.autopilot.read_journal(journal)
    assert PORT.autopilot.replay(recs) == []
    assert REF.autopilot.replay(REF.autopilot.read_journal(journal)) == []


def _synth_journal(side, d, n=6):
    journal = str(d / "j.jsonl")
    jobs = _jobs(side, 2, slo_ms=100.0)
    sched, pol = _sched(side, d, jobs, None, quantum=16)
    sched._admit_pending()
    for j in jobs:
        j.slo_t0 = 0.0
    pol.observe(jobs[0].bucket_key(), 10.0)
    sched.suspects[0] = 1
    side.telemetry.registry().reset()
    ap = _ap(side, quantum=16, decision_file=journal)
    sched.autopilot = ap
    side.telemetry.observe("dccrg_ckpt_save_seconds", 0.05, kind="keyframe")
    _tick(sched, ap, n)
    ap.record_oom(jobs[0].bucket_key(), 4)
    assert ap.seq >= 3
    return journal, ap


def test_journal_replays_across_packages(tmp_path):
    """The fake-clock journal is the same record for record in both
    packages; each package's replay reads the other's journal with zero
    divergence, and flags the same tampering."""
    out = both(tmp_path, _synth_journal)
    recs = {s: s.autopilot.read_journal(out[s][0]) for s in SIDES}
    assert decisions(recs[PORT]) == decisions(recs[REF])
    assert len(recs[PORT]) == out[PORT][1].seq == len(out[PORT][1].decisions)
    for reader in SIDES:
        for writer in SIDES:
            assert reader.autopilot.replay(recs[writer]) == []
    bad = [dict(r) for r in recs[PORT]]
    bad[0]["after"] = 999
    bad[1]["rule"] = "quantum.noSuchRule"
    got = [[why for _r, why in s.autopilot.replay(bad)] for s in SIDES]
    assert got[0] == got[1] and len(got[0]) == 2 and "re-derived" in got[0][0]
    merged = PORT.autopilot.merge_journals([out[PORT][0], out[REF][0]])
    assert len(merged) == 2 * len(recs[PORT])


def test_journal_is_deterministic(tmp_path):
    j1, _ = _synth_journal(PORT, tmp_path / "one")
    j2, _ = _synth_journal(PORT, tmp_path / "two")
    assert decisions(PORT.autopilot.read_journal(j1)) == \
        decisions(PORT.autopilot.read_journal(j2))


def test_explain_and_replay_cli(tmp_path, capsys):
    journal, ap = _synth_journal(PORT, tmp_path)
    assert PORT.autopilot._main(["explain", journal]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[tick")]
    assert len(lines) == ap.seq
    assert any("quantum.shorten" in ln and "observed:" in ln
               and "expected:" in ln for ln in lines)
    assert PORT.autopilot._main(["replay", journal]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == \
        {"decisions": ap.seq, "divergences": 0}
    recs = PORT.autopilot.read_journal(journal)
    recs[-1]["after"] = -5
    broken = str(tmp_path / "broken.jsonl")
    with open(broken, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    assert PORT.autopilot._main(["replay", broken]) == 1
    assert "DIVERGED" in capsys.readouterr().out


def test_decision_ring_bounded():
    ap = _ap(PORT, quantum=4, ring=16, decision_file=None)
    for i in range(50):
        ap._learn_capacity(("k",), 50 - i, "oom")
    assert ap.seq == 50 and len(ap.decisions) == 16
    assert ap.decisions[-1]["seq"] == 49


def test_save_rollback_audit_metrics_and_lane_gauges(tmp_path):
    def scenario(side, d):
        plan = side.faults.FaultPlan(seed=11)
        plan.nan_poison("rho", step=6, job="a01")
        plan.silent_flip("rho", step=10, job="a03")
        sched, _pol = _sched(side, d, _jobs(side, 4, steps=16), quantum=4,
                             audit_every=2)
        with plan:
            report = sched.run()
        reg = side.telemetry.registry()
        h = reg.histogram("dccrg_ckpt_save_seconds", kind="keyframe")
        assert h is not None and h.total > 0 and h.sum_seconds > 0
        assert reg.histogram("dccrg_rollback_seconds").total >= 2
        assert reg.histogram("dccrg_audit_seconds").total >= 1
        assert reg.gauges[("dccrg_lane_suspects", (("lane", "0"),))] >= 1.0
        assert ("dccrg_lane_quarantined", (("lane", "0"),)) in reg.gauges
        return (report, h.total, reg.histogram("dccrg_rollback_seconds").total,
                reg.gauges[("dccrg_lane_suspects", (("lane", "0"),))])

    out = both(tmp_path, scenario)
    assert rows(out[PORT][0]) == rows(out[REF][0])
    assert out[PORT][1:] == out[REF][1:]


def test_controller_baselines_preexisting_registry_history(tmp_path):
    def scenario(side, d):
        sched, _pol = _sched(side, d, _jobs(side, 2), None, quantum=8)
        sched._admit_pending()
        side.telemetry.inc("dccrg_fleet_trips_total", 50, job="old")
        side.telemetry.observe("dccrg_ckpt_save_seconds", 100.0,
                               kind="keyframe")
        ap = _ap(side, quantum=8)
        sched.autopilot = ap
        side.telemetry.observe("dccrg_ckpt_save_seconds", 0.25, kind="delta")
        side.telemetry.observe("dccrg_ckpt_save_seconds", 9.0,
                               kind="emergency")
        inp = ap.tick(sched)
        assert inp["trip_rate"] == 0.0
        assert inp["save_cost_s"] == pytest.approx(0.25)
        assert not any(r["rule"] == "quantum.shorten" for r in ap.decisions)
        return inp

    out = both(tmp_path, scenario)
    assert out[PORT] == out[REF]


def test_injected_autopilot_never_stomps_configured_knobs(tmp_path):
    for side in SIDES:
        ap = _ap(side)
        sched, pol = _sched(side, tmp_path / side.name, _jobs(side, 2), ap,
                            quantum=4, audit_every=6)
        sched._admit_pending()
        _tick(sched, ap, 3)
        assert ap.seq == 0
        assert (sched.quantum, sched.audit_every, pol.quantum) == (4, 6, 4)


def test_skipped_audit_not_counted_as_performed(tmp_path, monkeypatch):
    for side in SIDES:
        sched, _pol = _sched(side, tmp_path / side.name, _jobs(side, 2, 8),
                             quantum=4, audit_every=1)
        sched._admit_pending()
        monkeypatch.setattr(side.scheduler.FleetScheduler, "_audit_digests",
                            lambda self, *a: None)
        report = sched.run()
        assert all(r["status"] == "done" for r in report.values())
        assert sched.audits == 0
        reg = side.telemetry.registry()
        assert reg.counter_total("dccrg_audits_total") == 0
        assert reg.histogram("dccrg_audit_seconds") is None


# ---------------------------------------------------------------------
# the controller inputs offline: the telemetry summary of histograms
# ---------------------------------------------------------------------

def test_telemetry_summary_covers_histograms(tmp_path, capsys):
    """``python -m dccrg_tpu_torch.telemetry summary`` over a metrics
    file prints each histogram's p50/p99 (the numbers the controller
    acts on), parsed back from the exposition, equal to the live
    registry's and to the reference's summary of the same file."""
    out = {}
    for side in SIDES:
        tel = side.telemetry
        for v in (0.002, 0.004, 0.008, 0.3):
            tel.observe("dccrg_ckpt_save_seconds", v, kind="keyframe")
        tel.observe("dccrg_fleet_quantum_seconds", 0.05, job="a")
        live = tel.histogram_stats()
        path = str(tmp_path / f"{side.name}.prom")
        assert tel.export_metrics(path)
        offline = tel.histogram_stats(
            tel.parse_prometheus_histograms(open(path).read()))
        key = 'dccrg_ckpt_save_seconds{kind="keyframe"}'
        assert offline[key]["count"] == 4
        assert offline[key]["p99_s"] == pytest.approx(live[key]["p99_s"])
        assert tel._main(["summary", path]) == 0
        out[side] = json.loads(capsys.readouterr().out)
    assert out[PORT] == out[REF]
    assert 'dccrg_fleet_quantum_seconds{job="a"}' in out[PORT]["histograms"]


def test_summary_sums_per_rank_metrics_files(tmp_path, capsys):
    """Per-rank metrics files of one run sum per series, a label holding
    a backslash and an n included, as the reference sums them."""
    out = {}
    tricky = "a\\nb"
    for side in SIDES:
        tel = side.telemetry
        paths = []
        for rank, vals in enumerate([(0.002, 0.004), (0.004, 0.3)]):
            tel.registry().reset()
            for v in vals:
                tel.observe("dccrg_step_seconds", v)
                tel.observe("dccrg_fleet_quantum_seconds", v, job=tricky)
            p = str(tmp_path / f"{side.name}_r{rank}.prom")
            assert tel.export_metrics(p)
            paths.append(p)
        tel.registry().reset()
        assert tel._main(["summary", *paths]) == 0
        out[side] = json.loads(capsys.readouterr().out)
    assert out[PORT] == out[REF]
    h = out[PORT]["histograms"]["dccrg_step_seconds"]
    assert h["count"] == 4 and h["p99_s"] >= 0.3
    (k,) = [k for k in out[PORT]["histograms"]
            if k.startswith("dccrg_fleet_quantum_seconds")]
    assert out[PORT]["histograms"][k]["count"] == 4
