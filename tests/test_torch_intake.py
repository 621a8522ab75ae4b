"""The port's streaming intake (dccrg_tpu_torch.intake) against the
reference's, on the CPU.

Each case of tests/test_intake.py runs here on both packages with the
same spool rows, fault plans, fake clock and in-memory KV
(tests/torch_sched_fixture.py: the reference schedules on its default
device, the port on the CPU with the table program). What each run
decides must be equal: pump stats and counters, admissions,
quarantines with their reason records, sheds, gate flips, the spool's
directories and the KV's keys after the run, and the autopilot
journal record for record (replayable by either package). Each
package's finished jobs digest equal to its own ``run_solo``: the
intake changes when a job runs, never what it computes.
"""

import json
import os

import pytest

from torch_sched_fixture import PORT, REF, SIDES, both

from dccrg_tpu import intake as r_intake
from dccrg_tpu_torch import intake as p_intake

INTAKE = {REF: r_intake, PORT: p_intake}

pytestmark = pytest.mark.intake


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("DCCRG_INTAKE", "DCCRG_INTAKE_SPOOL",
                "DCCRG_INTAKE_RETRIES", "DCCRG_INTAKE_BACKOFF_S",
                "DCCRG_INTAKE_BACKOFF_CAP_S", "DCCRG_INTAKE_AGE_S",
                "DCCRG_TENANT_RATE", "DCCRG_TENANT_WEIGHT",
                "DCCRG_TENANT_BURST", "DCCRG_AUTOPILOT",
                "DCCRG_DECISION_FILE"):
        monkeypatch.delenv(var, raising=False)
    for side in SIDES:
        side.reset_telemetry()
    yield
    for side in SIDES:
        side.reset_telemetry()


def _row(name, steps=4, **kw):
    d = {"name": name, "n": 8, "steps": steps, "checkpoint_every": 4}
    d.update(kw)
    return d


class _Env:
    """One package's spool + shared KV + fake clock + N (intake,
    scheduler) pairs: tests/test_intake.py's in-process fleet."""

    def __init__(self, side, d, ranks=1, **intake_kw):
        self.side = side
        self.mod = INTAKE[side]
        self.spool = str(d / "spool")
        self.kv = side.coord.InMemoryKV()
        self.t = [0.0]
        self.pairs = []
        kw = dict(lease_s=1.0, window_s=0.5, poll_s=0.0,
                  backoff_s=0.01, backoff_cap_s=0.05)
        kw.update(intake_kw)
        for r in range(ranks):
            it = self.mod.StreamIntake(self.spool, kv=self.kv, rank=r,
                                       clock=lambda: self.t[0], **kw)
            sched = side.sched(d / f"ck{r}", quantum=4, intake=it)
            self.pairs.append((it, sched))

    def submit(self, row, **kw):
        return self.mod.submit(self.spool, row, **kw)

    def tick(self, dt=0.1):
        self.t[0] += dt

    def layout(self):
        """The spool's files by directory and the KV's keys."""
        out = {}
        for root, _dirs, files in os.walk(self.spool):
            rel = os.path.relpath(root, self.spool)
            out[rel] = sorted(files)
        return out, sorted(self.side.coord.prefix_census(self.kv, "dccrg"))


def _stats(it):
    return {k: getattr(it, k) for k in ("admitted", "deduped", "quarantined",
                                         "shed", "reclaimed", "gate",
                                         "gate_transitions")}


def _count(side, name, **labels):
    return side.telemetry.registry().counter_total(name, **labels)


def _digest_is_solo(side, report, name, **kw):
    job = side.fleet.job_from_row(_row(name, **kw))
    assert report[name]["digest"] == side.solo([job])[name]


def _same(out):
    assert out[PORT] == out[REF]
    return out[PORT]


# -- exactly-once admission ------------------------------------------

def test_submit_pump_run_admits_exactly_once(tmp_path):
    def scenario(side, d):
        env = _Env(side, d)
        it, sched = env.pairs[0]
        env.submit(_row("j1"), tenant="acme")
        first = it.pump()
        env.tick()
        report = sched.run(max_ticks=100)
        env.tick()
        it.pump()
        assert it.idle() and not it.leases.owned
        _digest_is_solo(side, report, "j1")
        return (first, report["j1"]["status"], env.layout(),
                env.kv.get("dccrg/intake/done/j1"),
                env.kv.get("dccrg/intake/journal/j1"),
                _count(side, "dccrg_intake_admitted_total", tenant="acme"))

    first, status, (files, _kv), done, journal, n = _same(both(tmp_path,
                                                              scenario))
    assert first["admitted"] == 1 and status == "done"
    assert files["admitted"] == ["j1.json"]
    assert done == "admitted:0" and journal is None and n == 1


def test_duplicate_name_resubmission_deduped_by_done_marker(tmp_path):
    def scenario(side, d):
        env = _Env(side, d)
        it, sched = env.pairs[0]
        env.submit(_row("j1"))
        it.pump()
        sched.run(max_ticks=100)
        env.tick()
        it.pump()
        env.submit(_row("j1"))
        env.tick()
        return it.pump(), _stats(it), env.layout()

    stats, counts, _layout = _same(both(tmp_path, scenario))
    assert stats["admitted"] == 0 and counts["deduped"] == 1


def test_same_content_different_name_deduped_by_nonce(tmp_path):
    def scenario(side, d):
        env = _Env(side, d)
        it, sched = env.pairs[0]
        nonce = env.mod.record_nonce(_row("j1"), "default")
        env.submit(_row("j1"), nonce=nonce)
        env.submit(_row("j2"), nonce=nonce)
        it.pump()
        return nonce, _stats(it), sorted(sched._by_name), env.layout()

    nonce, counts, names, _layout = _same(both(tmp_path, scenario))
    assert counts["admitted"] == 1 and counts["deduped"] == 1
    assert names == ["j1"]
    assert nonce == r_intake.record_nonce(_row("j1"), "default")


def test_kill_between_claim_and_add_reclaimed_exactly_once(tmp_path):
    def scenario(side, d):
        env = _Env(side, d, ranks=2)
        it0, _s0 = env.pairs[0]
        it1, s1 = env.pairs[1]
        env.submit(_row("j1"))
        plan = side.faults.FaultPlan()
        plan.intake_death(rank=0)
        with plan:
            with pytest.raises(side.faults.InjectedRankDeath):
                it0.pump()
        half = (env.kv.get("dccrg/intake/j1") is not None,
                env.kv.get("dccrg/intake/journal/j1") is not None,
                "j1" in s1._by_name)
        it1.pump()
        early = (it1.reclaimed, "j1" in s1._by_name)
        env.tick(1.5)
        stats = it1.pump()
        report = s1.run(max_ticks=200)
        env.tick()
        it1.pump()
        _digest_is_solo(side, report, "j1")
        return (half, early, stats, report["j1"]["status"],
                env.kv.get("dccrg/intake/done/j1"), it1.idle(),
                _stats(it1), env.layout())

    out = _same(both(tmp_path, scenario))
    assert out[0] == (True, True, False) and out[1] == (0, False)
    assert out[2]["reclaimed"] == 1 and out[3] == "done"
    assert out[4] == "admitted:1" and out[5] and out[6]["admitted"] == 1


def test_reclaim_respects_membership_liveness(tmp_path):
    def scenario(side, d):
        coord, mod = side.coord, INTAKE[side]
        kv = coord.InMemoryKV()
        t = [0.0]
        clock = lambda: t[0]  # noqa: E731
        m0 = coord.Membership(0, 2, kv=kv, clock=clock, heartbeat_s=0.25,
                              lease_s=2.0)
        m1 = coord.Membership(1, 2, kv=kv, clock=clock, heartbeat_s=0.25,
                              lease_s=2.0)
        m0.heartbeat(force=True)
        m1.heartbeat(force=True)
        m1.poll(timeout=0.05)
        spool = str(d / "spool")
        mod.submit(spool, _row("j1"))
        it0 = mod.StreamIntake(spool, kv=kv, rank=0, clock=clock,
                               membership=m0, lease_s=0.5, poll_s=0.0)
        side.sched(d / "ck0", quantum=4, intake=it0)
        it1 = mod.StreamIntake(spool, kv=kv, rank=1, clock=clock,
                               membership=m1, lease_s=0.5, poll_s=0.0)
        side.sched(d / "ck1", quantum=4, intake=it1)
        plan = side.faults.FaultPlan()
        plan.intake_death(rank=0)
        with plan:
            with pytest.raises(side.faults.InjectedRankDeath):
                it0.pump()
        it1.pump()
        t[0] += 0.7
        m1.poll(timeout=0.05)
        seen = [(m1.state(0), it1.pump()["reclaimed"])]
        t[0] += 2.0
        m1.poll(timeout=0.05)
        seen.append((m1.state(0), it1.pump()["reclaimed"]))
        return seen, [s == coord.Membership.DEAD for s, _n in seen]

    seen, dead = _same(both(tmp_path, scenario))
    assert [n for _s, n in seen] == [0, 1] and dead == [False, True]


# -- retry envelope + poison quarantine ------------------------------

def _reason(spool, name):
    with open(os.path.join(spool, "quarantine", f"{name}.reason.json")) as f:
        return json.load(f)


def test_torn_spool_record_quarantined_with_reason(tmp_path):
    def scenario(side, d):
        env = _Env(side, d, retries=3)
        it, sched = env.pairs[0]
        plan = side.faults.FaultPlan()
        plan.spool_torn_write(job="poison")
        with plan:
            env.submit(_row("poison"))
        env.submit(_row("good"))
        for _ in range(12):
            it.pump()
            env.tick(0.1)
        report = sched.run(max_ticks=100)
        _digest_is_solo(side, report, "good")
        reason = _reason(env.spool, "poison")
        # the error text names the package's own error classes
        reason["error"] = reason["error"].split(" (last:")[0]
        return (_stats(it), reason, report["good"]["status"],
                _count(side, "dccrg_intake_quarantined_total"),
                _count(side, "dccrg_intake_retries_total"), env.layout())

    counts, reason, status, nq, _nr, (files, _kv) = _same(
        both(tmp_path, scenario))
    assert counts["quarantined"] == 1 and nq == 1 and status == "done"
    assert reason["attempts"] == 3
    assert reason["error_type"] == "IntakeRetryExhausted"
    assert files["quarantine"] == ["poison.json", "poison.reason.json"]


def test_transient_io_fault_retries_then_admits(tmp_path):
    def scenario(side, d):
        env = _Env(side, d, retries=4)
        it, sched = env.pairs[0]
        env.submit(_row("j1"))
        plan = side.faults.FaultPlan()
        plan.spool_io_error(times=2, job="j1")
        with plan:
            for _ in range(10):
                it.pump()
                env.tick(0.1)
        report = sched.run(max_ticks=100)
        return (_stats(it), _count(side, "dccrg_intake_retries_total"),
                report["j1"]["status"])

    counts, retries, status = _same(both(tmp_path, scenario))
    assert counts["quarantined"] == 0 and counts["admitted"] == 1
    assert retries == 2 and status == "done"


def test_unknown_kernel_is_typed_poison(tmp_path):
    def scenario(side, d):
        env = _Env(side, d)
        it, _sched = env.pairs[0]
        env.submit(_row("bad", kernel="no-such-kernel"))
        it.pump()
        return _stats(it), _reason(env.spool, "bad")

    counts, reason = _same(both(tmp_path, scenario))
    assert counts["quarantined"] == 1
    assert reason["error_type"] == "UnknownKernelError"
    assert reason["attempts"] == 1 and "no-such-kernel" in reason["error"]


def test_malformed_row_is_typed_poison(tmp_path):
    def scenario(side, d):
        env = _Env(side, d)
        it, _sched = env.pairs[0]
        payload = {"job": {"n": 8}, "tenant": "default", "nonce": "x1"}
        sealed = side.coord.seal_record(json.dumps(payload, sort_keys=True))
        with open(os.path.join(env.spool, "noname.json"), "w") as f:
            f.write(sealed)
        it.pump()
        return _stats(it), _reason(env.spool, "noname")["error_type"]

    counts, kind = _same(both(tmp_path, scenario))
    assert counts["quarantined"] == 1 and kind == "JobSpecError"


def test_torn_rename_never_becomes_visible(tmp_path):
    def scenario(side, d):
        env = _Env(side, d)
        it, _sched = env.pairs[0]
        plan = side.faults.FaultPlan()
        plan.spool_torn_rename(job="ghost")
        with plan:
            env.submit(_row("ghost"))
        return (os.path.exists(os.path.join(env.spool, "ghost.json")),
                it.pump(), env.layout())

    visible, stats, (files, _kv) = _same(both(tmp_path, scenario))
    assert not visible and stats["backlog"] == 0
    assert files[".tmp"] == ["ghost.json"]


def test_delayed_directory_visibility_heals_next_scan(tmp_path):
    def scenario(side, d):
        env = _Env(side, d)
        it, _sched = env.pairs[0]
        env.submit(_row("late"))
        plan = side.faults.FaultPlan()
        plan.spool_delay(rank=0)
        with plan:
            first = it.pump()["admitted"]
        env.tick()
        return first, it.pump()["admitted"]

    assert _same(both(tmp_path, scenario)) == (0, 1)


# -- backpressure gate + graceful shed -------------------------------

def _gate_inputs(ratio, age=0.0, **kw):
    d = {"ratio": ratio, "queue_age_s": age, "hi": 1.2, "lo": 0.9,
         "age_bound_s": 30.0}
    d.update(kw)
    return d


def test_gate_rule_hysteresis_band():
    cases = [(0, _gate_inputs(1.3)), (1, _gate_inputs(1.0)),
             (0, _gate_inputs(1.0)), (1, _gate_inputs(0.8)),
             (0, _gate_inputs(None, age=45.0)), (1, _gate_inputs(None, age=1.0)),
             (0, _gate_inputs(0.5))]
    out = {side: [side.autopilot.RULES["intake.backpressure"](g, dict(i))
                  for g, i in cases] for side in SIDES}
    assert _same(out) == [1, None, None, 0, 1, 0, None]


def test_gate_evaluates_once_per_window(tmp_path):
    def scenario(side, d):
        env = _Env(side, d, window_s=1.0, hi_ratio=1.2, lo_ratio=0.9)
        it, _sched = env.pairs[0]
        it.pump()
        for ratio_num in (10.0, 0.1, 10.0, 0.1):
            it.arrival.value = ratio_num
            it.drain.value = 1.0
            env.tick(0.01)
            it.pump()
        trail = [it.gate_transitions]
        env.tick(1.1)
        it.arrival.value = 10.0
        it.drain.value = 1.0
        it.pump()
        trail.append((it.gate, it.gate_transitions))
        env.tick(1.1)
        it.arrival.value = 0.1
        it.drain.value = 1.0
        it.pump()
        trail.append((it.gate, it.gate_transitions))
        return trail

    trail = _same(both(tmp_path, scenario))
    assert trail[0] <= 1 and trail[1:] == [(1, 1), (0, 2)]


def test_closed_gate_pauses_admission_until_reopen(tmp_path):
    def scenario(side, d):
        env = _Env(side, d, window_s=0.5)
        it, sched = env.pairs[0]
        it.pump()
        it.arrival.value = 10.0
        it.drain.value = 1.0
        env.tick(0.6)
        it.pump()
        closed = it.gate
        env.submit(_row("j1"))
        env.submit(_row("j2"))
        env.tick(0.01)
        paused = (it.pump()["admitted"], it.backlog())
        it.arrival.value = 0.1
        env.tick(0.6)
        stats = it.pump()
        report = sched.run(max_ticks=200)
        for n in ("j1", "j2"):
            _digest_is_solo(side, report, n)
        return (closed, paused, it.gate, stats["admitted"],
                {n: r["status"] for n, r in report.items()})

    closed, paused, gate, admitted, status = _same(both(tmp_path, scenario))
    assert closed == 1 and paused == (0, 2) and gate == 0 and admitted == 2
    assert status == {"j1": "done", "j2": "done"}


def _decisions(ap):
    return [{k: v for k, v in r.items() if k != "ts"} for r in ap.decisions]


def test_saturation_shed_is_journaled_and_resubmittable(tmp_path):
    def scenario(side, d):
        ap = side.autopilot.Autopilot(quantum=4, clock=lambda: 0.0)
        env = _Env(side, d, window_s=0.5, age_bound_s=2.0)
        it, _sched = env.pairs[0]
        it.autopilot = ap
        it.pump()
        it.arrival.value = 10.0
        it.drain.value = 1.0
        env.tick(0.6)
        it.pump()
        for i in range(6):
            env.submit(_row(f"big{i}"), tenant="whale")
        env.submit(_row("small0"), tenant="minnow")
        it.arrival.value = 10.0
        it.drain.value = 1.0
        env.tick(0.6)
        it.pump()
        sdir = os.path.join(env.spool, "shed")
        shed_files = sorted(os.listdir(sdir))
        with open(os.path.join(sdir, shed_files[0])) as f:
            payload = json.loads(side.coord.unseal_record(f.read()))
        assert side.autopilot.replay(list(ap.decisions)) == []
        return (it.gate, it.shed, shed_files, env.layout(),
                payload["job"]["name"], _decisions(ap))

    gate, shed, files, _layout, name, recs = _same(both(tmp_path, scenario))
    assert gate == 1 and shed > 0 and all(f.startswith("big") for f in files)
    assert name == files[0][:-5]
    shed_recs = [r for r in recs if r["rule"] == "intake.shed"]
    assert len(shed_recs) == 1 and shed_recs[0]["inputs"]["tenant"] == "whale"


# -- tenant shaping ---------------------------------------------------

def test_token_bucket_caps_tenant_rate(tmp_path):
    def scenario(side, d):
        env = _Env(side, d, rates={"*": 1.0}, burst=2.0)
        it, _sched = env.pairs[0]
        for i in range(5):
            env.submit(_row(f"j{i}"))
        seen = [it.pump()["admitted"]]
        env.tick(0.2)
        seen.append(it.pump()["admitted"])
        env.tick(1.0)
        seen.append(it.pump()["admitted"])
        return seen, _count(side, "dccrg_intake_throttled_total") > 0

    assert _same(both(tmp_path, scenario)) == ([2, 0, 1], True)


def test_weighted_fairness_orders_tenants(tmp_path):
    def scenario(side, d):
        env = _Env(side, d, weights={"gold": 3.0, "*": 1.0}, max_admit=8)
        it, sched = env.pairs[0]
        for i in range(8):
            env.submit(_row(f"g{i}"), tenant="gold")
            env.submit(_row(f"b{i}"), tenant="bronze")
        it.pump()
        return sorted(sched._by_name)

    names = _same(both(tmp_path, scenario))
    assert sum(n.startswith("g") for n in names) == 6
    assert sum(n.startswith("b") for n in names) == 2


# -- control-plane + telemetry ---------------------------------------

def test_decisions_replay_divergence_free_end_to_end(tmp_path):
    def scenario(side, d):
        journal = d / "decisions.jsonl"
        ap = side.autopilot.Autopilot(quantum=4, clock=lambda: 0.0,
                                      decision_file=str(journal))
        env = _Env(side, d, window_s=0.5, age_bound_s=2.0)
        it, _sched = env.pairs[0]
        it.autopilot = ap
        env.submit(_row("bad", kernel="no-such-kernel"))
        for i in range(5):
            env.submit(_row(f"j{i}"))
        it.pump()
        it.arrival.value = 10.0
        it.drain.value = 0.5
        for i in range(5, 11):
            env.submit(_row(f"j{i}"))
        env.tick(0.6)
        it.pump()
        it.arrival.value = 0.0
        env.tick(0.6)
        it.pump()
        return str(journal), _decisions(ap)

    out = both(tmp_path, scenario)
    recs = _same({s: o[1] for s, o in out.items()})
    rules = [r["rule"] for r in recs]
    assert "intake.quarantine" in rules and "intake.shed" in rules
    assert rules.count("intake.backpressure") == 2
    # each package's journal replays in either package
    for writer in SIDES:
        for reader in SIDES:
            recs = reader.autopilot.read_journal(out[writer][0])
            assert reader.autopilot.replay(recs) == []


def test_queue_age_histogram_and_lag_gauge(tmp_path):
    def scenario(side, d):
        env = _Env(side, d)
        it, _sched = env.pairs[0]
        env.submit(_row("j1"), tenant="acme")
        it.pump()
        env.tick(0.5)
        env.submit(_row("j2"), tenant="acme")
        it.pump()
        reg = side.telemetry.registry()
        h = reg.histogram_total("dccrg_intake_queue_age_seconds",
                                tenant="acme")
        return (h.total, reg.counter_total("dccrg_intake_admitted_total",
                                           tenant="acme"),
                reg.gauges[("dccrg_intake_lag", ())])

    assert _same(both(tmp_path, scenario)) == (2, 2, 0.0)


# -- wiring + negative pins ------------------------------------------

def test_scheduler_without_intake_is_unchanged(tmp_path):
    def scenario(side, d):
        jobs = [side.job("a", length=(8, 8, 8), n_steps=4,
                         checkpoint_every=4)]
        sched = side.sched(d / "ck", jobs, quantum=4)
        report = sched.run(max_ticks=100)
        assert report["a"]["digest"] == side.solo([side.job(
            "a", length=(8, 8, 8), n_steps=4, checkpoint_every=4)])["a"]
        return sched.intake, report["a"]["status"]

    assert _same(both(tmp_path, scenario)) == (None, "done")


def test_env_construction_and_missing_spool(tmp_path, monkeypatch):
    def scenario(side, d):
        mod = INTAKE[side]
        monkeypatch.setenv("DCCRG_INTAKE", "1")
        monkeypatch.delenv("DCCRG_INTAKE_SPOOL", raising=False)
        with pytest.raises(mod.IntakeError):
            side.sched(d / "ck0", quantum=4)
        spool = str(d / "spool")
        monkeypatch.setenv("DCCRG_INTAKE_SPOOL", spool)
        sched = side.sched(d / "ck1", quantum=4)
        assert isinstance(sched.intake, mod.StreamIntake)
        assert sched.intake.sched is sched
        return sched.intake.spool == spool

    assert _same(both(tmp_path, scenario)) is True


def test_run_loop_pumps_arrivals_to_completion(tmp_path):
    def scenario(side, d):
        env = _Env(side, d)
        it, sched = env.pairs[0]
        env.submit(_row("j1"))
        env.submit(_row("j2"))
        report = sched.run(max_ticks=300)
        env.tick()
        it.pump()
        for n in ("j1", "j2"):
            _digest_is_solo(side, report, n)
        return {n: r["status"] for n, r in report.items()}, it.idle()

    assert _same(both(tmp_path, scenario)) == (
        {"j1": "done", "j2": "done"}, True)


# -- job_from_row typed validation -----------------------------------

def test_job_from_row_builds_and_validates():
    out = {}
    for side in SIDES:
        job = side.fleet.job_from_row({"name": "x", "n": 8, "steps": 3,
                                       "kernel": "diffuse"})
        out[side] = (job.name, job.n_steps, job.length, job.bucket_key())
    assert _same(out)[:3] == ("x", 3, (8, 8, 8))


def test_job_from_row_typed_errors():
    for side in SIDES:
        f = side.fleet
        with pytest.raises(f.JobSpecError):
            f.job_from_row("not a dict")
        with pytest.raises(f.JobSpecError):
            f.job_from_row({"n": 8})
        with pytest.raises(f.JobSpecError):
            f.job_from_row({"name": "x", "length": "wat"})
        job = f.job_from_row({"name": "x", "n": 8, "kernel": "nope"})
        with pytest.raises(f.UnknownKernelError) as ei:
            job.resolved_kernel()
        assert "nope" in str(ei.value) and isinstance(ei.value, KeyError)
        with pytest.raises(f.UnknownKernelError):
            f.job_from_row({"name": "x", "n": 8, "kernel": "nope"},
                           validate_kernel=True)


def test_submit_rejects_unsafe_rows(tmp_path):
    for side in SIDES:
        mod = INTAKE[side]
        with pytest.raises(side.fleet.JobSpecError):
            mod.submit(str(tmp_path / side.name), {"n": 8})
        with pytest.raises(side.fleet.JobSpecError):
            mod.submit(str(tmp_path / side.name), {"name": "../escape"})


def test_spool_records_are_byte_equal(tmp_path):
    """A record submitted by either package is the same sealed bytes,
    and each package admits the other's."""
    paths = {side: INTAKE[side].submit(str(tmp_path / side.name),
                                       _row("j1"), tenant="acme")
             for side in SIDES}
    raw = {side: open(p).read() for side, p in paths.items()}
    assert raw[PORT] == raw[REF]
    for side in SIDES:
        payload = json.loads(side.coord.unseal_record(raw[side]))
        assert payload["nonce"] == p_intake.record_nonce(_row("j1"), "acme")
