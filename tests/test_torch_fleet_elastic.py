"""The port's elastic fleet (membership, job leases, reclaim) against
the reference's, on the CPU.

The sixteen cases of tests/test_fleet_elastic.py, in one process with
fake clocks and one ``coord.InMemoryKV`` shared by in-process ranks: the
lease and fencing edge cases run the same sequence on both packages'
``JobLeases`` and must agree at every step; the two-scheduler flows run
on both packages (tests/torch_sched_fixture.py) and must reach the same
reports, the same lease owners and the same reclaims, with every port
digest its own ``run_solo`` bit for bit (victims included).
"""

import glob
import hashlib
import os
import time

import pytest

from torch_sched_fixture import PORT, REF, SIDES, rows


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("DCCRG_RANK_AWARE", "DCCRG_HEARTBEAT_S", "DCCRG_LEASE_S",
                "DCCRG_INTEGRITY", "DCCRG_BULK"):
        monkeypatch.delenv(var, raising=False)
    prev = {s: s.coord.set_membership(None) for s in SIDES}
    for side in SIDES:
        side.reset_telemetry()
    yield
    for side in SIDES:
        side.coord.set_membership(prev[side])
        side.reset_telemetry()


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


def _jobs(side, count=4, steps=8):
    return [side.job(f"ej{i}", length=(8, 8, 8), n_steps=steps,
                     params=(0.05,), seed=11 * i, checkpoint_every=2)
            for i in range(count)]


def _pair(side, d, kv, clock, count=4, steps=8, n_ranks=2, quantum=2):
    scheds = []
    for rank in range(n_ranks):
        m = side.coord.Membership(rank, n_ranks, kv=kv, heartbeat_s=1.0,
                                  lease_s=4.0, clock=clock)
        scheds.append(side.sched(d / "store", _jobs(side, count, steps),
                                 quantum=quantum, membership=m))
    return scheds


def _tick(sched):
    sched.run(max_ticks=sched.ticks + 1)


def _leases(side, n, clk):
    kv = side.coord.InMemoryKV()
    return kv, [side.scheduler.JobLeases(kv, r, lease_s=4.0, clock=clk)
                for r in range(n)]


def _both(fn):
    """``fn(side)`` on both packages; their results must be equal."""
    out = {s: fn(s) for s in SIDES}
    assert out[PORT] == out[REF]
    return out[PORT]


# -- membership -------------------------------------------------------

def test_membership_classification_and_gauges():
    def run(side):
        kv, clk = side.coord.InMemoryKV(), FakeClock()
        a = side.coord.Membership(0, 2, kv=kv, heartbeat_s=1.0, lease_s=4.0,
                                  clock=clk)
        b = side.coord.Membership(1, 2, kv=kv, heartbeat_s=1.0, lease_s=4.0,
                                  clock=clk)
        a.heartbeat(force=True)
        b.heartbeat(force=True)
        seen = [a.poll()]
        for dt in (2.5, 2.0):
            clk.advance(dt)
            seen.append(a.poll())
        seen += [a.dead_ranks(), a.live_ranks(), a.detect_dead_ranks()]
        b.heartbeat(force=True)
        seen += [a.poll(), a.live_ranks()]
        reg = side.telemetry.registry()
        seen += [reg.gauges[("dccrg_fleet_membership", (("state", s),))]
                 for s in ("live", "dead")]
        seen.append(reg.counter_value(
            "dccrg_fleet_membership_transitions_total", rank="1",
            state="dead"))
        return seen

    assert _both(run) == [{1: "live"}, {1: "suspect"}, {1: "dead"}, [1], [0],
                          [1], {1: "live"}, [0, 1], 2.0, 0.0, 1]


def test_membership_grace_for_slow_starters():
    def run(side):
        clk = FakeClock(100.0)
        a = side.coord.Membership(0, 2, kv=side.coord.InMemoryKV(),
                                  heartbeat_s=1.0, lease_s=4.0, clock=clk)
        seen = [a.poll()]
        for dt in (3.9, 0.2):
            clk.advance(dt)
            seen.append(a.poll())
        return seen

    assert _both(run) == [{1: "live"}, {1: "suspect"}, {1: "dead"}]


def test_membership_poll_never_blocks():
    class WedgedKV(PORT.coord.InMemoryKV):
        def get(self, key):
            time.sleep(5.0)
            return super().get(key)

    a = PORT.coord.Membership(0, 2, kv=WedgedKV(), heartbeat_s=1.0,
                              lease_s=4.0, clock=FakeClock())
    t0 = time.monotonic()
    assert a.poll(timeout=0.05) == {1: "live"}
    assert time.monotonic() - t0 < 2.0
    assert PORT.telemetry.registry().counter_value(
        "dccrg_membership_poll_failures_total") >= 1


def test_peer_dead_error_names_the_rank():
    coord = PORT.coord
    clk = FakeClock()
    a = coord.Membership(0, 2, kv=coord.InMemoryKV(), heartbeat_s=1.0,
                         lease_s=4.0, clock=clk)
    clk.advance(10.0)
    a.poll()
    assert a.dead_ranks() == [1]
    coord.set_membership(a)
    try:
        with pytest.raises(coord.PeerDeadError) as ei:
            coord.barrier("elastic-test", timeout=0.5)
        assert ei.value.ranks == [1] and "rank(s) [1]" in str(ei.value)
        assert isinstance(ei.value, coord.BarrierTimeoutError)
        assert ei.value.tag == "elastic-test"
    finally:
        coord.set_membership(None)
    coord.barrier("elastic-test", timeout=0.5)


# -- lease / fencing edge cases ---------------------------------------

def test_lease_expiry_exactly_at_renew_boundary():
    def run(side):
        clk = FakeClock()
        _kv, (owner, obs) = _leases(side, 2, clk)
        seen = [owner.acquire("j"), obs.expired_holder("j")]
        clk.advance(3.999)
        seen.append(obs.expired_holder("j"))
        clk.advance(0.001)
        seen += [obs.expired_holder("j"), obs.try_reclaim("j")]
        with pytest.raises(side.scheduler.OwnershipLostError) as ei:
            owner.renew("j")
        return seen + [ei.value.job, ei.value.held_epoch,
                       "epoch 2" in str(ei.value.current)]

    assert _both(run) == [1, None, None, 0, 2, "j", 1, True]


def test_reclaim_vs_late_renew_race_fencing_wins():
    def run(side):
        clk = FakeClock()
        _kv, (owner, obs) = _leases(side, 2, clk)
        owner.acquire("j")
        seen = [obs.expired_holder("j")]
        clk.advance(4.5)
        seen += [obs.expired_holder("j"), obs.try_reclaim("j")]
        owner._write("j", 1)
        with pytest.raises(side.scheduler.OwnershipLostError):
            owner.check("j")
        obs.check("j")
        return seen + ["j" in owner.owned, obs.owned["j"]]

    assert _both(run) == [None, 0, 2, False, 2]


def test_double_reclaim_exactly_one_wins():
    def run(side):
        clk = FakeClock()
        _kv, (owner, s1, s2) = _leases(side, 3, clk)
        owner.acquire("j")
        s1.expired_holder("j")
        s2.expired_holder("j")
        clk.advance(9.0)
        seen = [s1.expired_holder("j"), s2.expired_holder("j")]
        wins = [s1.try_reclaim("j"), s2.try_reclaim("j")]
        return seen + [wins, s1.owned.get("j"), s2.owned.get("j")]

    assert _both(run) == [0, 0, [2, None], 2, None]


def test_orphaned_claim_is_escalated_past():
    def run(side):
        clk = FakeClock()
        kv, (owner, dying, surv) = _leases(side, 3, clk)
        owner.acquire("j")
        surv.expired_holder("j")
        clk.advance(5.0)
        assert kv.create(f"{dying.prefix}/j@2", "1")
        seen = [surv.expired_holder("j"), surv.try_reclaim("j")]
        clk.advance(2.0)
        seen.append(surv.try_reclaim("j"))
        clk.advance(2.5)
        seen += [surv.try_reclaim("j"), surv.owned["j"]]
        with pytest.raises(side.scheduler.OwnershipLostError):
            owner.check("j")
        dying.owned["j"] = 2
        with pytest.raises(side.scheduler.OwnershipLostError):
            dying.check("j")
        return seen

    assert _both(run) == [0, None, None, 3, 3]


def test_acquire_adopts_own_record_and_rejects_foreign():
    def run(side):
        clk = FakeClock()
        kv, (a,) = _leases(side, 1, clk)
        a.acquire("j")
        a2 = side.scheduler.JobLeases(kv, 0, lease_s=4.0, clock=clk)
        b = side.scheduler.JobLeases(kv, 1, lease_s=4.0, clock=clk)
        with pytest.raises(side.scheduler.OwnershipLostError):
            b.acquire("j")
        return a2.acquire("j")

    assert _both(run) == 1


# -- the two-scheduler flows ------------------------------------------

def _serve_pair(side, d, steps=8, count=4, pause_after=3, limit=20,
                plan=None):
    """Both ranks serve ``pause_after`` ticks, then rank 0 stops and
    rank 1 ticks until it reports every job. Returns the ranks, the
    jobs rank 0 owned when it stopped, the clock and the KV."""
    kv, clk = side.coord.InMemoryKV(), FakeClock()
    a, b = _pair(side, d, kv, clk, count=count, steps=steps)
    for _ in range(pause_after):
        clk.advance(0.5)
        _tick(a)
        _tick(b)
    a_jobs = sorted(a.leases.owned)
    for _ in range(limit):
        clk.advance(0.6)
        _tick(b)
        if len(b.report) == count:
            break
    return a, b, a_jobs, clk, kv


def test_finish_done_marker_is_fenced(tmp_path):
    def run(side):
        a, b, a_jobs, _clk, kv = _serve_pair(side, tmp_path / side.name,
                                             count=2, pause_after=2)
        assert a_jobs and len(b.report) == 2
        done_key = f"{b.leases.prefix}/done/{a_jobs[0]}"
        marker = kv.get(done_key)
        assert marker is not None and marker.startswith("done:1:")
        victim = a._by_name[a_jobs[0]]
        for batch, slot, job in a.active_jobs():
            if job is victim:
                a._finish(batch, slot, job)
                break
        assert kv.get(done_key) == marker
        return a_jobs, victim.status, rows(b.report)

    assert _both(run)[1] == "lost"


def _run_one(side, d, **kw):
    sched = side.sched(d, _jobs(side, 3), quantum=2, **kw)
    report = sched.run()
    files = {}
    for p in sorted(glob.glob(os.path.join(str(d), "*"))):
        with open(p, "rb") as f:
            files[os.path.basename(p)] = hashlib.sha256(f.read()).hexdigest()
    return report, files


def test_rank_unaware_default_is_off_and_unchanged(tmp_path, monkeypatch):
    sched = PORT.sched(tmp_path / "x", [])
    assert sched.rank_aware is False
    assert sched.membership is None and sched.leases is None
    assert PORT.scheduler.rank_aware_default() is False
    monkeypatch.setenv("DCCRG_RANK_AWARE", "1")
    assert PORT.scheduler.rank_aware_default() is True
    aware = PORT.sched(tmp_path / "y", [])
    assert aware.rank_aware and aware.membership.rank == 0
    assert aware.membership.n_ranks == 1
    aware.membership.stop_auto()


def test_single_host_rank_aware_bitwise_pin(tmp_path):
    """Rank-aware on one process: the same files byte for byte, the same
    digests and rows (plus owner_rank) as the plain scheduler; the
    port's digests its run_solo's, and the file names the
    reference's."""
    names = {}
    for side in SIDES:
        plain_report, plain_files = _run_one(side, tmp_path / side.name / "p")
        m = side.coord.Membership(0, 1, kv=side.coord.InMemoryKV(),
                                  heartbeat_s=1.0, lease_s=4.0,
                                  clock=FakeClock())
        aware_report, aware_files = _run_one(side, tmp_path / side.name / "a",
                                             membership=m)
        for name in plain_report:
            aware = dict(aware_report[name])
            assert aware.pop("owner_rank") == 0
            assert aware == plain_report[name]
        assert aware_files == plain_files
        assert any(n.endswith(".dc") for n in plain_files)
        names[side] = (sorted(plain_files), rows(plain_report))
    assert names[PORT] == names[REF]
    assert {n: r["digest"] for n, r in plain_report.items()} == \
        PORT.solo(_jobs(PORT, 3))


def test_reclaim_readmits_from_stem_bitwise(tmp_path):
    def run(side):
        _a, b, a_jobs, _clk, _kv = _serve_pair(side, tmp_path / side.name)
        b_jobs = sorted(n for n in b.report if n not in a_jobs)
        assert a_jobs and b_jobs
        assert len(b.report) == 4
        reclaimed = sorted(n for n in a_jobs
                           if not b.report[n].get("remote")
                           and b.report[n]["requeues"] > 0)
        assert reclaimed == a_jobs
        assert side.telemetry.registry().counter_value(
            "dccrg_fleet_reclaims_total", job=a_jobs[0]) == 1
        return a_jobs, rows(b.report), {n: r["digest"]
                                        for n, r in b.report.items()}

    out = {s: run(s) for s in SIDES}
    assert out[PORT][:2] == out[REF][:2]
    assert out[PORT][2] == PORT.solo(_jobs(PORT))


def test_zombie_owner_cannot_publish(tmp_path):
    def run(side):
        a, b, a_jobs, clk, _kv = _serve_pair(side, tmp_path / side.name,
                                             steps=12, pause_after=2,
                                             limit=25)
        assert a_jobs and len(b.report) == 4
        store = str(tmp_path / side.name / "store")

        def snapshot():
            out = {}
            for p in sorted(glob.glob(os.path.join(store, "*"))):
                with open(p, "rb") as f:
                    out[p] = f.read()
            return out

        before = snapshot()
        with pytest.raises(side.scheduler.OwnershipLostError):
            a.leases.check(a_jobs[0])
        clk.advance(0.1)
        _tick(a)
        statuses = {n: a._by_name[n].status for n in a_jobs}
        assert set(statuses.values()) <= {"lost", "done"}
        assert snapshot() == before
        for n in a_jobs:
            newest = side.supervise.list_checkpoints(store, stem=n)[0][1]
            assert side.resilience.verify_chain(newest)
        clk.advance(0.1)
        _tick(a)
        assert len(a.report) == 4
        for n in a_jobs:
            assert a.report[n]["status"] == "done"
            assert a.report[n].get("remote") and a.report[n]["owner_rank"] == 1
        return a_jobs, statuses, rows(a.report), \
            {n: r["digest"] for n, r in b.report.items()}

    out = {s: run(s) for s in SIDES}
    assert out[PORT][:3] == out[REF][:3]
    assert out[PORT][3] == PORT.solo(_jobs(PORT, steps=12))


def test_rejoining_rank_reenters_partition(tmp_path):
    def run(side):
        kv, clk = side.coord.InMemoryKV(), FakeClock()
        a, b = _pair(side, tmp_path / side.name, kv, clk, count=2, steps=4)
        for _ in range(12):
            clk.advance(0.6)
            _tick(a)
            _tick(b)
            if len(a.report) == 2 and len(b.report) == 2:
                break
        for _ in range(10):
            clk.advance(0.6)
            _tick(b)
        assert b.membership.state(0) == "dead"
        for s in (a, b):
            for i in range(2):
                s.add(side.job(f"w2_{i}", length=(8, 8, 8), n_steps=4,
                               params=(0.05,), seed=90 + i,
                               checkpoint_every=2))
        for _ in range(12):
            clk.advance(0.6)
            _tick(a)
            _tick(b)
            if all(f"w2_{i}" in a.report and f"w2_{i}" in b.report
                   for i in range(2)):
                break
        assert b.membership.state(0) == "live"
        local = [sorted(n for n in ("w2_0", "w2_1")
                        if not s.report[n].get("remote")) for s in (a, b)]
        assert local[0] and local[1]
        assert sorted(local[0] + local[1]) == ["w2_0", "w2_1"]
        return local

    _both(run)


def test_host_death_fault_fires_in_process(tmp_path):
    def run(side):
        kv, clk = side.coord.InMemoryKV(), FakeClock()
        a, b = _pair(side, tmp_path / side.name, kv, clk)
        plan = side.faults.FaultPlan(seed=3)
        plan.host_death(rank=0, at_tick=2)
        died = False
        with plan:
            for _ in range(4):
                clk.advance(0.5)
                try:
                    _tick(a)
                except side.faults.InjectedRankDeath:
                    died = True
                    break
                _tick(b)
        assert died and plan.fired("fleet.host") == 1
        with plan:
            for _ in range(22):
                clk.advance(0.6)
                _tick(b)
                if len(b.report) == 4:
                    break
        assert len(b.report) == 4
        assert all(r["status"] == "done" for r in b.report.values())
        return rows(b.report), {n: r["digest"] for n, r in b.report.items()}

    out = {s: run(s) for s in SIDES}
    assert out[PORT][0] == out[REF][0]
    assert out[PORT][1] == PORT.solo(_jobs(PORT))
