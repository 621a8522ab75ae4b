"""The port's warm-start cache and pool (dccrg_tpu_torch.warmstart)
against the reference's, on the CPU.

Each case of tests/test_warmstart.py runs on both packages with the
same jobs, fault plans and fake-clock autopilot
(tests/torch_sched_fixture.py: the port on the CPU with the table
program). Equal between the two: the manifest's and the quarantine's
files (record ids are ``key_id`` of the bucket key, equal across the
packages), each record's fields, every degradation with its typed
error, the pool's prewarmed keys and queue order, the SLO charge, the
GC reports and the journaled decisions (their ``seconds`` are host
measurements and their ``detail`` names the package's own cache epoch,
so those two inputs are compared only within a package). Each
package's digests equal its own cold run's.

The port's cache differs where its compiled artefacts do: ``build/``
holds the ``nvcc`` libraries where the reference's ``xla/`` holds
XLA's cache, and a prewarm builds the program tuple
``GridBatch._build_programs`` returns (pinned bit for bit against a
cold build below) where the reference AOT-compiles. The reference's
AOT fallback has no counterpart; its port analogue is a take on
another device, which falls back to a cold build.
"""

import os
import threading

import numpy as np
import pytest
import torch

from torch_sched_fixture import PORT, REF, SIDES, both

from dccrg_tpu import warmstart as r_warmstart
from dccrg_tpu_torch import warmstart as p_warmstart
from dccrg_tpu_torch.ops import _build

WARM = {REF: r_warmstart, PORT: p_warmstart}

pytestmark = pytest.mark.warmstart


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Warm-start knobs out of the env, fresh telemetry and program
    caches, no active pool, and the kernel build directory put back."""
    for var in ("DCCRG_COMPILE_CACHE", "DCCRG_WARM_POOL",
                "DCCRG_WARM_GC_BYTES", "DCCRG_WARM_GC_AGE_S",
                "DCCRG_AUTOPILOT", "DCCRG_DECISION_FILE"):
        monkeypatch.delenv(var, raising=False)
    build_dir = _build.BUILD_DIR

    def reset():
        for side in SIDES:
            side.reset_telemetry()
            side.fleet._FLEET_PROGRAMS.clear()
            WARM[side].deactivate()

    reset()
    yield
    reset()
    _build.set_build_dir(build_dir)


def _jobs(side, n=2, steps=6, **kw):
    return [side.job(f"j{i}", length=(8, 8, 8), n_steps=steps, seed=i,
                     checkpoint_every=4, **kw) for i in range(n)]


def _pool(side, c, **kw):
    """A WarmPool over ``c``; the port's on the CPU (its pools build for
    the card unless told otherwise)."""
    if side.port:
        kw.setdefault("device", "cpu")
    return WARM[side].WarmPool(c, **kw)


def _serve(side, d, jobs, pool=None):
    report = side.sched(d, jobs, warm_pool=pool).run()
    assert {r["status"] for r in report.values()} == {"done"}
    return {n: r["digest"] for n, r in report.items()}


def _seed_manifest(side, d, compile_s=2.5, hits=1, last_hit=1000.0,
                   capacity=8, job=None):
    ws = WARM[side]
    job = job or _jobs(side, 1)[0]
    bk = job.bucket_key()
    kid = side.autopilot.key_id((bk, capacity))
    ws.ensure_cache(d)
    ws.write_entry(str(d), kid, {
        "key": ws.bucket_payload(bk), "capacity": capacity,
        "integrity": False, "bulk": False, "hits": hits,
        "last_hit": last_hit, "compile_s": compile_s})
    return kid, bk


def _listing(d):
    return {sub: sorted(os.listdir(os.path.join(d, sub)))
            for sub in ("manifest", "quarantine")
            if os.path.isdir(os.path.join(d, sub))}


def _record(rec, measured=False):
    """A manifest record's fields but the epoch (each package's own), the
    wall-clock hit stamp and the port's ``library`` (None on the CPU);
    ``measured`` also drops the host-measured ``compile_s``."""
    assert rec.get("library") is None
    drop = ("epoch", "_bucket", "last_hit", "library") + (
        ("compile_s",) if measured else ())
    return {k: v for k, v in rec.items() if k not in drop}


def _errors(pool):
    return [(k, type(e).__name__) for k, e in pool.errors]


def _decisions(ap):
    out = []
    for r in ap.decisions:
        r = {k: v for k, v in r.items() if k != "ts"}
        r["inputs"] = {k: v for k, v in r["inputs"].items()
                       if k not in ("seconds", "detail")}
        out.append(r)
    return out


def _count(side, name, **labels):
    return side.telemetry.registry().counter_total(name, **labels)


def _same(out):
    assert out[PORT] == out[REF]
    return out[PORT]


# -- manifest crash consistency ---------------------------------------

def test_manifest_record_roundtrip(tmp_path):
    def scenario(side, d):
        ws = WARM[side]
        c = str(d / "cache")
        kid, bk = _seed_manifest(side, c, compile_s=1.25, hits=3)
        rec = ws.read_entry(ws.entry_path(c, kid))
        assert rec["_bucket"] == bk and rec["epoch"] == ws.cache_epoch()
        assert ws.bucket_from_payload(ws.bucket_payload(bk)) == bk
        assert ws.job_for_bucket(bk).bucket_key() == bk
        entries, rejects = ws.load_manifest(c)
        return _record(rec), list(entries), rejects

    rec, kids, rejects = _same(both(tmp_path, scenario))
    assert rec["hits"] == 3 and rec["compile_s"] == 1.25
    assert kids == [rec["_kid"]] and rejects == []


def test_concurrent_writers_last_complete_wins(tmp_path):
    def scenario(side, d):
        ws = WARM[side]
        c = str(d / "cache")
        kid, _bk = _seed_manifest(side, c, hits=1)
        _seed_manifest(side, c, hits=7)
        return ws.read_entry(ws.entry_path(c, kid))["hits"], _listing(c)

    hits, listing = _same(both(tmp_path, scenario))
    assert hits == 7 and len(listing["manifest"]) == 1


def test_callable_kernels_never_manifest():
    for side in SIDES:
        job = side.job("c", length=(8, 8, 8),
                       kernel=lambda cell, nbr, offs, mask, k: cell)
        assert WARM[side].bucket_payload(job.bucket_key()) is None


def test_registry_drift_is_typed():
    for side in SIDES:
        bk = _jobs(side, 1)[0].bucket_key()
        drifted = bk[:4] + ("no-such-kernel",) + bk[5:]
        with pytest.raises(WARM[side].WarmCacheError):
            WARM[side].job_for_bucket(drifted)


def _convicted(tmp_path, plan_fn, site, match):
    def scenario(side, d):
        ws = WARM[side]
        c = str(d / "cache")
        plan = side.faults.FaultPlan()
        plan_fn(plan)
        with plan:
            kid, _bk = _seed_manifest(side, c)
        assert plan.fired(site) == 1
        with pytest.raises(ws.WarmCacheError, match=match):
            ws.read_entry(ws.entry_path(c, kid))
        pool = _pool(side, c, start_pool=False)
        out = (kid, pool.entries, _errors(pool), _listing(c),
               ws.load_manifest(c), dict(pool._ready))
        pool.close()
        return out

    kid, entries, errors, listing, manifest, ready = _same(
        both(tmp_path, scenario))
    assert entries == {} and errors == [(kid, "WarmCacheError")]
    assert listing == {"manifest": [], "quarantine": [kid + ".rec"]}
    assert manifest == ({}, []) and ready == {}


def test_torn_record_convicted_and_quarantined(tmp_path):
    _convicted(tmp_path, lambda p: p.warm_torn_manifest(),
               "warm.manifest.write.torn", "torn")


def test_corrupt_entry_convicted_and_quarantined(tmp_path):
    _convicted(tmp_path, lambda p: p.warm_corrupt_entry(),
               "warm.manifest.write.corrupt", None)


def test_version_drift_rejected_to_cold(tmp_path):
    _convicted(tmp_path, lambda p: p.warm_stale_epoch(),
               "warm.manifest.write.stale", "epoch drift")


# -- the warm pool ----------------------------------------------------

def test_cold_run_manifests_and_warm_run_hits(tmp_path):
    def scenario(side, d):
        ws = WARM[side]
        c = str(d / "cache")
        pool = _pool(side, c, start_pool=False)
        ref = _serve(side, d / "ck-cold", _jobs(side), pool)
        pool.close()
        entries, rejects = ws.load_manifest(c)
        (rec,) = entries.values()
        assert rec["compile_s"] > 0.0
        misses = _count(side, "dccrg_warm_misses_total")
        side.fleet._FLEET_PROGRAMS.clear()
        pool2 = _pool(side, c, start_pool=False)
        pool2.prewarm(block=True)
        n_ready = len(pool2._ready)
        warm = _serve(side, d / "ck-warm", _jobs(side), pool2)
        assert warm == ref
        rec2 = ws.read_entry(ws.entry_path(c, rec["_kid"]))
        assert rec2["compile_s"] == rec["compile_s"]
        gauge = side.telemetry.registry().gauges[
            ("dccrg_warm_first_dispatch_ready_seconds", ())]
        pool2.close()
        return (_record(rec, measured=True), rejects, misses,
                _errors(pool2), n_ready,
                len(pool2._served), _count(side, "dccrg_warm_hits_total"),
                rec2["hits"], gauge > 0.0)

    out = _same(both(tmp_path, scenario))
    rec = out[0]
    assert rec["hits"] == 1 and out[1] == [] and out[2] == 1
    assert out[3] == [] and out[4] == 1 and out[5] == 1 and out[6] == 1
    assert out[7] == 2 and out[8]


def test_negative_pin_no_cache_no_pool(tmp_path):
    def scenario(side, d):
        ws = WARM[side]
        assert ws.WarmPool.from_env() is None
        sched = side.sched(d / "ck-none", _jobs(side))
        report = sched.run()
        assert sched.warm is None and sched.slo.warm_cost is None
        assert ws.active() is None and ws.take_prewarmed(("any",)) is None
        counts = [_count(side, n) for n in (
            "dccrg_warm_hits_total", "dccrg_warm_misses_total",
            "dccrg_warm_decisions_total", "dccrg_warm_cache_errors_total")]
        side.fleet._FLEET_PROGRAMS.clear()
        side.reset_telemetry()
        pool = ws.WarmPool(str(d / "cache"), start_pool=False)
        with_cache = _serve(side, d / "ck-cache", _jobs(side), pool)
        pool.close()
        assert {n: r["digest"] for n, r in report.items()} == with_cache
        return counts

    assert _same(both(tmp_path, scenario)) == [0, 0, 0, 0]


def test_negative_pin_keeps_the_package_build_dir(tmp_path):
    """Without a cache the port's kernels build into the package's own
    ``_build/``; a pool moves them to its ``build/``."""
    pkg_build = _build.BUILD_DIR
    assert pkg_build.name == "_build"
    assert pkg_build.parent.name == "dccrg_tpu_torch"
    sched = PORT.sched(tmp_path / "ck", _jobs(PORT, 1))
    sched.run()
    assert _build.BUILD_DIR == pkg_build
    c = str(tmp_path / "cache")
    pool = p_warmstart.WarmPool(c, start_pool=False)
    assert str(_build.BUILD_DIR) == os.path.join(c, "build")
    assert sorted(os.listdir(c)) == ["build", "manifest", "quarantine"]
    pool.close()


def test_prewarm_vs_dispatch_race_is_bitwise_neutral(tmp_path):
    def scenario(side, d):
        ws = WARM[side]
        c = str(d / "cache")
        pool = _pool(side, c, start_pool=False)
        ref = _serve(side, d / "ck-a", _jobs(side, 3), pool)
        pool.close()
        side.fleet._FLEET_PROGRAMS.clear()
        pool2 = _pool(side, c, start_pool=False)
        worker = pool2.prewarm()
        try:
            got = _serve(side, d / "ck-b", _jobs(side, 3), pool2)
            assert worker.wait(30.0)
            assert worker.error is None
        finally:
            worker.stop()
            pool2.close()
        return got == ref

    assert _same(both(tmp_path, scenario)) is True


def test_prewarm_worker_is_abortable(tmp_path):
    def scenario(side, d):
        c = str(d / "cache")
        _seed_manifest(side, c)
        pool = _pool(side, c, start_pool=False)
        ev = threading.Event()
        ev.set()
        pool._prewarm_run(ev)
        pool.close()
        return dict(pool._ready), list(pool._queue)

    ready, queue = _same(both(tmp_path, scenario))
    assert ready == {} and len(queue) == 1


def test_attach_respects_warm_pool_env(tmp_path, monkeypatch):
    def scenario(side, d):
        ws = WARM[side]
        monkeypatch.setenv("DCCRG_WARM_POOL", "0")
        c = str(d / "cache")
        _seed_manifest(side, c)
        pool = _pool(side, c)
        sched = side.sched(d / "ck", [], warm_pool=pool)
        out = (pool.start_pool, sched.warm is pool, pool._worker,
               ws.active() is pool)
        pool.close()
        return out + (ws.active(),)

    assert _same(both(tmp_path, scenario)) == (False, True, None, True, None)


def test_note_incoming_moves_key_to_front(tmp_path):
    def scenario(side, d):
        c = str(d / "cache")
        hot = side.job("hot", length=(8, 8, 8), kernel="diffuse")
        cold = side.job("cold", length=(4, 4, 4), kernel="diffuse")
        kid_hot, bk_hot = _seed_manifest(side, c, last_hit=10.0, job=hot)
        kid_cold, _ = _seed_manifest(side, c, last_hit=99.0, job=cold)
        pool = _pool(side, c, start_pool=False)
        queues = [list(pool._queue)]
        pool.note_incoming(bk_hot)
        queues.append(list(pool._queue))
        pool.close()
        return queues, (kid_cold, kid_hot)

    queues, (kid_cold, kid_hot) = _same(both(tmp_path, scenario))
    assert queues == [[kid_cold, kid_hot], [kid_hot, kid_cold]]


# -- SLO projection ---------------------------------------------------

def test_warm_ready_slo_projection(tmp_path):
    def scenario(side, d):
        c = str(d / "cache")
        job = _jobs(side, 1)[0]
        _kid, bk = _seed_manifest(side, c, compile_s=2.5, capacity=8,
                                  job=job)
        pool = _pool(side, c, start_pool=False)
        sched = side.sched(d / "ck", [], warm_pool=pool)
        assert sched.slo.warm_cost.__self__ is pool
        seen = [pool.warm_ready(bk), sched.slo.projected_completion_s(job),
                sched.slo.projected_completion_s(
                    side.job("s", length=(6, 6, 6)))]
        pool.prewarm(block=True)
        seen += [_errors(pool), pool.warm_ready(bk),
                 sched.slo.projected_completion_s(job)]
        pool.close()
        return seen

    assert _same(both(tmp_path, scenario)) == [False, 2.5, 0.0, [], True,
                                               0.0]


# -- the fault matrix -------------------------------------------------

PLANNERS = {
    "warm.manifest.write.torn": lambda p: p.warm_torn_manifest(),
    "warm.manifest.write.corrupt": lambda p: p.warm_corrupt_entry(),
    "warm.manifest.write.stale": lambda p: p.warm_stale_epoch(),
    "warm.cache.io": lambda p: p.warm_io_error(op="read"),
}


def test_every_warm_fault_site_degrades_typed(tmp_path):
    for side in SIDES:
        sites = [s for s, _p in side.faults.WARMSTART_FAULT_SITES]
        assert set(PLANNERS) | {"warm.prewarm"} == set(sites)

    def scenario(side, d):
        ws = WARM[side]
        ref = _serve(side, d / "ck-ref", _jobs(side))
        out = {}
        for i, (site, make) in enumerate(sorted(PLANNERS.items())):
            side.fleet._FLEET_PROGRAMS.clear()
            side.reset_telemetry()
            c = str(d / f"cache{i}")
            ap = side.autopilot.Autopilot(quantum=4, clock=lambda: 0.0)
            plan = side.faults.FaultPlan()
            make(plan)
            with plan:
                pool = _pool(side, c, autopilot=ap, start_pool=False)
                assert _serve(side, d / f"ck-a{i}", _jobs(side), pool) == ref
                pool.close()
                side.fleet._FLEET_PROGRAMS.clear()
                pool2 = _pool(side, c, autopilot=ap, start_pool=False)
                pool2.prewarm(block=True)
                ready = dict(pool2._ready)
                assert _serve(side, d / f"ck-b{i}", _jobs(side),
                              pool2) == ref
                pool2.close()
            assert side.autopilot.replay(list(ap.decisions)) == []
            out[site] = (plan.fired(site) >= 1, ready,
                         _errors(pool) + _errors(pool2),
                         _count(side, "dccrg_warm_cache_errors_total") >= 1,
                         _decisions(ap), _listing(c))
        return out

    out = _same(both(tmp_path, scenario))
    for site, (fired, ready, errors, counted, recs, _listing_) in out.items():
        assert fired and ready == {} and counted, site
        assert errors and {e for _k, e in errors} == {"WarmCacheError"}, site
        kinds = [r["inputs"]["decision"] for r in recs
                 if r["rule"] == "warmstart.cache"]
        assert "warm" not in kinds, site
        assert {"quarantine", "reject"} & set(kinds), site


def test_death_mid_prewarm_is_typed_and_recoverable(tmp_path):
    def scenario(side, d):
        ws = WARM[side]
        c = str(d / "cache")
        _seed_manifest(side, c)
        pool = _pool(side, c, start_pool=False)
        plan = side.faults.FaultPlan()
        plan.warm_prewarm_death()
        with plan:
            with pytest.raises(side.faults.InjectedRankDeath):
                pool.prewarm(block=True)
        pool.close()
        entries, rejects = ws.load_manifest(c)
        pool2 = _pool(side, c, start_pool=False)
        plan2 = side.faults.FaultPlan()
        plan2.warm_prewarm_death()
        with plan2:
            worker = pool2.prewarm()
            assert worker.wait(30.0)
        died = isinstance(worker.error, side.faults.InjectedRankDeath)
        errs = _count(side, "dccrg_prewarm_errors_total")
        pool2._load()
        pool2.prewarm(block=True)
        pool2.close()
        return (len(entries), rejects, died, errs, len(pool2._ready),
                _errors(pool2))

    assert _same(both(tmp_path, scenario)) == (1, [], True, 1, 1, [])


def test_cache_write_failure_leaves_serving_at_zero_trips(tmp_path):
    def scenario(side, d):
        ws = WARM[side]
        c = str(d / "cache")
        pool = _pool(side, c, start_pool=False)
        plan = side.faults.FaultPlan()
        plan.warm_io_error(times=100, op="write")
        with plan:
            report = side.sched(d / "ck", _jobs(side), warm_pool=pool).run()
        pool.close()
        return ({n: r["trips"] for n, r in report.items()},
                {e for _k, e in _errors(pool)}, ws.load_manifest(c))

    trips, errors, manifest = _same(both(tmp_path, scenario))
    assert not any(trips.values()) and errors == {"WarmCacheError"}
    assert manifest == ({}, [])


# -- journaled decisions ----------------------------------------------

def test_decisions_journal_and_replay(tmp_path):
    def scenario(side, d):
        ws = WARM[side]
        c = str(d / "cache")
        journal = d / "decisions.jsonl"
        ap = side.autopilot.Autopilot(quantum=4, clock=lambda: 0.0,
                                      decision_file=str(journal))
        pool = _pool(side, c, autopilot=ap, start_pool=False)
        _serve(side, d / "ck-a", _jobs(side), pool)
        pool.close()
        side.fleet._FLEET_PROGRAMS.clear()
        pool2 = _pool(side, c, autopilot=ap, start_pool=False)
        pool2.prewarm(block=True)
        _serve(side, d / "ck-b", _jobs(side), pool2)
        pool2.close()
        assert {"warmstart.cache", "warmstart.gc"} <= set(
            side.autopilot.RULES)
        return str(journal), _decisions(ap), ap.warm_events

    out = both(tmp_path, scenario)
    recs, events = _same({s: o[1:] for s, o in out.items()})
    kinds = [r["inputs"]["decision"] for r in recs
             if r["rule"] == "warmstart.cache"]
    assert kinds == ["cold", "warm"] and events == 2
    for writer in SIDES:
        for reader in SIDES:
            assert reader.autopilot.replay(
                reader.autopilot.read_journal(out[writer][0])) == []


# -- retention GC -----------------------------------------------------

def _gc_report(report, d):
    """A GC report with paths made relative to the cache dir."""
    rel = lambda p: os.path.relpath(p, d)  # noqa: E731
    out = dict(report)
    for k in ("pruned", "swept_tmp"):
        out[k] = [rel(p) for p in report[k]]
    return out


def test_gc_dry_run_default_and_age_bound(tmp_path):
    def scenario(side, d):
        ws = WARM[side]
        c = str(d / "cache")
        kid_old, _ = _seed_manifest(side, c, last_hit=100.0, job=side.job(
            "a", length=(8, 8, 8)))
        kid_new, _ = _seed_manifest(side, c, last_hit=900.0, job=side.job(
            "b", length=(4, 4, 4)))
        dry = ws.gc(c, max_age_s=300.0, now=1000.0)
        kept = os.path.exists(ws.entry_path(c, kid_old))
        applied = ws.gc(c, max_age_s=300.0, now=1000.0, dry_run=False)
        return (_gc_report(dry, c), kept, _gc_report(applied, c),
                _listing(c), kid_old)

    dry, kept, applied, listing, kid_old = _same(both(tmp_path, scenario))
    assert dry["dry_run"] is True and dry["pruned_kids"] == [kid_old] and kept
    assert applied["pruned_kids"] == [kid_old]
    assert kid_old + ".rec" not in listing["manifest"]


def test_gc_size_bound_prunes_least_recently_hit_first(tmp_path):
    def scenario(side, d):
        c = str(d / "cache")
        kids = [_seed_manifest(side, c, last_hit=100.0 * (i + 1),
                               job=side.job(f"j{n}", length=(n, n, n)))[0]
                for i, n in enumerate((8, 4, 6))]
        return kids, _gc_report(WARM[side].gc(c, max_bytes=0,
                                              dry_run=False), c)

    kids, report = _same(both(tmp_path, scenario))
    assert report["pruned_kids"] == kids and report["bytes_after"] == 0


def test_gc_never_prunes_inflight_prewarm(tmp_path):
    def scenario(side, d):
        ws = WARM[side]
        c = str(d / "cache")
        kid, _ = _seed_manifest(side, c, last_hit=0.0)
        pool = _pool(side, c, start_pool=False)
        pool._inflight.add(kid)
        first = pool.gc(max_age_s=1.0, dry_run=False)["pruned_kids"]
        kept = os.path.exists(ws.entry_path(c, kid))
        pool._inflight.discard(kid)
        pool._queue = []
        second = pool.gc(max_age_s=1.0, dry_run=False)["pruned_kids"]
        pool.close()
        return first, kept, second, kid

    first, kept, second, kid = _same(both(tmp_path, scenario))
    assert first == [] and kept and second == [kid]


def test_gc_sweeps_dead_pid_temp_litter(tmp_path):
    def scenario(side, d):
        ws = WARM[side]
        c = str(d / "cache")
        ws.ensure_cache(c)
        mdir = os.path.join(c, "manifest")
        dead = os.path.join(mdir, ".x.rec.tmp.999999999")
        live = os.path.join(mdir, f".y.rec.tmp.{os.getpid()}")
        for p in (dead, live):
            with open(p, "w") as f:
                f.write("partial")
        stale = [os.path.relpath(p, c) for p in ws.stale_temp_files(c)]
        report = _gc_report(ws.gc(c, dry_run=False), c)
        return stale, report["swept_tmp"], os.path.exists(dead), \
            os.path.exists(live)

    stale, swept, dead, live = _same(both(tmp_path, scenario))
    assert stale == swept == ["manifest/.x.rec.tmp.999999999"]
    assert not dead and live


def test_gc_applied_prunes_are_journaled(tmp_path):
    def scenario(side, d):
        c = str(d / "cache")
        _seed_manifest(side, c, last_hit=0.0)
        ap = side.autopilot.Autopilot(quantum=4, clock=lambda: 0.0)
        pool = _pool(side, c, autopilot=ap, start_pool=False)
        pool._queue = []
        pool.gc(max_age_s=1.0, dry_run=False)
        assert side.autopilot.replay(list(ap.decisions)) == []
        pool.close()
        recs = [r for r in ap.decisions if r["rule"] == "warmstart.gc"]
        return len(recs), recs[0]["inputs"]["n"], pool.entries

    assert _same(both(tmp_path, scenario)) == (1, 1, {})


def test_gc_io_error_degrades_to_null_report(tmp_path):
    def scenario(side, d):
        ws = WARM[side]
        c = str(d / "cache")
        kid, _ = _seed_manifest(side, c)
        plan = side.faults.FaultPlan()
        plan.warm_io_error(op="gc")
        with plan:
            report = ws.gc(c, max_age_s=0.0, dry_run=False)
        return ("error" in report, report["pruned"],
                os.path.exists(ws.entry_path(c, kid)))

    assert _same(both(tmp_path, scenario)) == (True, [], True)


def test_gc_prunes_the_oldest_kernel_library(tmp_path):
    """The port's ``build/`` takes the place of the reference's
    ``xla/`` in the size bound: libraries go oldest first."""
    c = str(tmp_path / "cache")
    p_warmstart.ensure_cache(c)
    libs = []
    for i, name in enumerate(("libold-0.so", "libnew-1.so")):
        path = os.path.join(c, "build", name)
        with open(path, "wb") as f:
            f.write(b"\0" * 64)
        os.utime(path, (100.0 + i, 100.0 + i))
        libs.append(path)
    report = p_warmstart.gc(c, max_bytes=64, dry_run=False, now=200.0)
    assert report["pruned"] == [libs[0]] and report["bytes_after"] == 64
    assert not os.path.exists(libs[0]) and os.path.exists(libs[1])


# -- CLI --------------------------------------------------------------

def test_cli_list_and_gc_smoke(tmp_path, capsys):
    def scenario(side, d):
        ws = WARM[side]
        c = str(d / "cache")
        _seed_manifest(side, c)
        outs = [ws._main(["list", "--dir", c])]
        text = capsys.readouterr().out
        outs.append("1 entries" in text and ws.cache_epoch() in text)
        outs.append(ws._main(["gc", "--dir", c, "--max-age-s", "1"]))
        outs.append("would prune" in capsys.readouterr().out)
        outs.append(len(ws.load_manifest(c)[0]))
        outs.append(ws._main(["gc", "--dir", c, "--max-age-s", "1",
                              "--apply"]))
        capsys.readouterr()
        outs.append(ws.load_manifest(c)[0])
        outs.append(ws._main(["list"]))
        capsys.readouterr()
        return outs

    assert _same(both(tmp_path, scenario)) == [0, True, 0, True, 1, 0, {},
                                               2]


# -- the port's own pins ----------------------------------------------

def test_cache_epoch_is_the_ports_own():
    """The port stamps torch's, CUDA's and its own versions (no jax):
    a record the reference wrote is another stack's."""
    import hashlib

    seed = (f"torch={torch.__version__}:cuda={torch.version.cuda}:pkg=0:"
            f"schema={p_warmstart.MANIFEST_SCHEMA}")
    assert p_warmstart.cache_epoch() == hashlib.sha1(
        seed.encode()).hexdigest()[:16]
    assert p_warmstart.cache_epoch() != r_warmstart.cache_epoch()


@pytest.mark.parametrize("bulk", [False, True])
def test_prewarmed_quantum_equals_a_cold_build(tmp_path, bulk):
    """A prewarmed program tuple steps a quantum bit for bit as a cold
    build's (the table program and kernel A''s plain version), and the
    prewarm put nothing on a device: the table program's neighbour
    tables upload at its first dispatch."""
    from dccrg_tpu_torch import fleet

    job = PORT.job("p", length=(8, 8, 8), n_steps=8, seed=3,
                   params=(0.05,))
    c = str(tmp_path / "cache")
    pool = p_warmstart.WarmPool(c, device="cpu", start_pool=False)
    kid = PORT.autopilot.key_id((job.bucket_key(), 4))
    p_warmstart.write_entry(c, kid, {
        "key": p_warmstart.bucket_payload(job.bucket_key()), "capacity": 4,
        "integrity": True, "bulk": bulk, "hits": 1, "last_hit": 1.0,
        "compile_s": 1.0})
    pool._load()
    pool.prewarm(block=True)
    assert pool.errors == [] and len(pool._ready) == 1
    (warm,) = pool._ready.values()
    batch = fleet.GridBatch(job, 4, "cpu", bulk=bulk)
    key = batch._program_key()
    assert key in pool._ready and warm[3] is bulk
    cold = batch._build_programs(key)
    rng = np.random.default_rng(0)
    state = {"rho": torch.as_tensor(
        rng.random((4, batch.R)).astype(np.float32))}
    extras = torch.full((4, 1), 0.05)
    budget = torch.tensor([8, 3, 0, 5], dtype=torch.int32)
    outs = [fn(dict(state), extras, budget, 8) for fn in (warm[0], cold[0])]
    assert torch.equal(outs[0][0]["rho"], outs[1][0]["rho"])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)
    assert torch.equal(warm[1](outs[0][0]), cold[1](outs[1][0]))
    pool.close()


def test_take_on_another_device_falls_back_cold(tmp_path):
    """The port's analogue of the reference's AOT fallback: a prewarmed
    program is served only on the pool's device; a take for another
    device returns None and the batch builds cold."""
    job = PORT.job("p", length=(8, 8, 8), n_steps=4)
    c = str(tmp_path / "cache")
    pool = p_warmstart.WarmPool(c, device="cpu", start_pool=False)
    kid = PORT.autopilot.key_id((job.bucket_key(), 8))
    p_warmstart.write_entry(c, kid, {
        "key": p_warmstart.bucket_payload(job.bucket_key()), "capacity": 8,
        "integrity": True, "bulk": False, "hits": 1, "last_hit": 1.0,
        "compile_s": 1.0})
    pool._load()
    pool.prewarm(block=True)
    (key,) = pool._ready
    assert pool.take(key, device="meta") is None and not pool._served
    assert pool.take(key, device=torch.device("cpu")) is pool._ready[key]
    assert pool._served == {key}
    pool.close()
