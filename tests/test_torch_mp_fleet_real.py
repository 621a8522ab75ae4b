"""Real process deaths around the port's streaming intake and warm pool:
the counterparts of the ``intake_kill`` and ``rejoin_warm`` scenarios
of ``tests/mp_harness.py``, on the CPU.

``intake_kill``: two OS processes form a ``torch.distributed`` group
(gloo) over a free localhost port and share one spool directory and
the group's KV. Rank 1 claims a spool record (its intake lease and
journal record durable in the KV) and really exits (``os._exit``)
between the claim and the scheduler add. Rank 0 must reclaim the
orphaned admission once the lease expires and membership calls rank 1
dead, re-admit it from the journal record, and drain every job exactly
once with digests equal to ``run_solo``.

``rejoin_warm``: three single-process phases over one shared
``DCCRG_COMPILE_CACHE``: a cold run that records the manifest; a warm
restart that then rewrites the manifest records in a loop until the
test sends it a real SIGKILL mid-write; and the rejoin, whose pool must
load only complete records, prewarm every bucket before serving and
serve each bucket's first dispatch warm, with the cold run's digests.

``host_death``, ``zombie_fence`` and ``host_rejoin``: two ranks serve
one rank-aware fleet over a shared checkpoint store. The test kills
rank 1 with a real SIGKILL once it serves (rank 0 must reclaim its
jobs after the lease and drain every job with ``run_solo``'s digest),
or stops it with SIGSTOP until rank 0 has reclaimed, then resumes it
with SIGCONT (its renew must be fenced with a typed
``OwnershipLostError``, and both ranks report every job with the solo
digest). ``host_rejoin`` then adds a second wave once rank 1 is live
again, which the rejoined rank must serve.

Marked ``slow``: each case waits out a lease or a kill.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest

pytestmark = pytest.mark.slow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEATH_RC = 17

_WORKER = r"""
import json, os, sys, time
import torch
from dccrg_tpu_torch import coord, faults, fleet, intake, telemetry, warmstart
from dccrg_tpu_torch.scheduler import FleetScheduler

scenario, r, port, tmp = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
HEARTBEAT_S, LEASE_S = 0.25, 1.0
out = {}


def serve(sched, it, names, limit=120.0, progress=None):
    t0 = time.monotonic()
    while time.monotonic() - t0 < limit:
        sched.run(max_ticks=sched.ticks + 1)
        done = sum(1 for n in names if n in sched.report)
        if progress:
            with open(progress, "w") as f:
                f.write(f"{done}:0")
        if done == len(names) and it.idle():
            return True
        time.sleep(0.02)
    return False


def submit(spool, spec):
    intake.submit(spool, dict(
        name=spec["name"], length=list(spec["length"]),
        steps=spec["n_steps"], params=list(spec["params"]),
        seed=spec["seed"], checkpoint_every=spec["checkpoint_every"]))


def fleet_specs(steps):
    return [dict(name=f"fj{i}", length=(8, 8, 8), n_steps=steps,
                 params=(0.05,), seed=101 + i, checkpoint_every=4)
            for i in range(4)]


try:
    if scenario in ("host_death", "zombie_fence", "host_rejoin"):
        from dccrg_tpu_torch.scheduler import OwnershipLostError

        coord.distributed_init(f"127.0.0.1:{port}", 2, r, retries=20,
                               backoff=0.1)
        os.environ["DCCRG_BARRIER_TIMEOUT"] = "5"
        specs = fleet_specs(48)
        wave2 = []
        if scenario == "host_rejoin":
            # three jobs, then a second wave of one job per rank once
            # rank 1 is seen dead, then live again, and wave 1 drained
            specs, wave2 = specs[:3], [dict(specs[3]), dict(specs[3])]
            wave2[0]["name"], wave2[1]["name"] = "fj3", "fj4"
            wave2[1]["seed"] = 105
        names = [s["name"] for s in specs]
        wave1 = list(names)
        refs = {s["name"]: fleet.run_solo(fleet.FleetJob(**s), "cpu")
                for s in specs + wave2}
        store = os.path.join(tmp, "fleet")
        os.makedirs(store, exist_ok=True)
        m = coord.Membership(r, 2, heartbeat_s=HEARTBEAT_S, lease_s=LEASE_S)
        sched = FleetScheduler(store, [fleet.FleetJob(**s) for s in specs],
                               quantum=4, membership=m, devices=["cpu"],
                               bulk=False)
        fenced, drop = [], sched._drop_lost

        def spy(batch, slot, job, err):
            assert isinstance(err, OwnershipLostError), err
            fenced.append(job.name)
            drop(batch, slot, job, err)

        sched._drop_lost = spy
        prog = os.path.join(tmp, f"fleet_progress.rank{r}")
        t0, drained, saw_dead, added = time.monotonic(), False, False, False
        while time.monotonic() - t0 < 120 and not drained:
            if wave2 and not added:
                if r == 0:
                    st = m.state(1)
                    saw_dead = saw_dead or st == "dead"
                    if saw_dead and st == "live" and all(
                            n in sched.report for n in wave1):
                        m.kv.set("dccrg/test/wave2_go", "1")
                if m.kv.get("dccrg/test/wave2_go") is not None:
                    for s in wave2:
                        sched.add(fleet.FleetJob(**s))
                    names += [s["name"] for s in wave2]
                    added = True
            sched.run(max_ticks=sched.ticks + 1)
            done = sum(1 for n in names if n in sched.report)
            reclaims = int(telemetry.registry().counter_total(
                "dccrg_fleet_reclaims_total"))
            with open(prog + ".tmp", "w") as f:
                f.write(f"{sched.ticks}:{done}:{len(names)}:{reclaims}")
            os.replace(prog + ".tmp", prog)
            drained = done == len(names) and (added or not wave2)
            time.sleep(0.02)
        rows = sched.report
        out["wave2_local"] = sorted(
            s["name"] for s in wave2 if s["name"] in rows
            and not rows[s["name"]].get("remote"))
        out["drained"] = drained
        out["digests_solo"] = all(
            rows.get(n, {}).get("status") == "done"
            and rows[n]["digest"] == refs[n] for n in names)
        out["reclaimed"] = sorted(n for n in names if n in rows
                                  and not rows[n].get("remote")
                                  and rows[n]["requeues"] > 0)
        out["fenced"] = sorted(set(fenced))
        if scenario in ("zombie_fence", "host_rejoin"):
            # rank 0 hosts the group's store: it stays until rank 1 has
            # read the done markers it needs
            m.kv.set(f"dccrg/test/finished/{r}", "1")
            deadline = time.monotonic() + 120
            while r == 0 and time.monotonic() < deadline and m.kv.get(
                    "dccrg/test/finished/1") is None:
                time.sleep(0.05)
    elif scenario == "intake_kill":
        coord.distributed_init(f"127.0.0.1:{port}", 2, r, retries=20,
                               backoff=0.1)
        os.environ["DCCRG_BARRIER_TIMEOUT"] = "5"
        specs = [dict(name=f"ij{i}", length=(8, 8, 8), n_steps=16,
                      params=(0.05,), seed=101 + i, checkpoint_every=4)
                 for i in range(4)]
        names = [s["name"] for s in specs]
        spool = os.path.join(tmp, "spool")
        store = os.path.join(tmp, f"fleet.rank{r}")
        os.makedirs(store, exist_ok=True)
        m = coord.Membership(r, 2, heartbeat_s=HEARTBEAT_S, lease_s=LEASE_S)
        it = intake.StreamIntake(spool, membership=m, lease_s=LEASE_S,
                                 poll_s=0.02)
        sched = FleetScheduler(store, (), quantum=4, membership=m,
                               devices=["cpu"], intake=it, bulk=False)
        if r == 1:
            plan = faults.FaultPlan(seed=3)
            plan.intake_death(rank=r)
            with plan:
                t0 = time.monotonic()
                while time.monotonic() - t0 < 60:
                    sched.run(max_ticks=sched.ticks + 1)
                    time.sleep(0.02)
            raise AssertionError("rank 1 should have died at the claim")
        refs = {s["name"]: fleet.run_solo(fleet.FleetJob(**s), "cpu")
                for s in specs}
        for s in specs:
            submit(spool, s)
        claimed, deadline = None, time.monotonic() + 60
        while claimed is None and time.monotonic() < deadline:
            claimed = next((n for n in names if m.kv.get(
                f"dccrg/intake/journal/{n}") is not None), None)
            time.sleep(0.05)
        out["claimed"] = claimed
        out["drained"] = serve(sched, it, names)
        out["digests_solo"] = all(sched.report[n]["digest"] == refs[n]
                                  for n in names)
        out["reclaimed"] = it.reclaimed
        out["admitted"] = int(telemetry.registry().counter_total(
            "dccrg_intake_admitted_total"))
        out["done_markers"] = sum(
            m.kv.get(f"dccrg/intake/done/{n}") is not None for n in names)
        out["idle"] = it.idle()
    elif scenario == "rejoin":
        phase = sys.argv[5]
        os.environ["DCCRG_COMPILE_CACHE"] = os.path.join(tmp, "warmcache")
        specs = [dict(name=f"wj{i}", length=ln, n_steps=16, params=(0.05,),
                      seed=131 + i, checkpoint_every=4)
                 for i, ln in enumerate(((8, 8, 8), (8, 8, 12), (12, 8, 8)))]
        names = [s["name"] for s in specs]
        bkeys = [fleet.FleetJob(**s).bucket_key() for s in specs]
        spool = os.path.join(tmp, f"spool.{phase}")
        store = os.path.join(tmp, f"fleet.{phase}")
        os.makedirs(store, exist_ok=True)
        m = coord.Membership(0, 1, heartbeat_s=HEARTBEAT_S, lease_s=LEASE_S)
        it = intake.StreamIntake(spool, membership=m, lease_s=LEASE_S,
                                 poll_s=0.02)
        sched = FleetScheduler(store, (), quantum=4, membership=m,
                               devices=["cpu"], intake=it, bulk=False)
        pool = sched.warm
        if phase != "cold":
            out["prewarmed"] = bool(pool._worker is not None
                                    and pool._worker.wait(120)
                                    and pool._worker.error is None)
            out["errors"] = [str(e) for _k, e in pool.errors]
            out["warm_ready"] = all(pool.warm_ready(bk) for bk in bkeys)
        for s in specs:
            submit(spool, s)
        out["drained"] = serve(sched, it, names)
        reg = telemetry.registry()
        out["hits"] = int(reg.counter_total("dccrg_warm_hits_total"))
        out["misses"] = int(reg.counter_total("dccrg_warm_misses_total"))
        out["gate_transitions"] = it.gate_transitions
        out["digests"] = {n: sched.report[n]["digest"] for n in names}
        if phase == "serve":
            print("RESULT " + json.dumps(out), flush=True)
            prog = os.path.join(tmp, "churn")
            n = 0
            while True:
                with pool._lock:
                    for kid, e in list(pool.entries.items()):
                        rec = {k: v for k, v in e.items()
                               if not k.startswith("_")}
                        rec["hits"] = int(rec.get("hits", 0)) + 1
                        warmstart.write_entry(pool.dir, kid, rec)
                n += 1
                with open(prog + ".tmp", "w") as f:
                    f.write(str(n))
                os.replace(prog + ".tmp", prog)
except faults.InjectedRankDeath:
    os._exit(DEATH_RC)
print("RESULT " + json.dumps(out), flush=True)
os._exit(0)
""".replace("DEATH_RC", str(DEATH_RC))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(tmp_path, *args):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("DCCRG_COMPILE_CACHE", None)
    return subprocess.Popen([sys.executable, str(script), *map(str, args)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc, timeout=180):
    out, err = proc.communicate(timeout=timeout)
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    return (json.loads(lines[-1][len("RESULT "):]) if lines
            else {"stderr": err[-3000:]})


def _progress(tmp_path, rank):
    try:
        return [int(v) for v in
                (tmp_path / f"fleet_progress.rank{rank}").read_text().split(":")]
    except (OSError, ValueError):
        return None


def _wait(pred, procs, limit=90.0):
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline:
        if pred():
            return True
        if any(p.poll() is not None for p in procs):
            return False
        time.sleep(0.05)
    return False


def test_real_host_death_is_reclaimed(tmp_path):
    port = _free_port()
    procs = [_start(tmp_path, "host_death", r, port, tmp_path)
             for r in range(2)]
    try:
        serving = _wait(lambda: (_progress(tmp_path, 1) or [0])[0] >= 3,
                        procs)
        procs[1].kill()
        res = _result(procs[0])
        procs[1].communicate(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert serving, res
    assert procs[1].returncode == -signal.SIGKILL
    assert procs[0].returncode == 0, res
    assert res["drained"] and res["digests_solo"], res
    assert res["reclaimed"], res


def test_real_zombie_owner_is_fenced(tmp_path):
    port = _free_port()
    procs = [_start(tmp_path, "zombie_fence", r, port, tmp_path)
             for r in range(2)]
    try:
        serving = _wait(lambda: (_progress(tmp_path, 1) or [0])[0] >= 3,
                        procs)
        procs[1].send_signal(signal.SIGSTOP)
        reclaimed = _wait(lambda: (_progress(tmp_path, 0) or [0] * 4)[3] >= 1,
                          procs[:1], limit=30.0)
        procs[1].send_signal(signal.SIGCONT)
        res = {r: _result(p) for r, p in enumerate(procs)}
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGCONT)
                p.kill()
    assert serving and reclaimed, res
    assert [p.returncode for p in procs] == [0, 0], res
    for r in (0, 1):
        assert res[r]["drained"] and res[r]["digests_solo"], res
    assert res[1]["fenced"], res
    assert res[0]["reclaimed"], res


def test_real_host_rejoin_serves_the_second_wave(tmp_path):
    """The zombie round trip, then elastic regrow (the harness's
    ``host_rejoin``, tests/mp_harness.py:1107): once rank 0 has seen
    rank 1 dead and live again and wave 1 has drained, a second wave
    enters both queues, the deterministic partition hands the rejoined
    rank work, and it serves it to completion with the solo digest."""
    port = _free_port()
    procs = [_start(tmp_path, "host_rejoin", r, port, tmp_path)
             for r in range(2)]
    try:
        serving = _wait(lambda: (_progress(tmp_path, 1) or [0])[0] >= 3,
                        procs)
        procs[1].send_signal(signal.SIGSTOP)
        reclaimed = _wait(lambda: (_progress(tmp_path, 0) or [0] * 4)[3] >= 1,
                          procs[:1], limit=30.0)
        procs[1].send_signal(signal.SIGCONT)
        res = {r: _result(p) for r, p in enumerate(procs)}
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGCONT)
                p.kill()
    assert serving and reclaimed, res
    assert [p.returncode for p in procs] == [0, 0], res
    for r in (0, 1):
        assert res[r]["drained"] and res[r]["digests_solo"], res
    assert res[1]["fenced"], res
    assert res[1]["wave2_local"], res


def test_real_intake_kill_is_reclaimed_exactly_once(tmp_path):
    port = _free_port()
    procs = [_start(tmp_path, "intake_kill", r, port, tmp_path)
             for r in range(2)]
    try:
        res = {r: _result(p) for r, p in enumerate(procs)}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert procs[1].returncode == DEATH_RC, res[1]
    assert procs[0].returncode == 0, res[0]
    out = res[0]
    assert out["claimed"] is not None and out["drained"], out
    assert out["digests_solo"] and out["idle"], out
    assert out["reclaimed"] == 1 and out["admitted"] == 4, out
    assert out["done_markers"] == 4, out


def test_real_kill_mid_manifest_write_rejoins_warm(tmp_path):
    cold = _start(tmp_path, "rejoin", 0, 0, tmp_path, "cold")
    res_cold = _result(cold)
    assert cold.returncode == 0 and res_cold["drained"], res_cold
    assert res_cold["hits"] == 0 and res_cold["misses"] == 3

    serve = _start(tmp_path, "rejoin", 0, 0, tmp_path, "serve")
    churn = tmp_path / "churn"
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if churn.exists() and int(churn.read_text() or 0) >= 20:
                break
            assert serve.poll() is None, serve.communicate()
            time.sleep(0.05)
        os.kill(serve.pid, signal.SIGKILL)
        out, _err = serve.communicate(timeout=60)
    finally:
        if serve.poll() is None:
            serve.kill()
    assert serve.returncode == -signal.SIGKILL
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    res_serve = json.loads(lines[-1][len("RESULT "):])
    assert res_serve["hits"] == 3 and res_serve["misses"] == 0
    assert res_serve["digests"] == res_cold["digests"]

    warm = _start(tmp_path, "rejoin", 0, 0, tmp_path, "warm")
    res = _result(warm)
    assert warm.returncode == 0, res
    assert res["prewarmed"] and res["errors"] == [] and res["warm_ready"], res
    assert res["drained"] and res["gate_transitions"] == 0, res
    assert res["hits"] == 3 and res["misses"] == 0, res
    assert res["digests"] == res_cold["digests"]
