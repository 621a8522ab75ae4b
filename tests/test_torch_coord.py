"""The port's coordination layer (``dccrg_tpu_torch/coord.py``) against
the reference's (``dccrg_tpu/coord.py``), on the CPU.

The counterparts of ``tests/test_coord.py`` (barriers, guarded init,
trip consensus, the runner's consensus handling) and of the membership
cases of ``tests/test_fleet_elastic.py``; sealed records byte for byte
the reference's; ``kv_barrier`` with threads as ranks; the store-backed
``CoordKV``; and one two-rank gloo group over localhost (barrier, MAX
consensus, a ``CoordKV`` barrier and CAS, a lost rank's barrier timing
out on its peer with the tag named).

The reference's host-collective program tests (``test_coord.py``
``test_host_collective_programs_are_cached``,
``test_crc_gather_dtype_survives_x64_off``,
``test_host_some_reduce_still_correct_with_sharded_mask``) test JAX
programs the port does not have, so they have no counterpart here.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import jax.numpy as jnp

from dccrg_tpu import coord as ref_coord
from dccrg_tpu import resilience as ref_res
from dccrg_tpu.grid import Grid as RefGrid
from torch_amr_fixture import mesh1

import torch

from dccrg_tpu_torch import Grid, coord, faults, resilience, telemetry
from dccrg_tpu_torch.resilience import (ResilienceExhaustedError,
                                        ResilientRunner)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for v in ("DCCRG_HEARTBEAT_S", "DCCRG_LEASE_S", "DCCRG_BARRIER_TIMEOUT"):
        monkeypatch.delenv(v, raising=False)
    prev = coord.set_membership(None)
    telemetry.registry().reset()
    yield
    coord.set_membership(prev)
    telemetry.registry().reset()


def _mk(n_dev=2):
    return (Grid(cell_data={"v": torch.float32})
            .set_initial_length((4, 4, 4))
            .set_neighborhood_length(1)
            .initialize(["cpu"] * n_dev, partition="block"))


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


# -- barrier ----------------------------------------------------------

def test_barrier_is_noop_on_single_controller():
    t0 = time.monotonic()
    coord.barrier("nothing-to-sync", timeout=0.05)
    assert time.monotonic() - t0 < 0.05


def test_barrier_timeout_raises_typed_error_within_bound():
    plan = faults.FaultPlan()
    plan.barrier_hang()
    t0 = time.monotonic()
    with plan, pytest.raises(coord.BarrierTimeoutError) as ei:
        coord.barrier("ckpt-commit", timeout=0.3)
    assert time.monotonic() - t0 < 3.0
    assert ei.value.tag == "ckpt-commit"
    assert "ckpt-commit" in str(ei.value)
    assert plan.fired("coord.barrier_hang") == 1


def test_barrier_hang_matches_tag():
    plan = faults.FaultPlan()
    plan.barrier_hang(tag="only-this-one")
    with plan:
        coord.barrier("some-other", timeout=0.2)  # unaffected
        with pytest.raises(coord.BarrierTimeoutError):
            coord.barrier("only-this-one", timeout=0.2)


def test_barrier_survives_slow_but_alive_peer():
    plan = faults.FaultPlan()
    plan.barrier_hang(hang_s=0.05)
    with plan:
        coord.barrier("slow-peer", timeout=5.0)


def test_barrier_timeout_env_knob(monkeypatch):
    monkeypatch.setenv("DCCRG_BARRIER_TIMEOUT", "0.2")
    assert coord.barrier_timeout() == ref_coord.barrier_timeout() == 0.2
    plan = faults.FaultPlan()
    plan.barrier_hang()
    with plan, pytest.raises(coord.BarrierTimeoutError) as ei:
        coord.barrier("env-bound")
    assert ei.value.timeout == 0.2
    monkeypatch.setenv("DCCRG_BARRIER_TIMEOUT", "not-a-number")
    assert coord.barrier_timeout() == coord.DEFAULT_BARRIER_TIMEOUT


def test_injected_transient_barrier_error_propagates():
    plan = faults.FaultPlan()
    plan.io_error(site="coord.barrier")
    with plan, pytest.raises(faults.InjectedIOError):
        coord.barrier("flaky")


def test_error_messages_equal_reference():
    pairs = [
        (coord.BarrierTimeoutError("t", 1.5),
         ref_coord.BarrierTimeoutError("t", 1.5)),
        (coord.TornRecordError("k", "d"), ref_coord.TornRecordError("k", "d")),
        (coord.StaleFenceError("t", 1, 2), ref_coord.StaleFenceError("t", 1, 2)),
        (coord.RemoteAbortError("t", 3, "why"),
         ref_coord.RemoteAbortError("t", 3, "why")),
        (coord.PeerDeadError("t", 2.0, [3, 1], lease_s=4.0),
         ref_coord.PeerDeadError("t", 2.0, [3, 1], lease_s=4.0)),
    ]
    for got, want in pairs:
        assert str(got) == str(want)
    assert coord.CheckpointCommitError("m", [2, 0, 2]).ranks == [0, 2]


# -- guarded distributed init -----------------------------------------

def test_distributed_init_retries_transient_failures(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: calls.append(kw))
    plan = faults.FaultPlan()
    plan.io_error(site="coord.init", times=2)
    with plan:
        coord.distributed_init("127.0.0.1:1234", 2, 0,
                               retries=3, backoff=0.0)
    assert len(calls) == 1  # two injected failures, then success
    assert plan.fired("coord.init") == 2
    assert calls[0]["init_method"] == "tcp://127.0.0.1:1234"
    assert calls[0]["world_size"] == 2 and calls[0]["rank"] == 0
    assert calls[0]["backend"] == "gloo"


def test_distributed_init_exhausts_to_typed_error(monkeypatch):
    def boom(**kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    with pytest.raises(coord.DistributedInitError,
                       match="coordinator unreachable"):
        coord.distributed_init("127.0.0.1:1234", 2, 0,
                               retries=1, backoff=0.0)


# -- trip consensus ---------------------------------------------------

def test_trip_consensus_single_controller_passthrough():
    g = _mk()
    assert not g._multiproc
    assert coord.trip_consensus(g, 0) == 0
    assert coord.trip_consensus(g, 2) == 2


def test_trip_consensus_under_a_faked_split():
    """A split grid with no process group returns the local code, as the
    reference's faked split does."""
    g = _mk()
    r = (RefGrid(cell_data={"v": jnp.float32}).set_initial_length((4, 4, 4))
         .set_neighborhood_length(1).initialize(partition="block"))
    for grid in (g, r):
        grid._proc_local_dev = np.array(
            [d < grid.n_dev // 2 for d in range(grid.n_dev)], dtype=bool)
        assert grid._multiproc
    for code in (0, 3):
        assert coord.trip_consensus(g, code) == \
            ref_coord.trip_consensus(r, code) == code
    assert coord.process_rank(g) == 0
    g._ckpt_rank = 1
    assert coord.process_rank(g) == 1


def test_broadcast_fatal_swallows_errors(monkeypatch):
    monkeypatch.setattr(coord, "trip_consensus",
                        lambda grid, code: (_ for _ in ()).throw(
                            RuntimeError("group gone")))
    coord.broadcast_fatal(_mk(), resilience._TRIP_FATAL, timeout=1.0)


def test_trip_codes_equal_reference():
    for name in ("_TRIP_INTERRUPT", "_TRIP_ROLLBACK", "_TRIP_NUMERICS",
                 "_TRIP_CORRUPT", "_TRIP_OOM", "_TRIP_FATAL"):
        assert getattr(resilience, name) == getattr(ref_res, name)


def test_runner_fatal_peer_trip_raises_in_sync(tmp_path, monkeypatch):
    g = _mk()
    g.set("v", g.plan.cells, np.ones(len(g.plan.cells), np.float32))

    def fake_consensus(grid, code):
        return resilience._TRIP_FATAL if runner.step == 2 else int(code)

    monkeypatch.setattr(coord, "trip_consensus", fake_consensus)
    runner = ResilientRunner(
        g, lambda grid, i: None, str(tmp_path / "f.dc"),
        check_every=100, checkpoint_every=100, backoff=0.0,
        diagnostics_dir=str(tmp_path))
    with pytest.raises(ResilienceExhaustedError, match="peer rank"):
        runner.run(5)
    assert runner.step == 2


def test_runner_broadcasts_fatal_before_reraising(tmp_path, monkeypatch):
    g = _mk()
    sent = []
    monkeypatch.setattr(coord, "trip_consensus",
                        lambda grid, code: sent.append(code) or int(code))

    def step_fn(grid, i):
        if i == 1:
            raise ValueError("boom")

    runner = ResilientRunner(
        g, step_fn, str(tmp_path / "b.dc"),
        check_every=100, checkpoint_every=100, backoff=0.0,
        diagnostics_dir=str(tmp_path))
    with pytest.raises(ValueError, match="boom"):
        runner.run(5)
    assert resilience._TRIP_FATAL in sent


def _scale_kernel(c, n, o, m):
    return {"v": c["v"] * 1.5}


def _ref_scale_kernel(c, n, o, m):
    return {"v": c["v"] * jnp.float32(1.5)}


def test_runner_rolls_back_on_remote_rank_trip(tmp_path, monkeypatch):
    """A trip reported by ANOTHER rank rolls this rank back too, and the
    final bytes equal the reference runner's under the same remote trip
    (tolerance: bit for bit)."""
    def run(pkg_grid, kernel, mod, runner_cls, name):
        cells = pkg_grid.plan.cells
        pkg_grid.set("v", cells, (cells % np.uint64(7)).astype(np.float32))
        remote = []
        box = {}

        def fake(grid, code):
            if box["r"].step == 3 and not remote:
                remote.append(box["r"].step)
                return 2
            return int(code)

        monkeypatch.setattr(mod, "trip_consensus", fake)
        r = runner_cls(pkg_grid, lambda grid, i: grid.run_steps(
            kernel, ["v"], ["v"], 1), str(tmp_path / f"{name}.dc"),
            check_every=100, checkpoint_every=2, backoff=0.0,
            diagnostics_dir=str(tmp_path))
        box["r"] = r
        r.run(5)
        monkeypatch.undo()
        assert remote == [3] and r.rollbacks == 1 and r.step == 5
        assert r.trips[0]["fields"].get("remote_rank_trip") == []
        return np.asarray(pkg_grid.get("v", cells)).tobytes()

    got = run(_mk(), _scale_kernel, coord, ResilientRunner, "p")
    ref_g = (RefGrid(cell_data={"v": jnp.float32})
             .set_initial_length((4, 4, 4)).set_neighborhood_length(1)
             .initialize(mesh1()))
    want = run(ref_g, _ref_scale_kernel, ref_coord, ref_res.ResilientRunner,
               "r")
    assert got == want


# -- sealed records, files, census ------------------------------------

@pytest.mark.parametrize("payload", ["", "x", '{"rank": 3, "ok": true}',
                                     "ünïcode:with:colons"])
def test_seal_record_bytes_equal_reference(payload):
    sealed = coord.seal_record(payload)
    assert sealed == ref_coord.seal_record(payload)
    assert coord.unseal_record(sealed, "k") == payload
    assert ref_coord.unseal_record(sealed, "k") == payload


@pytest.mark.parametrize("damage", ["truncate", "flip", "garbage"])
def test_torn_record_is_convicted(damage):
    sealed = coord.seal_record('{"epoch": 7}')
    torn = {"truncate": sealed[:-2],
            "flip": sealed[:-1] + ("8" if sealed[-1] != "8" else "9"),
            "garbage": "not a frame"}[damage]
    with pytest.raises(coord.TornRecordError) as ei:
        coord.unseal_record(torn, "lease/j")
    assert ei.value.key == "lease/j"
    with pytest.raises(ref_coord.TornRecordError) as ej:
        ref_coord.unseal_record(torn, "lease/j")
    assert str(ei.value) == str(ej.value)


def test_sealed_file_roundtrip_and_torn(tmp_path):
    p = str(tmp_path / "rec.json")
    coord.write_sealed_file(p, "payload-1")
    assert coord.read_sealed_file(p) == "payload-1"
    assert ref_coord.read_sealed_file(p) == "payload-1"
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]
    with open(p, "a") as f:
        f.write("x")
    with pytest.raises(coord.TornRecordError):
        coord.read_sealed_file(p)


def test_prefix_census_normalizes_keys():
    class Relative(coord.InMemoryKV):
        def dir_get(self, prefix):
            return {k[len(prefix) + 1:]: v
                    for k, v in super().dir_get(prefix + "/").items()}

    for kv in (coord.InMemoryKV(), Relative()):
        kv.set("jobs/a", "1")
        kv.set("jobs/b", "2")
        kv.set("other/c", "3")
        assert coord.prefix_census(kv, "jobs") == {"jobs/a": "1",
                                                   "jobs/b": "2"}
    assert coord.prefix_census(object(), "jobs") is None


# -- kv_barrier with threads as ranks ---------------------------------

def _threads(fn, ranks):
    out, errs = {}, {}

    def run(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 - inspected below
            errs[r] = e

    ts = [threading.Thread(target=run, args=(r,)) for r in ranks]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    return out, errs


def test_kv_barrier_gathers_every_rank():
    kv = coord.InMemoryKV()
    out, errs = _threads(lambda r: coord.kv_barrier(
        kv, "round/1", r, range(3), timeout=10, value=f"d{r}"), range(3))
    assert not errs
    for r in range(3):
        assert out[r] == {0: "d0", 1: "d1", 2: "d2"}


def test_kv_barrier_stale_fence_convicts_the_zombie():
    kv = coord.InMemoryKV()
    kv.set("fence", "5")

    def zombie(_r):
        return coord.kv_barrier(kv, "round/z", 0, [0, 1], timeout=10,
                                fence=("fence", "5"))

    t = threading.Thread(target=lambda: (time.sleep(0.1),
                                         kv.set("fence", "6")))
    t.start()
    with pytest.raises(coord.StaleFenceError) as ei:
        zombie(0)
    t.join()
    assert ei.value.expected == "5" and ei.value.observed == "6"


def test_kv_barrier_abort_marker_and_veto():
    kv = coord.InMemoryKV()

    def aborter():
        time.sleep(0.1)
        kv.set("round/a/abort", coord.seal_record(
            json.dumps({"rank": 2, "reason": "adapt failed"})))

    t = threading.Thread(target=aborter)
    t.start()
    with pytest.raises(coord.RemoteAbortError) as ei:
        coord.kv_barrier(kv, "round/a", 0, [0, 2], timeout=10,
                         abort_key="round/a/abort")
    t.join()
    assert ei.value.rank == 2 and ei.value.reason == "adapt failed"
    # every rank arrived, but the marker vetoes completion; a torn
    # marker aborts anonymously
    kv.set("round/b/1", "1")
    kv.set("round/b/abort", "torn")
    with pytest.raises(coord.RemoteAbortError) as ei:
        coord.kv_barrier(kv, "round/b", 0, [0, 1], timeout=5,
                         abort_key="round/b/abort")
    assert ei.value.rank == -1


def test_kv_barrier_peer_dead_and_timeout():
    kv = coord.InMemoryKV()
    clk = FakeClock()
    m = coord.Membership(0, 2, kv=kv, heartbeat_s=1.0, lease_s=4.0,
                         clock=clk)
    clk.advance(10.0)
    with pytest.raises(coord.PeerDeadError) as ei:
        coord.kv_barrier(kv, "round/d", 0, [0, 1], timeout=5,
                         membership=m)
    assert ei.value.ranks == [1]
    t0 = time.monotonic()
    with pytest.raises(coord.BarrierTimeoutError) as ei:
        coord.kv_barrier(kv, "round/t", 0, [0, 1], timeout=0.3)
    assert ei.value.tag == "round/t" and time.monotonic() - t0 < 3.0


# -- membership (tests/test_fleet_elastic.py) -------------------------

def test_membership_classification_and_gauges():
    kv = coord.InMemoryKV()
    clk = FakeClock()
    a = coord.Membership(0, 2, kv=kv, heartbeat_s=1.0, lease_s=4.0,
                         clock=clk)
    b = coord.Membership(1, 2, kv=kv, heartbeat_s=1.0, lease_s=4.0,
                         clock=clk)
    a.heartbeat(force=True)
    b.heartbeat(force=True)
    assert a.poll() == {1: "live"}
    clk.advance(2.5)
    assert a.poll() == {1: "suspect"}
    clk.advance(2.0)
    assert a.poll() == {1: "dead"}
    assert a.dead_ranks() == [1] and a.live_ranks() == [0]
    assert a.detect_dead_ranks() == [1]
    b.heartbeat(force=True)
    assert a.poll() == {1: "live"}
    assert a.live_ranks() == [0, 1]
    reg = telemetry.registry()
    assert reg.gauges[("dccrg_fleet_membership",
                       (("state", "live"),))] == 2.0
    assert reg.gauges[("dccrg_fleet_membership",
                       (("state", "dead"),))] == 0.0
    assert reg.counter_value("dccrg_fleet_membership_transitions_total",
                             rank="1", state="dead") == 1


def test_membership_grace_for_slow_starters():
    kv = coord.InMemoryKV()
    clk = FakeClock(100.0)
    a = coord.Membership(0, 2, kv=kv, heartbeat_s=1.0, lease_s=4.0,
                         clock=clk)
    assert a.poll() == {1: "live"}
    clk.advance(3.9)
    assert a.poll() == {1: "suspect"}
    clk.advance(0.2)
    assert a.poll() == {1: "dead"}


def test_membership_poll_never_blocks():
    class WedgedKV(coord.InMemoryKV):
        def get(self, key):
            time.sleep(5.0)
            return super().get(key)

    clk = FakeClock()
    a = coord.Membership(0, 2, kv=WedgedKV(), heartbeat_s=1.0,
                         lease_s=4.0, clock=clk)
    t0 = time.monotonic()
    states = a.poll(timeout=0.05)
    assert time.monotonic() - t0 < 2.0
    assert states == {1: "live"}
    assert telemetry.registry().counter_value(
        "dccrg_membership_poll_failures_total") >= 1


def test_peer_dead_error_names_the_rank():
    kv = coord.InMemoryKV()
    clk = FakeClock()
    a = coord.Membership(0, 2, kv=kv, heartbeat_s=1.0, lease_s=4.0,
                         clock=clk)
    clk.advance(10.0)
    a.poll()
    assert a.dead_ranks() == [1]
    coord.set_membership(a)
    try:
        with pytest.raises(coord.PeerDeadError) as ei:
            coord.barrier("elastic-test", timeout=0.5)
        assert ei.value.ranks == [1]
        assert "rank(s) [1]" in str(ei.value)
        assert isinstance(ei.value, coord.BarrierTimeoutError)
        assert ei.value.tag == "elastic-test"
    finally:
        coord.set_membership(None)
    coord.barrier("elastic-test", timeout=0.5)


def test_membership_knobs_and_auto_heartbeat(monkeypatch):
    monkeypatch.setenv("DCCRG_HEARTBEAT_S", "0.02")
    monkeypatch.setenv("DCCRG_LEASE_S", "0.01")
    assert coord.heartbeat_seconds() == ref_coord.heartbeat_seconds() == 0.02
    # clamped to two heartbeats, as the reference clamps it
    assert coord.lease_seconds() == ref_coord.lease_seconds() == 0.04
    kv = coord.InMemoryKV()
    m = coord.Membership(0, 2, kv=kv)
    m.start_auto()
    m.start_auto()  # idempotent
    time.sleep(0.2)
    m.stop_auto()
    beats = int(kv.get("dccrg/hb/0"))
    assert beats >= 2
    time.sleep(0.1)
    assert int(kv.get("dccrg/hb/0")) <= beats + 1


# -- the store-backed KV ----------------------------------------------

def test_coord_kv_on_a_tcp_store():
    store = torch.distributed.TCPStore("127.0.0.1", 0, 1, True)
    kv = coord.CoordKV(store)
    t0 = time.monotonic()
    assert kv.get("absent") is None  # checked, never a blocking get
    assert time.monotonic() - t0 < 1.0
    assert kv.create("lease/j", "r0")
    assert not kv.create("lease/j", "r1")  # first writer wins
    assert kv.get("lease/j") == "r0"
    kv.set("hb/0", "1")
    kv.set("hb/1", "4")
    kv.set("hb/1", "5")  # indexed once
    kv.set("hbx/9", "x")
    assert kv.dir_get("hb/") == {"hb/0": "1", "hb/1": "5"}
    assert coord.prefix_census(kv, "hb") == {"hb/0": "1", "hb/1": "5"}
    assert kv.dir_get("lease/") == {"lease/j": "r0"}
    kv.delete("hb/0")
    assert kv.dir_get("hb/") == {"hb/1": "5"}
    assert kv.dir_get("nothing/") == {}
    # the membership and the barrier ride it unchanged
    m = coord.Membership(0, 2, kv=kv, heartbeat_s=1.0, lease_s=4.0)
    assert m.heartbeat(force=True) and kv.get("dccrg/hb/0") == "1"
    assert coord.kv_barrier(kv, "kvb", 0, [0], timeout=5) == {0: "1"}
    assert isinstance(coord.default_kv(), coord.InMemoryKV)


# -- a real two-rank gloo group over localhost ------------------------

_WORKER = r"""
import json, sys
import numpy as np
import torch
from dccrg_tpu_torch import Grid, coord, faults

r, port = int(sys.argv[1]), sys.argv[2]
coord.distributed_init(f"127.0.0.1:{port}", 2, r, retries=20, backoff=0.1)
out = {}
coord.barrier("start", timeout=30)
g = (Grid(cell_data={"v": torch.float32}).set_initial_length((4, 4, 4))
     .set_neighborhood_length(1).initialize(["cpu"] * 2))
g._proc_local_dev = np.array([d == r for d in range(2)])
out["consensus"] = coord.trip_consensus(g, 3 if r == 1 else 1)
kv = coord.default_kv()
out["kv_type"] = type(kv).__name__
out["kv"] = coord.kv_barrier(kv, "kvb", r, [0, 1], timeout=30,
                             value=f"v{r}")
out["create"] = kv.create("lease/j", f"r{r}")
coord.barrier("mid", timeout=30)
out["lease"] = kv.get("lease/j")
plan = faults.FaultPlan()
if r == 1:
    plan.barrier_hang(tag="lost", hang_s=4.0)
t0 = __import__("time").monotonic()
with plan:
    try:
        coord.barrier("lost", timeout=1.5)
        out["lost"] = "passed"
    except coord.BarrierTimeoutError as e:
        out["lost"] = e.tag
out["lost_s"] = __import__("time").monotonic() - t0
print("RESULT " + json.dumps(out), flush=True)
coord.barrier("end", timeout=30)
torch.distributed.destroy_process_group()
# the abandoned barrier threads are daemons: leave without finalizers
__import__("os")._exit(0)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_gloo_group(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    res = {}
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err[-2000:]
            line = [ln for ln in out.splitlines()
                    if ln.startswith("RESULT ")][-1]
            res[r] = json.loads(line[len("RESULT "):])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r in range(2):
        assert res[r]["consensus"] == 3  # MAX over the group
        assert res[r]["kv_type"] == "CoordKV"
        assert res[r]["kv"] == {"0": "v0", "1": "v1"}
        assert res[r]["lost"] == "lost"  # the tag is named
        assert res[r]["lost_s"] < 10.0
    assert sorted([res[0]["create"], res[1]["create"]]) == [False, True]
    winner = 0 if res[0]["create"] else 1
    assert res[0]["lease"] == res[1]["lease"] == f"r{winner}"
