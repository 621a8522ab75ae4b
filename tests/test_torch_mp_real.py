"""Real process deaths in a two-rank gloo group on localhost: the port's
counterparts of the ``tests/mp_harness.py`` scenarios of the two-phase
checkpoint save and the distributed AMR commit that kill a real rank.

Each case starts two OS processes that form a ``torch.distributed``
group (gloo) over a free localhost port; each holds a four-partition
CPU grid of which it owns two partitions (``_proc_local_dev``). A
``FaultPlan.rank_death`` ends rank 1's process (``os._exit``) at the
named phase; the survivor must get a typed timeout or abort within its
barrier bound and keep the previous checkpoint, or the old plan, byte
for byte. Marked ``slow``: each case waits out a barrier timeout.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEATH_RC = 17

_WORKER = r"""
import json, os, sys, zlib
import numpy as np
import torch
from dccrg_tpu_torch import Grid, coord, distamr, faults, resilience, txn
from dccrg_tpu_torch import background

r, port, out_dir, scenario, phase = (int(sys.argv[1]), sys.argv[2],
                                     sys.argv[3], sys.argv[4], sys.argv[5])
coord.distributed_init(f"127.0.0.1:{port}", 2, r, retries=20, backoff=0.1)
os.environ["DCCRG_BARRIER_TIMEOUT"] = "20"
MINE = (0, 1) if r == 0 else (2, 3)


def mk(max_lvl=0):
    g = (Grid(cell_data={"v": torch.float32, "w": torch.int32})
         .set_initial_length((8, 8, 4)).set_maximum_refinement_level(max_lvl)
         .set_neighborhood_length(1)
         .initialize(["cpu"] * 4, partition="block"))
    cells = g.plan.cells
    g.set_many(cells, {"v": (cells % np.uint64(11)).astype(np.float32),
                       "w": (cells % np.uint64(7)).astype(np.int32)})
    g._proc_local_dev = np.array([d in MINE for d in range(4)])
    return g


def local_crc(g):
    cells = g.plan.cells
    mine = cells[g._proc_local_dev[g.plan.owner]]
    return zlib.crc32(g.get("v", mine).tobytes())


out = {}
try:
    if scenario in ("rank_kill", "async_kill", "delta_kill"):
        g = mk()
        fn = os.path.join(out_dir, "k.dc")
        resilience.save_checkpoint(g, fn)
        if scenario == "delta_kill":
            g.set("v", g.plan.cells, np.full(len(g.plan.cells), 3.0,
                                             np.float32))
            d1 = os.path.join(out_dir, "k_1.dcd")
            resilience.save_delta_checkpoint(
                g, d1, parent_path=fn, parent_step=0, step=1,
                fields=["v"])
            keep = [fn, d1]
        else:
            keep = [fn]
        good = {p: open(p, "rb").read() for p in keep}
        coord.barrier("good", timeout=30)
        os.environ["DCCRG_BARRIER_TIMEOUT"] = "4"
        g.set("v", g.plan.cells, np.full(len(g.plan.cells), 123.0,
                                         np.float32))
        plan = faults.FaultPlan(seed=3)
        if r == 1:
            plan.rank_death(phase=phase, rank=None)
        try:
            with plan:
                if scenario == "async_kill":
                    saver = background.AsyncSaver()
                    frozen = background.freeze_grid_mp(g)
                    saver.submit(lambda: resilience.save_checkpoint(frozen, fn))
                    saver.drain()
                elif scenario == "delta_kill":
                    resilience.save_delta_checkpoint(
                        g, os.path.join(out_dir, "k_2.dcd"),
                        parent_path=fn, parent_step=0, step=2,
                        fields=["v"])
                else:
                    resilience.save_checkpoint(g, fn)
            out["save"] = "completed"
        except faults.InjectedRankDeath:
            raise
        except Exception as e:  # noqa: BLE001 - reported
            out["save"] = type(e).__name__
        out["intact"] = all(open(p, "rb").read() == good[p] for p in keep)
        out["verify"] = resilience.verify_checkpoint(fn)
        if scenario == "delta_kill":
            out["chain"] = len(resilience.verify_chain(keep[-1]))
        back = mk()
        back.set("v", back.plan.cells, np.zeros(len(back.plan.cells),
                                                np.float32))
        os.environ["DCCRG_BARRIER_TIMEOUT"] = "1"
        back.load_grid_data(fn)
        cells = back.plan.cells
        mine = cells[back._proc_local_dev[back.plan.owner]]
        out["load_ok"] = bool(np.array_equal(
            back.get("v", mine), (mine % np.uint64(11)).astype(np.float32)))
    elif scenario in ("amr_commit", "amr_kill"):
        sites = dict(enumerate(faults.DIST_AMR_FAULT_SITES))
        g = mk(max_lvl=1)
        group = g.enable_distributed_amr(timeout=20)
        assert group.n_ranks == 2 and group.rank == r
        cells = g.plan.cells
        picks = [int(c) for c in cells[np.isin(g.plan.owner, MINE)][:12:3]]
        for c in picks:
            g.refine_completely(c)
        pre = (distamr.plan_digest(g.plan), local_crc(g))
        if scenario == "amr_commit":
            new = g.stop_refining()
            g.assign_children_from_parents(fields=["v"])
            out["new"] = int(len(new))
            out["fence"] = group.read_fence()
            out["pdig"] = distamr.plan_digest(g.plan)
            out["cells_crc"] = zlib.crc32(g.plan.cells.tobytes())
        else:
            site, ph = sites[int(phase)]
            group.timeout = 4
            plan = faults.FaultPlan(seed=5)
            if r == 1:
                plan.rank_death(site=site, phase=ph, rank=None)
            with plan:
                try:
                    g.stop_refining()
                    out["commit"] = "committed"
                except txn.CrossRankAbortedError as e:
                    out["commit"] = type(e.__cause__).__name__
            out["same"] = (distamr.plan_digest(g.plan), local_crc(g)) == pre
            out["requests"] = sorted(g._refines) == sorted(picks)
            out["fence"] = group.read_fence()
except faults.InjectedRankDeath:
    os._exit(DEATH_RC)
print("RESULT " + json.dumps(out), flush=True)
if scenario == "amr_commit":
    # rank 0 hosts the group's store and leaves once every rank arrived;
    # a peer polling the store after that sees it gone, which is fine
    try:
        coord.barrier("end", timeout=60)
    except Exception:
        pass
os._exit(0)
""".replace("DEATH_RC", str(DEATH_RC))


# ---------------------------------------------------------------------
# rank-held grids: each rank holds only its own partitions
# (Grid.initialize(coord.rank_devices(2, "cpu"))), the harness's
# sdc_rank and three-phase preempt scenarios
# ---------------------------------------------------------------------

PREEMPT_STEPS = 8
RESUMABLE_RC = 75

_HELD_WORKER = r"""
import json, os, sys, time, zlib
import numpy as np
import torch
from dccrg_tpu_torch import Grid, checkpoint, coord, faults, resilience
from dccrg_tpu_torch import supervise

r, port, out_dir, scenario = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                              sys.argv[4])
coord.distributed_init(f"127.0.0.1:{port}", 2, r, retries=20, backoff=0.1)
os.environ["DCCRG_BARRIER_TIMEOUT"] = "20"
PLACE = coord.rank_devices(2, "cpu")
SEED = 5


def mk():
    # the harness's _mk_grid (tests/mp_harness.py:272): block, so a
    # rollback's load_cells keeps every cell on its rank
    g = (Grid(cell_data={"v": torch.float32})
         .set_initial_length((8, 8, 4)).set_periodic(True, True, False)
         .set_maximum_refinement_level(0).set_neighborhood_length(1)
         .set_load_balancing_method("block").initialize(PLACE))
    cells = g.plan.cells
    g.set("v", cells, (cells.astype(np.float64) * (SEED + 3) % 97)
          .astype(np.float32))
    g.update_copies_of_remote_neighbors()
    return g


def digest(g):
    cells = g.plan.cells
    return zlib.crc32(checkpoint._replicated_pull(g, "v", cells).tobytes())


def sup_kernel(c, nbr, offs, mask):
    return {"v": 0.5 * c["v"] + 0.125 * torch.sum(
        torch.where(mask, nbr["v"], 0.0), dim=1)}


def supervised(store, sleep_s=0.0, grid=None, start_step=0):
    g = grid if grid is not None else mk()
    prog = os.path.join(store, f"progress.rank{r}")

    def step_fn(grid_, i):
        grid_.run_steps(sup_kernel, ["v"], ["v"], 1)
        if sleep_s:
            time.sleep(sleep_s)
        with open(prog, "w") as f:
            f.write(str(i))

    sup = supervise.SupervisedRunner(
        g, step_fn, store, check_every=100, checkpoint_every=3,
        backoff=0.0, keep_last=16, grace=20.0, start_step=start_step,
        diagnostics_dir=store)
    return g, sup


out = {"held": None}
rc = 0
if scenario == "sdc_rank":
    def kern(c, n, o, m):
        # a conservative relaxation: sum(v) is exact in real arithmetic
        s = torch.sum(torch.where(m, n["v"], 0.0), dim=1)
        deg = torch.sum(m, dim=1).to(c["v"].dtype)
        return {"v": c["v"] + 0.02 * (s - deg * c["v"])}

    def runner(name):
        g = mk()
        return resilience.ResilientRunner(
            g, lambda grid, i: grid.run_steps(kern, ["v"], ["v"], 1),
            os.path.join(out_dir, f"{name}.dc"), check_every=2,
            checkpoint_every=2, backoff=0.0, conserved_fields=("v",),
            diagnostics_dir=out_dir), g

    ref, ref_g = runner("sdc_ref")
    ref.run(6)
    out["ref_trips"] = len(ref.trips)
    want = digest(ref_g)
    run, g = runner("sdc")
    out["held"] = [int(x) for x in g._held]
    out["shape"] = list(g.data["v"].shape)
    plan = None
    if r == 1:
        cells = g.plan.cells
        mine = cells[g._proc_local_dev[g.plan.owner]]
        victim = mine[int(np.argmax(g.get("v", mine)))]
        plan = faults.FaultPlan(seed=SEED)
        plan.silent_flip("v", step=3, cells=[int(victim)], bit=23)
        plan.__enter__()
    try:
        run.run(6)
    finally:
        if plan is not None:
            plan.__exit__(None, None, None)
    out["fired"] = plan.fired("step.flip") if plan is not None else 0
    out["step"] = run.step
    out["rollbacks"] = run.rollbacks
    out["trip_fields"] = list(run.trips[0]["fields"]) if run.trips else []
    out["digest"] = digest(g)
    out["same_as_ref"] = out["digest"] == want
else:
    store = os.path.join(out_dir, "store")
    os.makedirs(store, exist_ok=True)
    if scenario == "preempt_ref":
        g, sup = supervised(store)
        sup.run(PREEMPT_STEPS)
        out["held"] = [int(x) for x in g._held]
        out["digest"] = digest(g)
    elif scenario == "preempt_kill":
        g, sup = supervised(store, sleep_s=0.4)
        try:
            sup.run(PREEMPT_STEPS)
            out["preempted"] = False
        except supervise.PreemptedError as e:
            out["preempted"] = True
            out["checkpoint"] = e.checkpoint
            out["verify"] = resilience.verify_checkpoint(e.checkpoint)
            rc = RESUMABLE_RC
    else:
        info = supervise.resume_latest(store, {"v": torch.float32},
                                       device=PLACE)
        g = info.grid
        out["held"] = [int(x) for x in g._held]
        out["step"] = info.step
        out["clean"] = bool(not info.salvaged and info.report.clean)
        g.update_copies_of_remote_neighbors()
        g, sup = supervised(store, grid=g, start_step=info.step)
        sup.run(PREEMPT_STEPS)
        out["final"] = sup.step
        out["digest"] = digest(g)
print("RESULT " + json.dumps(out), flush=True)
try:
    coord.barrier("end", timeout=30)
except Exception:
    pass
os._exit(rc)
""".replace("PREEMPT_STEPS", str(PREEMPT_STEPS)).replace(
    "RESUMABLE_RC", str(RESUMABLE_RC))


def _held_start(tmp_path, scenario, port):
    script = tmp_path / "held_worker.py"
    script.write_text(_HELD_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT)
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port), str(tmp_path),
         scenario], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]


def _held_results(procs, timeout=180):
    res = {}
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            lines = [ln for ln in out.splitlines()
                     if ln.startswith("RESULT ")]
            res[r] = (json.loads(lines[-1][len("RESULT "):]) if lines
                      else {"stderr": err[-3000:]})
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return res


def test_real_sdc_on_one_rank_is_convicted_on_both(tmp_path):
    """The harness's ``sdc_rank`` (tests/mp_harness.py:533) on
    rank-held grids: a finite bit flip in rank 1's held rows is seen by
    the conservation invariant (its sums reduced over the group), both
    ranks trip and roll back together, and the recovered run is bit
    for bit the undisturbed one."""
    procs = _held_start(tmp_path, "sdc_rank", _free_port())
    res = _held_results(procs)
    assert [p.returncode for p in procs] == [0, 0], res
    assert res[1]["fired"] == 1, res
    for r in (0, 1):
        out = res[r]
        assert out["shape"][0] == 2 and out["held"] == [2 * r, 2 * r + 1]
        assert out["ref_trips"] == 0 and out["step"] == 6, out
        assert out["rollbacks"] == 1, out
        assert "v" in out["trip_fields"] \
            or "remote_rank_corrupt" in out["trip_fields"], out
        assert out["same_as_ref"], out
    assert res[0]["digest"] == res[1]["digest"]


def test_real_sigterm_preempts_both_ranks_and_resumes_bitwise(tmp_path):
    """The harness's three-phase ``preempt`` (tests/mp_harness.py:
    804-845) on rank-held grids: an uninterrupted supervised run; a
    real SIGTERM to rank 1 mid-run, which the trip consensus spreads so
    both ranks take the collective emergency save and exit 75; the
    resume from that checkpoint onto rank-held partitions, whose final
    state is bit for bit the uninterrupted run's."""
    import signal
    import time

    store = tmp_path / "store"
    ref = _held_results(_held_start(tmp_path, "preempt_ref", _free_port()))
    assert ref[0]["digest"] == ref[1]["digest"], ref
    for f in store.iterdir():  # the kill phase starts from an empty store
        f.unlink()
    procs = _held_start(tmp_path, "preempt_kill", _free_port())
    prog = store / "progress.rank1"
    sent, deadline = False, time.monotonic() + 120
    while not sent and time.monotonic() < deadline:
        if any(p.poll() is not None for p in procs):
            break
        try:
            if int(prog.read_text().strip() or "-1") >= 1:
                procs[1].send_signal(signal.SIGTERM)
                sent = True
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    kill = _held_results(procs)
    assert sent, kill
    assert [p.returncode for p in procs] == [RESUMABLE_RC] * 2, kill
    for r in (0, 1):
        assert kill[r]["preempted"] and kill[r]["verify"] == [], kill
    res = _held_results(_held_start(tmp_path, "preempt_resume",
                                    _free_port()))
    for r in (0, 1):
        out = res[r]
        assert out["held"] == [2 * r, 2 * r + 1] and out["clean"], out
        assert 0 < out["step"] < PREEMPT_STEPS, out
        assert out["final"] == PREEMPT_STEPS, out
        assert out["digest"] == ref[0]["digest"], (out, ref)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(tmp_path, scenario, phase="-"):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port), str(tmp_path),
         scenario, str(phase)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    res, rcs = {}, {}
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=120)
            rcs[r] = p.returncode
            lines = [ln for ln in out.splitlines()
                     if ln.startswith("RESULT ")]
            if lines:
                res[r] = json.loads(lines[-1][len("RESULT "):])
            else:
                res[r] = {"stderr": err[-3000:]}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return rcs, res


@pytest.mark.parametrize("scenario,phase", [
    ("rank_kill", "slice"), ("rank_kill", "written"),
    ("rank_kill", "meta"), ("async_kill", "slice"),
    ("delta_kill", "slice"), ("delta_kill", "written"),
])
def test_real_rank_death_keeps_the_previous_checkpoint(tmp_path, scenario,
                                                       phase):
    """Rank 1's process ends at the phase: rank 0 (the committer) gets a
    typed error, the previous file (and delta chain) stays byte for
    byte and verifies, and rank 0 loads its own cells from it."""
    rcs, res = _run(tmp_path, scenario, phase)
    assert rcs[1] == DEATH_RC, res.get(1)
    assert rcs[0] == 0, res.get(0)
    out = res[0]
    assert out["save"] in ("BarrierTimeoutError", "CheckpointCommitError",
                           "PeerDeadError"), out
    assert out["intact"] and out["verify"] == []
    if scenario == "delta_kill":
        assert out["chain"] == 2
    assert out["load_ok"]


def test_real_distributed_amr_commit(tmp_path):
    rcs, res = _run(tmp_path, "amr_commit")
    assert rcs == {0: 0, 1: 0}, res
    assert res[0]["fence"] == res[1]["fence"] == 1
    assert res[0]["pdig"] == res[1]["pdig"]
    assert res[0]["cells_crc"] == res[1]["cells_crc"]
    assert res[0]["new"] == res[1]["new"] == 8 * 8


@pytest.mark.parametrize("site", range(4))
def test_real_rank_death_aborts_the_amr_round(tmp_path, site):
    """Rank 1's process ends at each DIST_AMR_FAULT_SITES point: rank 0
    aborts typed and keeps its plan, rows, requests and fence."""
    rcs, res = _run(tmp_path, "amr_kill", site)
    assert rcs[1] == DEATH_RC, res.get(1)
    assert rcs[0] == 0, res.get(0)
    out = res[0]
    assert out["commit"] in ("BarrierTimeoutError", "PeerDeadError"), out
    assert out["same"] and out["requests"] and out["fence"] == 0
