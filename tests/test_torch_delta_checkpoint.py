"""The port's incremental (delta) checkpoints against the reference's,
on the CPU: ``resilience.save_delta_checkpoint``, the dirty-field
tracking of ``Grid`` and ``supervise.CheckpointStore.save``.

The counterparts of ``tests/test_delta_checkpoint.py`` but for its
two-phase multi-process cases: bitwise keyframe+delta reconstruction,
the keyframe-forcing rules, chain-aware rollback and resume, parent-link
corruption, torn delta writes, the chain-aware retention GC and its
fuzzed properties, stale litter and the chain CLI. Then the port
against the reference: a store run writes the same ``.dc``/``.dcd``
files and sidecars byte for byte, each package resumes the other's
chain bit for bit, and after every public mutator of ``Grid`` a delta
save replayed through its chain gives the bytes of a full save.
Grids of two partitions (the reference on two devices).
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dccrg_tpu import supervise as ref_sup
from dccrg_tpu.grid import Grid as RefGrid

import torch

from dccrg_tpu_torch import checkpoint as checkpoint_mod
from dccrg_tpu_torch import faults, resilience, supervise
from dccrg_tpu_torch.grid import Grid
from dccrg_tpu_torch.resilience import DeltaChainError
from dccrg_tpu_torch.supervise import CheckpointStore, gc_checkpoints

# a static-heavy schema: "rho" is the stepped field, "mat" and "tag"
# never change after init
NP_SCHEMA = {"rho": ((), np.float32), "mat": ((16,), np.float32),
             "tag": ((), np.int32)}
SCHEMA = {"rho": torch.float32, "mat": ((16,), torch.float32),
          "tag": torch.int32}
REF_SCHEMA = {"rho": jnp.float32, "mat": ((16,), jnp.float32),
              "tag": jnp.int32}


def _fill(g, seed, schema=NP_SCHEMA):
    rng = np.random.default_rng(seed)
    cells = g.plan.cells
    for name, (shape, dtype) in schema.items():
        g.set(name, cells,
              (rng.random((len(cells),) + shape) * 100).astype(dtype))


def _mk_grid(seed=0, n=(4, 4, 2), max_lvl=1, n_dev=2, schema=None,
             np_schema=None):
    g = (Grid(cell_data=schema or SCHEMA)
         .set_initial_length(n)
         .set_periodic(True, True, True)
         .set_maximum_refinement_level(max_lvl)
         .set_neighborhood_length(1)
         .set_load_balancing_method("block")
         .initialize(["cpu"] * n_dev))
    _fill(g, seed, np_schema or NP_SCHEMA)
    return g


def _ref_mesh(n_dev=2):
    return Mesh(np.array(jax.devices()[:n_dev]), ("dev",))


def _mk_ref(seed=0, n=(4, 4, 2), max_lvl=1, n_dev=2):
    g = (RefGrid(cell_data=REF_SCHEMA)
         .set_initial_length(n)
         .set_periodic(True, True, True)
         .set_maximum_refinement_level(max_lvl)
         .set_neighborhood_length(1)
         .set_load_balancing_method("block")
         .initialize(_ref_mesh(n_dev)))
    _fill(g, seed)
    return g


def _step(g, rng):
    """A 'stepped field' change: rho only, like a step loop."""
    cells = g.plan.cells
    g.set("rho", cells, rng.random(len(cells)).astype(np.float32))


def _full_bytes(g, tmp_path, name="__direct.dc"):
    p = str(tmp_path / name)
    g.save_grid_data(p)
    with open(p, "rb") as f:
        data = f.read()
    os.unlink(p)
    return data


def _materialized_bytes(path, fields):
    out = path + ".chain.test"
    try:
        resilience.materialize_chain(path, out, fields)
        with open(out, "rb") as f:
            return f.read()
    finally:
        if os.path.exists(out):
            os.unlink(out)


def _values(g):
    cells = g.plan.cells
    return {n: np.asarray(g.get(n, cells)) for n in NP_SCHEMA}


# ---------------------------------------------------------------------
# the save policy + bitwise reconstruction
# ---------------------------------------------------------------------

def test_delta_roundtrip_bitwise_and_resume(tmp_path):
    g = _mk_grid()
    rng = np.random.default_rng(1)
    store = CheckpointStore(tmp_path, keyframe_every=8)
    assert store.save(g, 0).endswith(".dc")
    for step in (1, 2, 3):
        _step(g, rng)
        p = store.save(g, step)
        assert p.endswith(".dcd"), p
        assert resilience.read_sidecar(p)["delta"]["fields"] == ["rho"]
        assert _materialized_bytes(p, g.fields) == _full_bytes(g, tmp_path)
    info = supervise.resume_latest(tmp_path, SCHEMA, device="cpu")
    assert info.step == 3 and not info.salvaged
    assert len(info.report.chain) == 4  # keyframe + 3 deltas
    want = _values(g)
    for name, vals in _values(info.grid).items():
        np.testing.assert_array_equal(vals, want[name])


def test_keyframe_cadence_and_optout(tmp_path, monkeypatch):
    g = _mk_grid()
    rng = np.random.default_rng(2)
    store = CheckpointStore(tmp_path / "a", keyframe_every=3)
    kinds = []
    for step in range(7):
        _step(g, rng)
        kinds.append(store.save(g, step).endswith(".dcd"))
    assert kinds == [False, True, True, False, True, True, False]
    monkeypatch.setenv("DCCRG_DELTA", "0")
    store2 = CheckpointStore(tmp_path / "b", keyframe_every=3)
    for step in range(3):
        _step(g, rng)
        assert store2.save(g, step).endswith(".dc")


def test_keyframe_every_env_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("DCCRG_KEYFRAME_EVERY", "2")
    assert CheckpointStore(tmp_path).keyframe_every == 2
    monkeypatch.setenv("DCCRG_KEYFRAME_EVERY", "zero")
    assert CheckpointStore(tmp_path).keyframe_every == 8
    assert supervise.keyframe_every_default() == \
        ref_sup.keyframe_every_default()


def test_structural_mutation_forces_keyframe(tmp_path):
    g = _mk_grid()
    rng = np.random.default_rng(3)
    store = CheckpointStore(tmp_path, keyframe_every=50)
    store.save(g, 0)
    _step(g, rng)
    assert store.save(g, 1).endswith(".dcd")
    g.refine_completely(int(g.plan.cells[0]))
    g.stop_refining()
    assert store.save(g, 2).endswith(".dc")  # new structure epoch
    _step(g, rng)
    assert store.save(g, 3).endswith(".dcd")
    g.balance_load()  # a partition change ends the epoch too
    assert store.save(g, 4).endswith(".dc")


def test_ragged_and_all_dirty_force_keyframe(tmp_path):
    schema = {"rho": torch.float32, "count": torch.int32,
              "pos": ((4, 3), torch.float32)}
    np_schema = {"rho": ((), np.float32), "count": ((), np.int32),
                 "pos": ((4, 3), np.float32)}
    g = _mk_grid(schema=schema, np_schema=np_schema)
    cells = g.plan.cells
    g.set("count", cells, np.full(len(cells), 2, np.int32))
    variable = {"pos": "count"}
    store = CheckpointStore(tmp_path, keyframe_every=50)
    store.save(g, 0, variable=variable)
    g.set("pos", cells, np.zeros((len(cells), 4, 3), np.float32))
    assert store.save(g, 1, variable=variable).endswith(".dc")
    g.set("rho", cells, np.ones(len(cells), np.float32))
    assert store.save(g, 2, variable=variable).endswith(".dcd")
    for name in schema:
        g.set(name, cells, np.asarray(g.get(name, cells)))
    assert store.save(g, 3, variable=variable).endswith(".dc")
    with pytest.raises(ValueError, match="ragged"):
        resilience.save_delta_checkpoint(
            g, str(tmp_path / "x.dcd"), parent_path=store.path_for(3),
            parent_step=3, step=4, fields=["pos"], variable=variable)


def test_delta_bytes_are_small(tmp_path):
    g = _mk_grid(n=(8, 8, 4), max_lvl=0)
    rng = np.random.default_rng(4)
    store = CheckpointStore(tmp_path, keyframe_every=8)
    kf = store.save(g, 0)
    _step(g, rng)
    dp = store.save(g, 1)
    assert dp.endswith(".dcd")
    # full = 16 B pairs + 4 B rho + 64 B mat + 4 B tag per cell;
    # delta = 16 B pairs + 4 B rho per cell
    assert os.path.getsize(dp) < 0.3 * os.path.getsize(kf)


# ---------------------------------------------------------------------
# chain-aware rollback + typed salvage
# ---------------------------------------------------------------------

def test_runner_rolls_back_to_delta_and_reconverges(tmp_path):
    def make(run_dir, plan=None):
        g = _mk_grid(seed=7)

        def step_fn(grid, i):
            cells = grid.plan.cells
            vals = np.asarray(grid.get("rho", cells))
            grid.set("rho", cells, (vals * 0.5 + 1.0).astype(np.float32))

        sup = supervise.SupervisedRunner(
            g, step_fn, run_dir, check_every=1, checkpoint_every=2,
            backoff=0.0, keep_last=16, install_signal_handlers=False)
        if plan is None:
            sup.run(6)
        else:
            with plan:
                sup.run(6)
        return g, sup

    ref, _ = make(str(tmp_path / "ref"))
    plan = faults.FaultPlan(seed=5)
    plan.nan_poison("rho", step=5, times=1)
    g, sup = make(str(tmp_path / "run"), plan)
    assert sup.rollbacks >= 1
    assert sup.trips[0]["checkpoint"].endswith(".dcd")
    assert sup.runner.checkpoint_path.endswith(".dc")
    cells = g.plan.cells
    np.testing.assert_array_equal(g.get("rho", cells),
                                  ref.get("rho", cells))


def _plant_chain(tmp_path, n_deltas=3, seed=11, keyframe_every=16):
    g = _mk_grid(seed=seed)
    rng = np.random.default_rng(seed)
    store = CheckpointStore(tmp_path, keyframe_every=keyframe_every)
    paths = [store.save(g, 0)]
    states = [np.asarray(g.get("rho", g.plan.cells))]
    for s in range(1, n_deltas + 1):
        _step(g, rng)
        paths.append(store.save(g, s))
        states.append(np.asarray(g.get("rho", g.plan.cells)))
    return g, store, paths, states


def test_parent_link_corruption_detected(tmp_path):
    g = _mk_grid()
    rng = np.random.default_rng(6)
    store = CheckpointStore(tmp_path, keyframe_every=16)
    store.save(g, 0)
    _step(g, rng)
    plan = faults.FaultPlan(seed=1)
    plan.delta_parent_corrupt(times=1)
    with plan:
        p1 = store.save(g, 1)
    assert plan.fired("checkpoint.delta") == 1
    assert p1.endswith(".dcd")
    with pytest.raises(DeltaChainError, match="parent digest"):
        resilience.verify_chain(p1)
    info = supervise.resume_latest(tmp_path, SCHEMA, device="cpu")
    assert info.step == 0 and not info.salvaged


def test_parent_replaced_by_different_save_detected(tmp_path):
    g, store, paths, _states = _plant_chain(tmp_path, n_deltas=1)
    g2 = _mk_grid(seed=99)
    resilience.save_checkpoint(g2, paths[0])
    assert resilience.verify_checkpoint(paths[0]) == []
    with pytest.raises(DeltaChainError, match="parent digest"):
        resilience.verify_chain(paths[1])


def test_torn_delta_write_preserves_chain(tmp_path):
    g, store, paths, states = _plant_chain(tmp_path, n_deltas=1)
    before = {p: open(p, "rb").read() for p in paths}
    _step(g, np.random.default_rng(8))
    plan = faults.FaultPlan()
    plan.chunk_io_error(times=faults.EVERY)
    with plan, pytest.raises(OSError):
        store.save(g, 2)
    assert not os.path.exists(store.path_for(2, delta=True))
    for p in paths:
        assert open(p, "rb").read() == before[p]
    assert resilience.verify_chain(paths[-1])
    info = supervise.resume_latest(tmp_path, SCHEMA, device="cpu")
    assert info.step == 1


def test_delta_at_rest_corruption_caught_by_chain_verify(tmp_path):
    g, store, paths, _states = _plant_chain(tmp_path, n_deltas=1)
    _step(g, np.random.default_rng(9))
    plan = faults.FaultPlan(seed=3)
    plan.bit_flip(times=1)
    with plan:
        p2 = store.save(g, 2)
    assert p2.endswith(".dcd") and plan.fired("checkpoint.file") == 1
    with pytest.raises(DeltaChainError):
        resilience.verify_chain(p2)
    info = supervise.resume_latest(tmp_path, SCHEMA, device="cpu")
    assert info.step == 1


# ---------------------------------------------------------------------
# chain-aware retention GC
# ---------------------------------------------------------------------

def test_gc_keeps_whole_chain_of_kept_steps(tmp_path):
    _g, store, paths, _states = _plant_chain(tmp_path, n_deltas=3)
    rep = store.gc(keep_last=1, apply=True)
    assert [s for s, _ in store.list()] == [3, 2, 1, 0]
    assert not rep.dropped


def test_gc_prunes_whole_dead_chains_keyframe_last(tmp_path):
    g, store, paths, _states = _plant_chain(tmp_path, n_deltas=2)
    g.refine_completely(int(g.plan.cells[0]))
    g.stop_refining()
    store.save(g, 3)
    _step(g, np.random.default_rng(13))
    store.save(g, 4)
    rep = store.gc(keep_last=2, apply=False)
    assert [s for s, _ in rep.dropped] == [2, 1, 0]
    store.gc(keep_last=2, apply=True)
    assert [s for s, _ in store.list()] == [4, 3]
    assert resilience.verify_chain(store.path_for(4, delta=True))


@pytest.mark.parametrize("kill_at", [0, 1, 2])
def test_gc_fault_mid_prune_never_orphans(tmp_path, kill_at):
    g, store, _p, _s = _plant_chain(tmp_path, n_deltas=2)
    g.refine_completely(int(g.plan.cells[0]))
    g.stop_refining()
    store.save(g, 3)
    plan = faults.FaultPlan()
    plan.gc_error(times=1)
    plan.rules[0].fired += kill_at  # advance the rule to unlink k
    plan.rules[0].times = kill_at + 1
    with plan, pytest.raises(faults.InjectedIOError):
        store.gc(keep_last=1, apply=True)
    for _step_no, path in store.list():
        if path.endswith(".dcd"):
            resilience.chain_links(path)  # raises if orphaned


def test_gc_never_drops_only_verifying_chain(tmp_path):
    g, store, _p, _s = _plant_chain(tmp_path, n_deltas=1)
    g.refine_completely(int(g.plan.cells[0]))
    g.stop_refining()
    k2 = store.save(g, 2)
    _step(g, np.random.default_rng(14))
    store.save(g, 3)
    faults.flip_bit(k2, os.path.getsize(k2) - 5, bit=1)
    rep = store.gc(keep_last=1, apply=True)
    kept = [s for s, _ in store.list()]
    assert 0 in kept and 1 in kept, (kept, rep)
    assert rep.rescued == 1
    faults.flip_bit(store.path_for(0),
                    os.path.getsize(store.path_for(0)) - 5, bit=1)
    rep = gc_checkpoints(str(tmp_path), keep_last=1, apply=True)
    assert rep.refused and not rep.dropped


@pytest.mark.parametrize("seed", range(6))
def test_gc_property_fuzz_never_orphans_never_drops_last(tmp_path, seed):
    rng = np.random.default_rng(seed)
    d = tmp_path / f"s{seed}"
    g = _mk_grid(seed=seed)
    store = CheckpointStore(d, keyframe_every=int(rng.integers(2, 5)))
    step = 0
    for _ in range(int(rng.integers(4, 9))):
        if rng.random() < 0.3:
            if rng.random() < 0.5:
                g.refine_completely(int(
                    g.plan.cells[rng.integers(len(g.plan.cells))]))
                g.stop_refining()
            else:
                g.balance_load()
        else:
            _step(g, rng)
        store.save(g, step)
        step += 1
    for s, p in dict(store.list()).items():
        if rng.random() < 0.3:
            faults.flip_bit(p, int(rng.integers(0, os.path.getsize(p))),
                            int(rng.integers(0, 8)))

    def any_chain_verifies():
        for _s, p in supervise.list_checkpoints(str(d)):
            try:
                resilience.verify_chain(p)
                return True
            except resilience.CheckpointCorruptionError:
                continue
        return False

    had_verifying = any_chain_verifies()
    before = set(dict(store.list()).values())
    rep = store.gc(keep_last=int(rng.integers(1, 4)),
                   keep_every=int(rng.choice([0, 2, 3])), apply=True)
    for _s, p in supervise.list_checkpoints(str(d)):
        if p.endswith(".dcd"):
            resilience.chain_links(p)  # (a) never orphaned
    if had_verifying:
        assert any_chain_verifies()  # (b)
    after = set(dict(store.list()).values())
    for p in before - after:  # (c) whole chains only
        for _s2, p2 in rep.kept:
            if p2 in after and p2.endswith(".dcd"):
                assert p not in resilience.chain_links(p2)


def test_gc_racing_a_save_keeps_chain_resumable(tmp_path, monkeypatch):
    g, store, paths, _states = _plant_chain(tmp_path, n_deltas=1)
    _step(g, np.random.default_rng(15))
    real_replace = os.replace
    raced = []

    def racing_replace(src, dst):
        if dst.endswith(".dcd") and not raced:
            raced.append(dst)
            gc_checkpoints(str(tmp_path), keep_last=2, apply=True)
            info = supervise.resume_latest(tmp_path, SCHEMA, device="cpu")
            assert info is not None and info.step == 1
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", racing_replace)
    p2 = store.save(g, 2)
    monkeypatch.undo()
    assert raced and p2.endswith(".dcd")
    assert resilience.verify_chain(p2)


def test_gc_vouched_chain_skips_byte_verification(tmp_path, monkeypatch):
    g, store, _p, _s = _plant_chain(tmp_path, n_deltas=2)
    g.refine_completely(int(g.plan.cells[0]))
    g.stop_refining()
    store.save(g, 3)
    _step(g, np.random.default_rng(21))
    p4 = store.save(g, 4)
    assert p4.endswith(".dcd")
    calls = []
    real = resilience._bad_chunks
    monkeypatch.setattr(
        resilience, "_bad_chunks",
        lambda *a, **k: (calls.append(a[0]), real(*a, **k))[1])
    rep = gc_checkpoints(str(tmp_path), keep_last=2, apply=True,
                         assume_ok=4)
    assert [s for s, _ in rep.dropped] == [2, 1, 0]
    assert not calls


def test_readonly_store_still_resumes_delta(tmp_path, monkeypatch):
    g, store, paths, states = _plant_chain(tmp_path, n_deltas=2)
    ro_dir = os.path.abspath(str(tmp_path))
    real_access = os.access

    def ro_access(p, mode, **kw):
        if mode == os.W_OK and os.path.abspath(str(p)) == ro_dir:
            return False
        return real_access(p, mode, **kw)

    monkeypatch.setattr(os, "access", ro_access)
    scratch = resilience._chain_scratch(paths[-1])
    assert os.path.dirname(os.path.abspath(scratch)) != ro_dir
    os.unlink(scratch)
    grid, _h, rep = resilience.load_checkpoint(paths[-1], SCHEMA,
                                               device="cpu")
    monkeypatch.undo()
    assert len(rep.chain) == 3
    np.testing.assert_array_equal(
        np.asarray(grid.get("rho", g.plan.cells)), states[-1])
    assert not [n for n in os.listdir(tmp_path) if ".chain." in n]


# ---------------------------------------------------------------------
# litter, CLI
# ---------------------------------------------------------------------

def test_stale_delta_temp_suffixes_detected(tmp_path):
    _g, store, paths, _states = _plant_chain(tmp_path, n_deltas=1)
    dead_pid = 999999999
    litter = [
        store.path_for(2, delta=True) + ".mp-tmp",
        store.path_for(2, delta=True) + f".tmp.{dead_pid}",
        paths[-1] + f".chain.{dead_pid}",
    ]
    alive = paths[-1] + f".chain.{os.getpid()}"
    for p in litter + [alive]:
        with open(p, "wb") as f:
            f.write(b"x")
    assert sorted(checkpoint_mod.stale_temp_files(str(tmp_path))) == \
        sorted(litter)
    rep = store.gc(keep_last=5, apply=True)
    assert sorted(rep.stale_temps) == sorted(litter)
    for p in litter:
        assert not os.path.exists(p)
    assert os.path.exists(alive)
    os.unlink(alive)


def test_cli_chain_and_delta_verify(tmp_path, capsys):
    _g, store, paths, _states = _plant_chain(tmp_path, n_deltas=2)
    assert resilience._main(["verify", paths[-1]]) == 0
    assert "chain of 3" in capsys.readouterr().out
    assert resilience._main(["chain", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "keyframe" in out and out.count("delta") >= 2
    faults.flip_bit(paths[1], os.path.getsize(paths[1]) - 2, bit=0)
    assert resilience._main(["verify", paths[-1]]) == 1
    out = capsys.readouterr().out
    assert "CORRUPT" in out and os.path.basename(paths[1]) in out
    assert resilience._main(["chain", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "CORRUPT" in out and "BROKEN" in out


# ---------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------

def _store_run(pkg_store, grids, tmp_dir, refine_at=3):
    """The same store run on a grid of either package: saves of a
    keyframe, deltas of ``rho``, a refinement (a new keyframe) and
    deltas again, ``keyframe_every=3``."""
    g = grids
    rng = np.random.default_rng(31)
    store = pkg_store(str(tmp_dir), stem="run", keyframe_every=3)
    paths = []
    for step in range(7):
        if step == refine_at:
            g.refine_completely(int(g.plan.cells[5]))
            g.stop_refining()
            cells = g.plan.cells
            g.set("mat", cells, np.full((len(cells), 16), step, np.float32))
        _step(g, rng)
        paths.append(store.save(g, step))
    return [os.path.basename(p) for p in paths]


def test_store_files_byte_equal_to_reference(tmp_path):
    """Every ``.dc``/``.dcd`` file and sidecar of the port's store run
    is byte for byte the reference store's for the same states (the
    sidecars compared as parsed JSON, integrity records included)."""
    got = _store_run(CheckpointStore, _mk_grid(seed=3), tmp_path / "p")
    want = _store_run(ref_sup.CheckpointStore, _mk_ref(seed=3),
                      tmp_path / "r")
    assert got == want
    assert [n.endswith(".dcd") for n in got] == \
        [False, True, True, False, True, True, False]
    for name in got:
        p, r = tmp_path / "p" / name, tmp_path / "r" / name
        assert p.read_bytes() == r.read_bytes(), name
        assert json.loads((tmp_path / "p" / (name + ".crc")).read_text()) \
            == json.loads((tmp_path / "r" / (name + ".crc")).read_text())


@pytest.mark.parametrize("direction", ["port_reads_ref", "ref_reads_port"])
def test_each_package_resumes_the_others_chain(tmp_path, direction):
    if direction == "port_reads_ref":
        src = _mk_ref(seed=4)
        _store_run(ref_sup.CheckpointStore, src, tmp_path, refine_at=99)
        info = supervise.resume_latest(str(tmp_path), SCHEMA, device="cpu")
    else:
        src = _mk_grid(seed=4)
        _store_run(CheckpointStore, src, tmp_path, refine_at=99)
        info = ref_sup.resume_latest(str(tmp_path), REF_SCHEMA,
                                     mesh=_ref_mesh(),
                                     load_balancing_method="block")
    assert info is not None and info.step == 6 and not info.salvaged
    assert info.report.chain == []  # a keyframe: no chain to replay
    cells = src.plan.cells
    for name in NP_SCHEMA:
        np.testing.assert_array_equal(np.asarray(info.grid.get(name, cells)),
                                      np.asarray(src.get(name, cells)))
    # a mid-chain entry: drop the newest keyframe, resume the delta at 5
    for p in (tmp_path / "run_00000006.dc", tmp_path / "run_00000006.dc.crc"):
        p.unlink()
    loader = (supervise.resume_latest(str(tmp_path), SCHEMA, device="cpu")
              if direction == "port_reads_ref" else
              ref_sup.resume_latest(str(tmp_path), REF_SCHEMA,
                                    mesh=_ref_mesh(),
                                    load_balancing_method="block"))
    assert loader.step == 5 and len(loader.report.chain) == 3


# -- dirty tracking: a delta after every public mutator ---------------

def _kernel(c, nbr, offs, mask):
    return {"rho": 0.5 * c["rho"] + 0.125 * torch.sum(
        torch.where(mask, nbr["rho"], torch.zeros_like(nbr["rho"])), dim=1)}


def _mutate(g, what, tmp_path):
    cells = g.plan.cells
    if what == "set":
        g.set("mat", cells[:3], np.full((3, 16), 7.0, np.float32))
    elif what == "set_many":
        g.set_many(cells[2:5], {"rho": np.full(3, 2.5, np.float32),
                                "tag": np.arange(3, dtype=np.int32)})
    elif what == "run_steps":
        g.run_steps(_kernel, ["rho"], ["rho"], 2)
    elif what == "apply_stencil":
        g.apply_stencil(_kernel, ["rho"], ["rho"])
    elif what == "stop_refining":
        g.refine_completely(int(cells[1]))
        g.stop_refining()
        g.assign_children_from_parents()
    elif what == "balance_load":
        g.set_load_balancing_method("morton")
        g.balance_load()
    elif what == "load_cells":
        g.load_cells(cells)
    elif what == "load_grid_data":
        src = _mk_grid(seed=77)
        p = str(tmp_path / "src.dc")
        src.save_grid_data(p)
        g.load_grid_data(p)
    elif what == "ghost_update":
        g.update_copies_of_remote_neighbors()
    elif what == "fault_poison":
        plan = faults.FaultPlan(seed=2)
        plan.nan_poison("mat", step=1, value=3.0)
        with plan:
            faults.poison_step(g, 1)
    elif what == "in_place_under_txn":
        # a write through Grid._own while the tensor is frozen
        g._txn_frozen = {id(t) for t in g.data.values()}
        try:
            g.set("tag", cells[:1], np.array([123], np.int32))
        finally:
            g._txn_frozen = None
    else:
        raise AssertionError(what)


MUTATORS = ["set", "set_many", "run_steps", "apply_stencil",
            "stop_refining", "balance_load", "load_cells",
            "load_grid_data", "ghost_update", "fault_poison",
            "in_place_under_txn"]


@pytest.mark.parametrize("what", MUTATORS)
def test_delta_after_every_mutator_equals_keyframe(tmp_path, what):
    """After each public mutator, the next store save (a delta when the
    structure epoch held) replayed through its chain gives the bytes of
    a full save of the same state: no write escapes the dirty set."""
    g = _mk_grid(seed=12)
    store = CheckpointStore(tmp_path / "s", keyframe_every=50)
    store.save(g, 0)
    assert g._ckpt_dirty == set()
    epoch = g._ckpt_epoch
    _mutate(g, what, tmp_path)
    p = store.save(g, 1)
    if what in ("stop_refining", "balance_load", "load_cells",
                "load_grid_data"):
        assert p.endswith(".dc")  # a new epoch or a wholesale load
    else:
        assert p.endswith(".dcd") and g._ckpt_epoch == epoch
        if what == "ghost_update":
            assert resilience.read_sidecar(p)["delta"]["fields"] == []
    assert _materialized_bytes(p, g.fields) == _full_bytes(g, tmp_path)
    info = supervise.resume_latest(str(tmp_path / "s"), SCHEMA,
                                   device="cpu")
    assert info.step == 1
    want = _values(g)
    for name, vals in _values(info.grid).items():
        np.testing.assert_array_equal(vals, want[name])


def test_dirty_set_matches_reference_marks(tmp_path):
    """The port marks what the reference marks: the same dirty sets and
    structure epochs after the same mutators."""
    g, r = _mk_grid(seed=1), _mk_ref(seed=1)
    for grid in (g, r):
        grid._ckpt_dirty = set()
    seen = []
    for grid in (g, r):
        cells = grid.plan.cells
        grid.set("mat", cells[:2], np.zeros((2, 16), np.float32))
        a = sorted(grid._ckpt_dirty)
        grid.update_copies_of_remote_neighbors()
        b = sorted(grid._ckpt_dirty)
        grid.refine_completely(int(cells[0]))
        grid.stop_refining()
        seen.append((a, b, grid._ckpt_dirty, grid._ckpt_epoch))
    assert seen[0] == seen[1] == (["mat"], ["mat"], None, 1)


def test_freeze_grid_carries_the_dirty_set(tmp_path):
    from dccrg_tpu_torch.background import freeze_grid

    g = _mk_grid()
    g._ckpt_dirty = {"rho"}
    snap = freeze_grid(g, fields=["rho"])
    assert snap._ckpt_dirty == {"rho"} and snap._ckpt_dirty is not \
        g._ckpt_dirty
    g._ckpt_dirty.add("tag")
    assert snap._ckpt_dirty == {"rho"}
    g._ckpt_dirty = None
    assert freeze_grid(g)._ckpt_dirty is None
