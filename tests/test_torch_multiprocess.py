"""The port's grid under a process split against the reference's, on the
CPU: rank-local ``get``/``set``, the two-phase checkpoint commit, the
rank-local load, ``freeze_grid_mp`` and the async saves, and the
two-phase delta checkpoints.

The counterparts of ``tests/test_multiprocess.py`` and of the two-phase
cases of ``tests/test_delta_checkpoint.py`` (:348-415). As there, the
split is faked in one process: ``grid._proc_local_dev`` marks the
partitions of the rank in turn and ``grid._ckpt_rank`` pins its rank,
rank 0 writing the metadata and rank 1 committing. The two faked ranks'
file is held byte for byte to the reference's faked two-rank file and
to the reference's one-process save of the same state. Both packages
run four partitions (the reference on four virtual devices). A real
two-process gloo group on localhost saves and loads at the end.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dccrg_tpu import checkpoint as ref_ckpt
from dccrg_tpu import resilience as ref_res
from dccrg_tpu.grid import Grid as RefGrid

from dccrg_tpu_torch import background, coord, faults, resilience, supervise
from dccrg_tpu_torch import checkpoint as checkpoint_mod
from dccrg_tpu_torch.grid import Grid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DEV = 4
HALF = N_DEV // 2


def _mesh():
    return Mesh(np.array(jax.devices()[:N_DEV]), ("dev",))


def _mk(fields=None, n=(8, 8, 8), ref=False):
    """The reference's ``_mk`` grid on four partitions (``ref``: the
    reference's grid on four virtual devices)."""
    if ref:
        spec = {k: getattr(jnp, v) for k, v in (fields or {"v": "float32"}).items()
                if not isinstance(v, tuple)}
        spec.update({k: (v[0], getattr(jnp, v[1]))
                     for k, v in (fields or {}).items() if isinstance(v, tuple)})
        return (RefGrid(cell_data=spec).set_initial_length(n)
                .set_periodic(True, True, False)
                .set_maximum_refinement_level(0)
                .set_neighborhood_length(1)
                .initialize(_mesh(), partition="block"))
    spec = {k: getattr(torch, v) for k, v in (fields or {"v": "float32"}).items()
            if not isinstance(v, tuple)}
    spec.update({k: (v[0], getattr(torch, v[1]))
                 for k, v in (fields or {}).items() if isinstance(v, tuple)})
    return (Grid(cell_data=spec).set_initial_length(n)
            .set_periodic(True, True, False)
            .set_maximum_refinement_level(0)
            .set_neighborhood_length(1)
            .initialize(["cpu"] * N_DEV, partition="block"))


def _fake_split(g, local_devs, rank=None):
    g._proc_local_dev = np.array(
        [d in set(local_devs) for d in range(g.n_dev)], dtype=bool)
    g._ckpt_rank = rank


def _unfake(g):
    g._proc_local_dev = np.ones(g.n_dev, dtype=bool)
    g._ckpt_rank = None
    for attr in ("_ckpt_writes_meta", "_ckpt_commits"):
        if hasattr(g, attr):
            delattr(g, attr)


def _role(g, rank):
    _fake_split(g, range(HALF) if rank == 0 else range(HALF, g.n_dev),
                rank=rank)
    g._ckpt_writes_meta = rank == 0
    g._ckpt_commits = rank == 1


@pytest.fixture(autouse=True)
def _clean_mp_state():
    """Rank-death cases abort mid-protocol: no staged CRC may leak into
    the next test."""
    yield
    checkpoint_mod._MP_CRC_STAGE.clear()
    ref_ckpt._MP_CRC_STAGE.clear()


def _rank_pass(g, rank, fn, **save_kwargs):
    """One faked rank's pass of the two-phase save: rank 0 writes the
    metadata, rank 1 commits."""
    _role(g, rank)
    g.save_grid_data(str(fn), **save_kwargs)


def _two_pass_save(g, fn, **save_kwargs):
    for rank in (0, 1):
        _rank_pass(g, rank, fn, **save_kwargs)
    _unfake(g)


def _fill(gs, fn):
    """Set every field of the grids ``gs`` from ``fn(cells) -> {name:
    values}`` (the same numpy values in both packages)."""
    for g in gs:
        cells = g.plan.cells
        for name, vals in fn(cells).items():
            g.set(name, cells, vals)


def _three_files(tmp_path, make, **save_kwargs):
    """The port's faked two-rank file, the reference's faked two-rank
    file and the reference's one-process save of the same state."""
    out = {}
    for tag in ("port", "ref"):
        g = make(ref=tag == "ref")
        fn = tmp_path / f"{tag}_split.dc"
        _two_pass_save(g, fn, **save_kwargs)
        out[tag] = fn.read_bytes()
    g = make(ref=True)
    fn = tmp_path / "ref_single.dc"
    g.save_grid_data(str(fn), **save_kwargs)
    out["single"] = fn.read_bytes()
    return out


# ---------------------------------------------------------------------
# rank-local access
# ---------------------------------------------------------------------

def test_get_set_are_rank_local():
    outcomes = {}
    for tag in ("port", "ref"):
        g = _mk(ref=tag == "ref")
        cells = g.plan.cells
        g.set("v", cells, (cells % np.uint64(11)).astype(np.float32))
        _fake_split(g, range(HALF))
        assert g._multiproc
        local = np.isin(g.plan.owner, list(range(HALF)))
        my, foreign = cells[local], cells[~local]
        got = g.get("v", my[:100])
        np.testing.assert_array_equal(
            got, (my[:100] % np.uint64(11)).astype(np.float32))
        raised = []
        for what, fn in (("get", lambda: g.get("v", foreign[:3])),
                         ("get1", lambda: g.get("v", foreign[0])),
                         ("mixed", lambda: g.get("v", cells[[0, -1]])),
                         ("set", lambda: g.set("v", foreign[:3],
                                               np.zeros(3, np.float32)))):
            try:
                fn()
                raised.append((what, None))
            except KeyError as e:
                assert "process-local" in str(e)
                raised.append((what, "KeyError"))
        g.set("v", my[:5], np.full(5, 99.0, np.float32))
        _unfake(g)
        np.testing.assert_array_equal(g.get("v", my[:5]),
                                      np.full(5, 99.0, np.float32))
        outcomes[tag] = (raised, g.get("v", cells))
    assert outcomes["port"][0] == outcomes["ref"][0]
    assert all(r == "KeyError" for _w, r in outcomes["port"][0])
    np.testing.assert_array_equal(outcomes["port"][1], outcomes["ref"][1])


def test_set_with_duplicates_is_partial_under_split():
    """A full-length id list with a duplicate is no cover: it takes the
    rank-local path and raises on foreign ids, in both packages."""
    for tag in ("port", "ref"):
        g = _mk(ref=tag == "ref")
        cells = g.plan.cells.copy()
        ids = cells.copy()
        ids[-1] = ids[0]  # full length, one foreign cell missing
        _fake_split(g, range(HALF))
        with pytest.raises(KeyError, match="process-local"):
            g.set("v", ids, np.ones(len(ids), np.float32))
        _unfake(g)


def test_collective_paths_unchanged_under_split():
    """The halo exchange and the step loop use replicated tables only:
    a faked split changes nothing."""
    def kern(cell, nbr, offs, mask):
        return {"v": 0.5 * cell["v"] + 0.125 * torch.sum(
            torch.where(mask, nbr["v"], 0.0), dim=1)}

    res = []
    for split in (False, True):
        g = _mk()
        cells = g.plan.cells
        g.set("v", cells, (cells % np.uint64(7)).astype(np.float32))
        g.update_copies_of_remote_neighbors()
        if split:
            _fake_split(g, range(HALF))
        g.run_steps(kern, ["v"], ["v"], 3)
        _unfake(g)
        res.append(g.get("v", cells))
    np.testing.assert_array_equal(res[0], res[1])


def test_full_cover_set_preserving_ghosts_under_split():
    """A replicated full-cover set with preserve_ghosts=True (the init
    idiom) lands under a split, and the ghost rows keep their values."""
    g = _mk()
    cells = g.plan.cells
    g.set("v", cells, np.ones(len(cells), np.float32))
    g.update_copies_of_remote_neighbors()  # ghosts now 1.0
    _fake_split(g, range(HALF))
    g.set("v", cells, np.full(len(cells), 2.0, np.float32))
    _unfake(g)
    np.testing.assert_array_equal(
        g.get("v", cells), np.full(len(cells), 2.0, np.float32))
    host = g.data["v"].numpy()
    L = g.plan.L
    for d in range(g.n_dev):
        ng = len(g.plan.ghost_ids[d])
        if ng:
            np.testing.assert_array_equal(host[d, L:L + ng],
                                          np.ones(ng, np.float32))


def test_amr_commit_and_balance_under_split():
    """Refine, commit, projection, balance: the same structure and data
    under a faked split as without, and as the reference's."""
    results = {}
    for tag in ("port", "ref"):
        for split in (False, True):
            if tag == "ref":
                g = (RefGrid(cell_data={"v": jnp.float32})
                     .set_initial_length((8, 8, 4))
                     .set_periodic(True, True, False)
                     .set_maximum_refinement_level(1)
                     .set_neighborhood_length(1)
                     .initialize(_mesh(), partition="block"))
            else:
                g = (Grid(cell_data={"v": torch.float32})
                     .set_initial_length((8, 8, 4))
                     .set_periodic(True, True, False)
                     .set_maximum_refinement_level(1)
                     .set_neighborhood_length(1)
                     .initialize(["cpu"] * N_DEV, partition="block"))
            cells = g.plan.cells
            g.set("v", cells, (cells % np.uint64(23)).astype(np.float32))
            if split:
                _fake_split(g, range(HALF))
            for cid in g.plan.cells[:12:3]:
                g.refine_completely(int(cid))
            g.stop_refining()
            g.assign_children_from_parents(fields=["v"])
            g.clear_refined_unrefined_data()
            g.set_partitioning_option("method", "morton")
            g.balance_load()
            g.update_copies_of_remote_neighbors()
            _unfake(g)
            results[tag, split] = (g.plan.cells.copy(), g.plan.owner.copy(),
                                   g.get("v", g.plan.cells))
    want = results["ref", False]
    for key, got in results.items():
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=str(key))


def test_projection_is_rank_local_under_split():
    """assign_children_from_parents writes only this rank's new cells;
    the reference's does the same."""
    for tag in ("port", "ref"):
        if tag == "ref":
            g = (RefGrid(cell_data={"v": jnp.float32})
                 .set_initial_length((8, 8, 4))
                 .set_maximum_refinement_level(1)
                 .set_neighborhood_length(1)
                 .initialize(_mesh(), partition="block"))
        else:
            g = (Grid(cell_data={"v": torch.float32})
                 .set_initial_length((8, 8, 4))
                 .set_maximum_refinement_level(1)
                 .set_neighborhood_length(1)
                 .initialize(["cpu"] * N_DEV, partition="block"))
        cells = g.plan.cells
        g.set("v", cells, (cells % np.uint64(5) + 1).astype(np.float32))
        picks = [int(cells[0]), int(cells[-1])]  # partitions 0 and 3
        for c in picks:
            g.refine_completely(c)
        g.stop_refining()
        new = np.asarray(g._new_cells)
        _fake_split(g, range(HALF))
        g.assign_children_from_parents(fields=["v"])
        _unfake(g)
        dev = g.plan.owner[np.searchsorted(g.plan.cells, new)]
        vals = g.get("v", new)
        assert (vals[dev < HALF] > 0).all(), tag
        assert not vals[dev >= HALF].any(), tag


def test_staged_balance_peek_is_rank_local():
    peeks = {}
    for tag in ("port", "ref"):
        g = _mk(ref=tag == "ref")
        cells = g.plan.cells
        g.set("v", cells, (cells % np.uint64(9)).astype(np.float32))
        for c in cells[:6]:
            g.pin(int(c), (g.get_process(int(c)) + 1) % g.n_dev)
        for c in cells[-6:]:
            g.pin(int(c), (g.get_process(int(c)) + 1) % g.n_dev)
        g.initialize_balance_load(use_zoltan=False)
        g.continue_balance_load()
        all_ids, all_vals = g.staged_balance_data("v")
        _fake_split(g, range(HALF))
        ids, vals = g.staged_balance_data("v")
        _unfake(g)
        dev, _ = g._host_rows(ids)
        assert np.isin(dev, list(range(HALF))).all()
        assert 0 < len(ids) < len(all_ids)
        sel = np.isin(all_ids, ids)
        np.testing.assert_array_equal(all_vals[sel], vals)
        g.finish_balance_load()
        peeks[tag] = (ids, vals)
    np.testing.assert_array_equal(peeks["port"][0], peeks["ref"][0])
    np.testing.assert_array_equal(peeks["port"][1], peeks["ref"][1])


def test_clone_keeps_the_split():
    g = _mk()
    _fake_split(g, range(HALF), rank=0)
    c = g.clone()
    np.testing.assert_array_equal(c._proc_local_dev, g._proc_local_dev)
    assert c._ckpt_rank == 0 and c._multiproc
    _unfake(g)


# ---------------------------------------------------------------------
# the two-phase save: bytes
# ---------------------------------------------------------------------

def test_two_process_checkpoint_slices_merge_exactly(tmp_path):
    def make(ref=False):
        g = _mk({"v": "float32", "w": "int32"}, ref=ref)
        rng = np.random.default_rng(3)
        _fill([g], lambda c: {
            "v": rng.random(len(c)).astype(np.float32),
            "w": (c % np.uint64(5)).astype(np.int32)})
        return g

    files = _three_files(tmp_path, make, header=b"HDR!")
    assert files["port"] == files["ref"] == files["single"]


def test_two_process_ragged_checkpoint(tmp_path):
    cap = 4

    def make(ref=False):
        g = _mk({"n": "int32", "p": ((cap, 2), "float32")}, ref=ref)
        rng = np.random.default_rng(5)
        _fill([g], lambda c: {
            "n": rng.integers(0, cap + 1, len(c)).astype(np.int32),
            "p": rng.random((len(c), cap, 2)).astype(np.float32)})
        return g

    files = _three_files(tmp_path, make, variable={"p": "n"})
    assert files["port"] == files["ref"] == files["single"]


def test_two_process_slices_on_refined_morton_grid(tmp_path):
    """Fragmented ownership (morton + refinement): many interleaved
    runs per rank, the merged file still the one-process file."""
    def make(ref=False):
        if ref:
            g = (RefGrid(cell_data={"v": jnp.float32})
                 .set_initial_length((6, 6, 4))
                 .set_maximum_refinement_level(1)
                 .set_neighborhood_length(1)
                 .initialize(_mesh(), partition="morton"))
        else:
            g = (Grid(cell_data={"v": torch.float32})
                 .set_initial_length((6, 6, 4))
                 .set_maximum_refinement_level(1)
                 .set_neighborhood_length(1)
                 .initialize(["cpu"] * N_DEV, partition="morton"))
        for cid in g.plan.cells[::17]:
            g.refine_completely(int(cid))
        g.stop_refining()
        _fill([g], lambda c: {"v": (c % np.uint64(19)).astype(np.float32)})
        return g

    runs = checkpoint_mod._device_runs
    g = make()
    cells = g.plan.cells
    offs = np.arange(len(cells), dtype=np.uint64) * np.uint64(4)
    assert len(runs(g.n_dev, g.plan.owner, offs,
                    np.full(len(cells), 4, np.uint64))) > 2 * N_DEV
    files = _three_files(tmp_path, make)
    assert files["port"] == files["ref"] == files["single"]


@pytest.mark.parametrize("seed", range(3))
def test_device_runs_equal_reference(seed):
    """The run table every rank derives from the plan: the port's one
    pass over the owners gives the reference's table exactly."""
    rng = np.random.default_rng(seed)
    for trial in range(20):
        n = int(rng.integers(1, 500))
        nd = int(rng.integers(1, 7))
        owner = rng.integers(0, nd, n)
        if trial % 2:
            owner = np.sort(owner)
        sizes = rng.integers(0, 40, n).astype(np.uint64)
        offs = np.uint64(11) + np.concatenate(
            [[np.uint64(0)], np.cumsum(sizes)[:-1]]).astype(np.uint64)
        got = checkpoint_mod._device_runs(nd, owner, offs, sizes)
        want = ref_ckpt._device_runs(nd, owner, offs, sizes)
        assert [(r[0], r[2], r[3]) for r in got] == \
            [(r[0], r[2], r[3]) for r in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a[1], b[1])


def test_two_phase_sidecar_equals_reference(tmp_path):
    """The committing rank's sidecar (CRC chunks and the per-rank slice
    table) is byte for byte the reference's two-phase sidecar."""
    side = {}
    for tag in ("port", "ref"):
        g = _mk(ref=tag == "ref")
        _fill([g], lambda c: {"v": (c % np.uint64(11)).astype(np.float32)})
        fn = tmp_path / f"{tag}.dc"
        _two_pass_save(g, fn, sidecar=True, sidecar_chunk_bytes=512)
        side[tag] = (tmp_path / f"{tag}.dc.crc").read_bytes()
    assert side["port"] == side["ref"]
    rec = json.loads(side["port"])
    assert {s[1] for s in rec["slices"]} == {0, 1}


def test_two_phase_publishes_only_at_commit(tmp_path):
    fn = tmp_path / "a.dc"
    single = tmp_path / "s.dc"
    g = _value_grid()
    _unfake(g)
    g.save_grid_data(str(single))
    _rank_pass(g, 0, fn, sidecar=True)
    assert not fn.exists()
    assert os.path.exists(str(fn) + checkpoint_mod.MP_TMP_SUFFIX)
    _rank_pass(g, 1, fn, sidecar=True)
    assert fn.exists()
    assert not os.path.exists(str(fn) + checkpoint_mod.MP_TMP_SUFFIX)
    assert fn.read_bytes() == single.read_bytes()
    rec = resilience.read_sidecar(str(fn))
    assert rec["slices"] and all(len(s) == 5 for s in rec["slices"])
    assert {s[1] for s in rec["slices"]} == {0, 1}
    assert resilience.verify_checkpoint(str(fn)) == []


def test_process_local_load(tmp_path):
    """Each rank scatters only its cells; the other rows stay zero."""
    got = {}
    for tag in ("port", "ref"):
        g = _mk(ref=tag == "ref")
        cells = g.plan.cells
        g.set("v", cells, (cells % np.uint64(13)).astype(np.float32))
        fn = str(tmp_path / f"{tag}.dc")
        g.save_grid_data(fn)
        g2 = _mk(ref=tag == "ref")
        _fake_split(g2, range(HALF))
        g2.load_grid_data(fn)
        _unfake(g2)
        local = np.isin(g2.plan.owner, list(range(HALF)))
        np.testing.assert_array_equal(
            g2.get("v", cells[local]),
            (cells[local] % np.uint64(13)).astype(np.float32))
        assert not np.any(g2.get("v", cells[~local]))
        got[tag] = g2.get("v", cells)
    np.testing.assert_array_equal(got["port"], got["ref"])


def test_process_local_load_of_a_refined_ragged_file(tmp_path):
    """A rank-local load of a ragged file of a refined grid: each rank
    holds its own cells' counts and rows, bit for bit the saved ones."""
    cap = 3
    g = (Grid(cell_data={"n": torch.int32, "p": ((cap,), torch.float32)})
         .set_initial_length((6, 6, 4)).set_maximum_refinement_level(1)
         .set_neighborhood_length(1)
         .initialize(["cpu"] * N_DEV, partition="morton"))
    for cid in g.plan.cells[::13]:
        g.refine_completely(int(cid))
    g.stop_refining()
    cells = g.plan.cells
    rng = np.random.default_rng(8)
    n = rng.integers(0, cap + 1, len(cells)).astype(np.int32)
    p = rng.random((len(cells), cap)).astype(np.float32)
    p[np.arange(cap)[None, :] >= n[:, None]] = 0.0
    g.set_many(cells, {"n": n, "p": p})
    fn = str(tmp_path / "r.dc")
    _two_pass_save(g, fn, variable={"p": "n"})
    for rank in (0, 1):
        back = g.clone()
        _role(back, rank)
        back.load_grid_data(fn, variable={"p": "n"})
        mine = back._proc_local_dev[back.plan.owner]
        np.testing.assert_array_equal(back.get("n", cells[mine]), n[mine])
        np.testing.assert_array_equal(back.get("p", cells[mine]), p[mine])
        _unfake(back)
        assert not back.get("n", cells[~mine]).any()


# ---------------------------------------------------------------------
# the two-phase save: atomicity under rank death
# ---------------------------------------------------------------------

def _value_grid(val=None, ref=False):
    g = _mk(ref=ref)
    cells = g.plan.cells
    if val is None:
        g.set("v", cells, (cells % np.uint64(11)).astype(np.float32))
    else:
        g.set("v", cells, np.full(len(cells), val, np.float32))
    return g


def _death_run(tmp_path, tag, rank, phase):
    """One package's rank death at (rank, phase) after a good save:
    the outcomes per rank and the files before and after."""
    ref = tag == "ref"
    fau = __import__("dccrg_tpu.faults" if ref else "dccrg_tpu_torch.faults",
                     fromlist=["x"])
    d = tmp_path / tag
    d.mkdir()
    fn = d / "ck.dc"
    _two_pass_save(_value_grid(ref=ref), fn, sidecar=True)
    good = (fn.read_bytes(), (d / "ck.dc.crc").read_bytes())
    g = _value_grid(7.0, ref=ref)  # a new state that must NOT land
    plan = fau.FaultPlan(seed=11)
    plan.rank_death(phase=phase, rank=rank)
    outcomes = []
    with plan:
        for r in (0, 1):
            try:
                _rank_pass(g, r, fn, sidecar=True)
            except Exception as e:  # noqa: BLE001 - recorded, asserted
                outcomes.append((r, type(e).__name__))
    _unfake(g)
    after = (fn.read_bytes(), (d / "ck.dc.crc").read_bytes())
    return outcomes, good, after, str(fn)


@pytest.mark.parametrize("rank,phase", [
    (0, "meta"), (0, "slice"), (0, "written"),
    (1, "slice"), (1, "written"), (1, "commit"),
])
def test_rank_death_at_every_phase_preserves_old_checkpoint(
        tmp_path, rank, phase):
    """A rank killed at each save phase: the previous checkpoint stays
    byte for byte, verifies and loads, and both packages report the
    same outcomes on the same files."""
    port = _death_run(tmp_path, "port", rank, phase)
    ref = _death_run(tmp_path, "ref", rank, phase)
    outcomes, good, after, fn = port
    assert (rank, "InjectedRankDeath") in outcomes
    if rank == 0:
        # the survivor commits: it must ABORT, loudly
        assert any(t in ("CheckpointCommitError", "FileNotFoundError")
                   or t.endswith("Error") for r, t in outcomes if r == 1)
    assert after == good
    assert port[0] == ref[0]
    assert port[1] == ref[1] and port[2] == ref[2]
    assert resilience.verify_checkpoint(fn) == []
    grid, _hdr, rep = resilience.load_checkpoint(
        fn, {"v": torch.float32}, device="cpu")
    assert rep.clean
    cells = grid.plan.cells
    np.testing.assert_array_equal(
        grid.get("v", cells), (cells % np.uint64(11)).astype(np.float32))


def test_rank_death_after_publish_leaves_new_checkpoint(tmp_path):
    """Death between the rename and the sidecar: the NEW bytes are
    published whole with no sidecar; a strict load refuses, a salvage
    load returns the new state."""
    fn = tmp_path / "p.dc"
    _two_pass_save(_value_grid(), fn, sidecar=True)
    g = _value_grid(5.0)
    plan = faults.FaultPlan()
    plan.rank_death(phase="publish", rank=1)
    with plan:
        _rank_pass(g, 0, fn, sidecar=True)
        with pytest.raises(faults.InjectedRankDeath):
            _rank_pass(g, 1, fn, sidecar=True)
    _unfake(g)
    single = tmp_path / "s.dc"
    _value_grid(5.0, ref=True).save_grid_data(str(single))
    assert fn.read_bytes() == single.read_bytes()
    with pytest.raises(resilience.CheckpointCorruptionError,
                       match="no checksum sidecar"):
        resilience.load_checkpoint(str(fn), {"v": torch.float32},
                                   device="cpu")
    grid, _hdr, rep = resilience.load_checkpoint(
        str(fn), {"v": torch.float32}, strict=False, device="cpu")
    assert rep.sidecar_missing
    np.testing.assert_array_equal(
        grid.get("v", grid.plan.cells),
        np.full(len(grid.plan.cells), 5.0, np.float32))


def test_commit_verify_catches_torn_slice_and_metadata(tmp_path):
    fn = tmp_path / "t.dc"
    tmp = str(fn) + checkpoint_mod.MP_TMP_SUFFIX
    g = _value_grid()
    _rank_pass(g, 0, fn, sidecar=True)
    ps = resilience._sidecar_record(tmp)["payload_start"]
    faults.flip_bit(tmp, ps + 3, 1)
    with pytest.raises(coord.CheckpointCommitError) as ei:
        _rank_pass(g, 1, fn, sidecar=True)
    assert ei.value.ranks == [0]
    assert not fn.exists()
    checkpoint_mod._MP_CRC_STAGE.clear()
    g = _value_grid()
    _rank_pass(g, 0, fn, sidecar=True)
    faults.flip_bit(tmp, 100, 1)
    with pytest.raises(coord.CheckpointCommitError, match="metadata"):
        _rank_pass(g, 1, fn, sidecar=True)
    assert not fn.exists()


def test_injected_io_fault_mid_slice_never_tears_final(tmp_path):
    fn = tmp_path / "io.dc"
    _two_pass_save(_value_grid(), fn, sidecar=True)
    good = fn.read_bytes()
    g = _value_grid(9.0)
    plan = faults.FaultPlan()
    plan.io_error(site="checkpoint.mp", phase="slice", rank=1)
    with plan:
        _rank_pass(g, 0, fn, sidecar=True)
        with pytest.raises(faults.InjectedIOError):
            _rank_pass(g, 1, fn, sidecar=True)
    assert fn.read_bytes() == good
    assert resilience.verify_checkpoint(str(fn)) == []


def test_barrier_hang_during_save_times_out_not_hangs(tmp_path,
                                                      monkeypatch):
    fn = tmp_path / "h.dc"
    g = _value_grid()
    plan = faults.FaultPlan()
    plan.barrier_hang(tag="save_commit:h.dc")
    _fake_split(g, range(HALF), rank=0)
    g._ckpt_writes_meta, g._ckpt_commits = True, False
    monkeypatch.setenv("DCCRG_BARRIER_TIMEOUT", "0.3")
    t0 = time.monotonic()
    with plan, pytest.raises(coord.BarrierTimeoutError,
                             match="save_commit"):
        g.save_grid_data(str(fn))
    assert time.monotonic() - t0 < 5.0
    assert not fn.exists()


def test_save_barrier_tags_carry_attempt_epoch(tmp_path):
    fn = tmp_path / "e.dc"
    g = _value_grid()
    plan = faults.FaultPlan()
    plan.barrier_hang(tag="save_prepare:e.dc", times=2, hang_s=0.01)
    with plan:
        _two_pass_save(g, fn)
        _two_pass_save(g, fn)
    tags = [d["tag"] for s, _k, d in plan.log
            if s == "coord.barrier_hang"]
    assert len(tags) == 2
    assert all(t.startswith("save_prepare:e.dc#") for t in tags)
    assert tags[0] != tags[1]


def test_salvage_load_names_dead_ranks_cells(tmp_path):
    """At-rest corruption in one rank's slice: a strict load names the
    writer rank; a salvage returns the intact cells and names the dead
    rank and the zeroed cells, which are all that rank's."""
    fn = tmp_path / "sv.dc"
    g = _value_grid()
    _two_pass_save(g, fn, sidecar=True, sidecar_chunk_bytes=256)
    rec = resilience.read_sidecar(str(fn))
    sl = next(s for s in rec["slices"] if s[1] == 1)
    faults.flip_bit(str(fn), sl[2] + 5, 2)
    with pytest.raises(resilience.CheckpointCorruptionError,
                       match=r"rank\(s\) \[1\]"):
        resilience.load_checkpoint(str(fn), {"v": torch.float32},
                                   device="cpu")
    grid, _hdr, rep = resilience.load_checkpoint(
        str(fn), {"v": torch.float32}, strict=False, device="cpu")
    _rg, _rh, rrep = ref_res.load_checkpoint(
        str(fn), {"v": jnp.float32}, strict=False)
    assert rep.dead_ranks == rrep.dead_ranks == [1]
    assert rep.bad_slices == rrep.bad_slices and len(rep.bad_slices) == 1
    np.testing.assert_array_equal(rep.corrupt_cells, rrep.corrupt_cells)
    assert len(rep.corrupt_cells)
    # every zeroed cell is a cell of a partition the dead rank wrote
    src = g.plan.owner[np.searchsorted(g.plan.cells, rep.corrupt_cells)]
    assert set(src.tolist()) <= set(range(HALF, N_DEV))
    ok = ~np.isin(grid.plan.cells, rep.corrupt_cells)
    cells = grid.plan.cells[ok]
    np.testing.assert_array_equal(
        grid.get("v", cells), (cells % np.uint64(11)).astype(np.float32))


def test_save_checkpoint_routes_multiproc_through_two_phase(tmp_path):
    fn = tmp_path / "rc.dc"
    g = _value_grid()
    _fake_split(g, range(HALF), rank=0)
    g._ckpt_writes_meta, g._ckpt_commits = True, False
    resilience.save_checkpoint(g, str(fn))
    assert not fn.exists()  # two-phase: nothing published yet
    _fake_split(g, range(HALF, N_DEV), rank=1)
    g._ckpt_writes_meta, g._ckpt_commits = False, True
    resilience.save_checkpoint(g, str(fn))
    _unfake(g)
    assert resilience.verify_checkpoint(str(fn)) == []
    single = tmp_path / "s.dc"
    _value_grid(ref=True).save_grid_data(str(single))
    assert fn.read_bytes() == single.read_bytes()


# ---------------------------------------------------------------------
# async (writer-thread) two-phase saves: freeze_grid_mp
# ---------------------------------------------------------------------

def _frozen_pair(g, **kw):
    frozen = {}
    for rank in (0, 1):  # collective discipline: EVERY rank freezes
        _role(g, rank)
        frozen[rank] = background.freeze_grid_mp(g, **kw)
    _unfake(g)
    return frozen


def test_async_mp_save_is_bitwise_and_snapshot_consistent(tmp_path):
    """The save from freeze_grid_mp snapshots on AsyncSaver threads
    writes the synchronous two-pass file, even with the live grid
    changed after the freeze."""
    fn_sync = tmp_path / "sync.dc"
    _two_pass_save(_value_grid(), fn_sync, header=b"HDR!")
    g = _value_grid()
    fn = tmp_path / "async.dc"
    frozen = _frozen_pair(g)
    g.set("v", g.plan.cells, np.full(len(g.plan.cells), -9.0, np.float32))
    saver = background.AsyncSaver()
    for rank in (0, 1):
        fr = frozen[rank]
        saver.submit(lambda fr=fr: fr.save_grid_data(str(fn),
                                                     header=b"HDR!"))
        saver.drain()
    assert fn.read_bytes() == fn_sync.read_bytes()
    assert getattr(g, "_mp_save_epoch", 0) >= 2


def test_async_mp_ragged_save_uses_frozen_counts(tmp_path):
    """A ragged async save reads its counts from the freeze
    (``_frozen_pulls``) and its rows from the host copies."""
    cap = 3
    g = _mk({"n": "int32", "p": ((cap,), "float32")})
    cells = g.plan.cells
    rng = np.random.default_rng(4)
    g.set_many(cells, {"n": rng.integers(0, cap + 1, len(cells)).astype(np.int32),
                       "p": rng.random((len(cells), cap)).astype(np.float32)})
    fn_sync = tmp_path / "sync.dc"
    _two_pass_save(g, fn_sync, variable={"p": "n"})
    frozen = _frozen_pair(g, variable={"p": "n"})
    assert set(frozen[0]._frozen_pulls) == {"n"}
    g.set("n", cells, np.zeros(len(cells), np.int32))
    fn = tmp_path / "async.dc"
    for rank in (0, 1):
        frozen[rank].save_grid_data(str(fn), variable={"p": "n"})
    assert fn.read_bytes() == fn_sync.read_bytes()


def test_async_mp_save_rank_death_aborts_cleanly(tmp_path):
    fn = tmp_path / "ad.dc"
    _two_pass_save(_value_grid(), fn, sidecar=True)
    good = fn.read_bytes()
    g = _value_grid(7.0)
    frozen = _frozen_pair(g)
    saver = background.AsyncSaver()
    failures = []
    plan = faults.FaultPlan()
    plan.rank_death(phase="slice", rank=1)
    with plan:
        for rank in (0, 1):
            fr = frozen[rank]
            saver.submit(lambda fr=fr: fr.save_grid_data(str(fn),
                                                         sidecar=True),
                         on_fail=lambda e: failures.append(e))
            if rank == 0:
                saver.drain()
            else:
                with pytest.raises(faults.InjectedRankDeath):
                    saver.drain()
    assert len(failures) == 1
    assert fn.read_bytes() == good
    assert resilience.verify_checkpoint(str(fn)) == []
    _two_pass_save(_value_grid(7.0), fn, sidecar=True)
    single = tmp_path / "s.dc"
    _value_grid(7.0, ref=True).save_grid_data(str(single))
    assert fn.read_bytes() == single.read_bytes()


def test_supervise_store_routes_multiproc_async_through_freeze_mp(
        tmp_path, monkeypatch):
    monkeypatch.setenv("DCCRG_ASYNC_SAVE", "1")
    kinds = []
    real = background.freeze_grid_mp

    def spy(grid, fields=None, variable=None):
        kinds.append("mp")
        return real(grid, fields=fields, variable=variable)

    monkeypatch.setattr(background, "freeze_grid_mp", spy)
    store = supervise.CheckpointStore(str(tmp_path / "store"), stem="as")
    g = _value_grid()
    for rank in (0, 1):
        _role(g, rank)
        store.save(g, step=4)
        store.drain()
    _unfake(g)
    assert kinds == ["mp", "mp"]
    entries = supervise.list_checkpoints(str(tmp_path / "store"), stem="as")
    assert entries
    monkeypatch.setenv("DCCRG_ASYNC_SAVE", "0")
    store2 = supervise.CheckpointStore(str(tmp_path / "sync"), stem="as")
    g2 = _value_grid()
    for rank in (0, 1):
        _role(g2, rank)
        store2.save(g2, step=4)
    _unfake(g2)
    b = supervise.list_checkpoints(str(tmp_path / "sync"), stem="as")[0][1]
    assert open(entries[0][1], "rb").read() == open(b, "rb").read()
    single = tmp_path / "s.dc"
    _value_grid(ref=True).save_grid_data(str(single))
    assert open(b, "rb").read() == single.read_bytes()


def test_resilient_runner_async_save_under_split(tmp_path, monkeypatch):
    """ResilientRunner's DCCRG_ASYNC_SAVE write under a split freezes
    through freeze_grid_mp (each faked rank's runner in turn) and
    publishes the synchronous two-pass file."""
    monkeypatch.setenv("DCCRG_ASYNC_SAVE", "1")
    kinds = []
    real = background.freeze_grid_mp
    monkeypatch.setattr(
        background, "freeze_grid_mp",
        lambda grid, fields=None, variable=None: kinds.append(1) or real(
            grid, fields=fields, variable=variable))
    g = _value_grid()
    path = str(tmp_path / "rr.dc")
    for rank in (0, 1):
        _role(g, rank)
        runner = resilience.ResilientRunner(g, lambda grid, i: None, path)
        runner._write_checkpoint()
        runner._drain_saves()
    _unfake(g)
    assert kinds == [1, 1]
    single = tmp_path / "s.dc"
    _value_grid(ref=True).save_grid_data(str(single))
    assert open(path, "rb").read() == single.read_bytes()
    assert resilience.verify_checkpoint(path) == []


# ---------------------------------------------------------------------
# two-phase delta checkpoints (tests/test_delta_checkpoint.py:348-415)
# ---------------------------------------------------------------------

DSCHEMA = {"rho": torch.float32, "mat": ((16,), torch.float32),
           "tag": torch.int32}
NP_DSCHEMA = {"rho": ((), np.float32), "mat": ((16,), np.float32),
              "tag": ((), np.int32)}


def _delta_grid(seed=0):
    g = (Grid(cell_data=DSCHEMA).set_initial_length((8, 8, 4))
         .set_periodic(True, True, True).set_maximum_refinement_level(0)
         .set_neighborhood_length(1)
         .set_load_balancing_method("block")
         .initialize(["cpu"] * N_DEV))
    rng = np.random.default_rng(seed)
    cells = g.plan.cells
    for name, (shape, dtype) in NP_DSCHEMA.items():
        g.set(name, cells,
              (rng.random((len(cells),) + shape) * 100).astype(dtype))
    return g


def _step(g, rng):
    cells = g.plan.cells
    g.set("rho", cells, rng.random(len(cells)).astype(np.float32))


def _full_bytes(g, tmp_path):
    p = str(tmp_path / "__direct.dc")
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


def _two_pass_keyframe(g, path):
    for rank in (0, 1):
        _role(g, rank)
        resilience.save_checkpoint(g, path)
    _unfake(g)


def _two_pass_delta(g, path, parent, parent_step, step, fields):
    for rank in (0, 1):
        _role(g, rank)
        resilience.save_delta_checkpoint(
            g, path, parent_path=parent, parent_step=parent_step,
            step=step, fields=fields)
    _unfake(g)


def test_two_phase_delta_commit_bitwise(tmp_path):
    g = _delta_grid()
    kf = str(tmp_path / "mp_00000000.dc")
    _two_pass_keyframe(g, kf)
    _step(g, np.random.default_rng(10))
    dp = str(tmp_path / "mp_00000001.dcd")
    _two_pass_delta(g, dp, kf, 0, 1, ["rho"])
    rec = resilience.read_sidecar(dp)
    assert rec["slices"], "a two-phase delta carries the slice table"
    assert rec["delta"]["fields"] == ["rho"]
    assert _materialized_bytes(dp, g.fields) == _full_bytes(g, tmp_path)
    info = supervise.resume_latest(tmp_path, DSCHEMA, stem="mp",
                                   device="cpu")
    assert info is not None and info.step == 1 and not info.salvaged
    cells = g.plan.cells
    for name in DSCHEMA:
        np.testing.assert_array_equal(info.grid.get(name, cells),
                                      g.get(name, cells))


@pytest.mark.parametrize("phase", ["meta", "slice", "written", "commit",
                                   "publish"])
def test_delta_rank_death_every_phase_keeps_chain(tmp_path, phase):
    """A rank death at every two-phase delta-commit phase leaves the
    previous keyframe + delta chain byte for byte and resumable."""
    g = _delta_grid()
    kf = str(tmp_path / "dk_00000000.dc")
    _two_pass_keyframe(g, kf)
    rng = np.random.default_rng(12)
    _step(g, rng)
    d1 = str(tmp_path / "dk_00000001.dcd")
    _two_pass_delta(g, d1, kf, 0, 1, ["rho"])
    before = {p: open(p, "rb").read() for p in (kf, d1)}
    _step(g, rng)
    d2 = str(tmp_path / "dk_00000002.dcd")
    dying = 1 if phase in ("commit", "publish") else 0
    plan = faults.FaultPlan()
    plan.rank_death(phase=phase, rank=dying)
    with plan:
        try:
            _two_pass_delta(g, d2, kf, 0, 2, ["rho"])
        except faults.InjectedRankDeath:
            pass
    _unfake(g)
    for p in (kf, d1):
        assert open(p, "rb").read() == before[p], f"{phase} tore {p}"
    assert resilience.verify_chain(d1)
    info = supervise.resume_latest(tmp_path, DSCHEMA, stem="dk",
                                   device="cpu")
    if phase == "publish":
        assert os.path.exists(d2)
    assert info is not None and info.step == 1 and not info.salvaged


# ---------------------------------------------------------------------
# a real two-rank gloo group on localhost
# ---------------------------------------------------------------------

_WORKER = r"""
import json, os, sys, zlib
import numpy as np
import torch
from dccrg_tpu_torch import Grid, coord, resilience

r, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
coord.distributed_init(f"127.0.0.1:{port}", 2, r, retries=20, backoff=0.1)
os.environ["DCCRG_BARRIER_TIMEOUT"] = "30"
def mk():
    return (Grid(cell_data={"v": torch.float32, "n": torch.int32,
                            "p": ((3,), torch.float32)})
            .set_initial_length((8, 8, 4)).set_maximum_refinement_level(1)
            .set_neighborhood_length(1).initialize(["cpu"] * 4,
                                                   partition="morton"))
g = mk()
for cid in g.plan.cells[::11]:
    g.refine_completely(int(cid))
g.stop_refining()
cells = g.plan.cells
rng = np.random.default_rng(6)
v = rng.random(len(cells)).astype(np.float32)
n = rng.integers(0, 4, len(cells)).astype(np.int32)
p = rng.random((len(cells), 3)).astype(np.float32)
# this rank holds only its own partitions' values: the other rank's rows
# are garbage here, so a save that read them would show it
mine = np.isin(g.plan.owner, [0, 1] if r == 0 else [2, 3])
g.set_many(cells, {"v": np.where(mine, v, -1.0).astype(np.float32),
                   "n": np.where(mine, n, 99).astype(np.int32),
                   "p": np.where(mine[:, None], p, -5.0).astype(np.float32)})
g._proc_local_dev = np.array([d in ((0, 1) if r == 0 else (2, 3))
                              for d in range(4)])
fn = os.path.join(out_dir, "mp.dc")
out = {"multiproc": bool(g._multiproc), "rank": coord.process_rank(g)}
resilience.save_checkpoint(g, fn, variable={"p": "n"})
out["verify"] = resilience.verify_checkpoint(fn)
back = mk()
for cid in back.plan.cells[::11]:
    back.refine_completely(int(cid))
back.stop_refining()
back._proc_local_dev = g._proc_local_dev.copy()
back.load_grid_data(fn, variable={"p": "n"})
lm = back._proc_local_dev[back.plan.owner]
got_n = back.get("n", cells[lm])
got_v = back.get("v", cells[lm])
out["v_ok"] = bool(np.array_equal(got_v, v[lm]))
out["n_ok"] = bool(np.array_equal(got_n, n[lm]))
got_p = back.get("p", cells[lm])
keep = np.arange(3)[None, :] < n[lm][:, None]
out["p_ok"] = bool(np.array_equal(np.where(keep, got_p, 0), np.where(keep, p[lm], 0)))
try:
    back.get("v", cells[~lm][:2])
    out["foreign"] = "read"
except KeyError:
    out["foreign"] = "KeyError"
with open(fn, "rb") as f:
    out["crc"] = zlib.crc32(f.read())
print("RESULT " + json.dumps(out), flush=True)
try:
    # rank 0 hosts the group's store and leaves once every rank arrived;
    # a peer polling the store after that sees it gone, which is fine
    coord.barrier("end", timeout=30)
except Exception:
    pass
os._exit(0)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_gloo_group_two_phase_save_and_load(tmp_path):
    """Two real processes in a gloo group on localhost, each holding only
    its own partitions' values: the two-phase save (store barriers, the
    CRC exchange by all_gather_object, the group-merged counts of a
    ragged field) writes the one-process file of the true state, and
    each rank's load returns its own rows bit for bit."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    res = {}
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err[-3000:]
            line = [ln for ln in out.splitlines()
                    if ln.startswith("RESULT ")][-1]
            res[r] = json.loads(line[len("RESULT "):])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r in range(2):
        assert res[r]["multiproc"] and res[r]["rank"] == r
        assert res[r]["verify"] == []
        assert res[r]["v_ok"] and res[r]["n_ok"] and res[r]["p_ok"]
        assert res[r]["foreign"] == "KeyError"
    # the file: a one-process save of the true (merged) state
    g = (Grid(cell_data={"v": torch.float32, "n": torch.int32,
                         "p": ((3,), torch.float32)})
         .set_initial_length((8, 8, 4)).set_maximum_refinement_level(1)
         .set_neighborhood_length(1).initialize(["cpu"] * 4,
                                                partition="morton"))
    for cid in g.plan.cells[::11]:
        g.refine_completely(int(cid))
    g.stop_refining()
    cells = g.plan.cells
    rng = np.random.default_rng(6)
    g.set_many(cells, {"v": rng.random(len(cells)).astype(np.float32),
                       "n": rng.integers(0, 4, len(cells)).astype(np.int32),
                       "p": rng.random((len(cells), 3)).astype(np.float32)})
    one = tmp_path / "one.dc"
    g.save_grid_data(str(one), variable={"p": "n"})
    assert (tmp_path / "mp.dc").read_bytes() == one.read_bytes()
