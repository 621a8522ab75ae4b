"""The port's native host engine against its NumPy paths and the reference.

``dccrg_tpu_torch/native`` is the port's copy of the reference's C++
host engine, built with g++ at first use. For every wrapper and every
dispatch site, the port's native result equals the port's NumPy result
(``native.engine(False)``) and the reference's (``dccrg_tpu.native``
and, with its ``lib`` set to None, its NumPy paths) bit for bit: the
neighbor engine on uniform and refined grids, the bulk mapping and
geometry queries, the one-pass uniform tables, whole hybrid plans across
commits with stream reuse, the SFC keys, the error paths, and a plan
built with one OpenMP thread.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dccrg_tpu import native as ref_native
from dccrg_tpu import neighbors as ref_neighbors
from dccrg_tpu.geometry import CartesianGeometry as RefCartesian
from dccrg_tpu.geometry import NoGeometry as RefNoGeometry
from dccrg_tpu.geometry import StretchedCartesianGeometry as RefStretched
from dccrg_tpu.mapping import Mapping as RefMapping
from dccrg_tpu.partition import hilbert_key, morton_key
from dccrg_tpu.topology import GridTopology as RefTopology

import dccrg_tpu_torch as port
from dccrg_tpu_torch import hybrid as port_hybrid
from dccrg_tpu_torch import native
from dccrg_tpu_torch import neighbors as port_neighbors
from dccrg_tpu_torch.geometry import _NATIVE_BATCH

from torch_amr_fixture import assert_plans_equal, grid_pair

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def engines():
    """Both engines must be there: a missing one would make every
    comparison below compare the NumPy paths with themselves."""
    if native.lib() is None:
        pytest.fail("the port's native engine did not build (g++ missing?)")
    if ref_native.lib is None:
        pytest.fail("the reference's native engine did not build")


def _equal_tuples(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, (what, i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} [{i}]")


def _metadata(length, max_lvl, periodic):
    return ((port.Mapping(length, max_lvl), port.GridTopology(periodic)),
            (RefMapping(length, max_lvl), RefTopology(periodic)))


def _refined_cells(mapping):
    """A 2:1-valid leaf set of a (4, 4, 4) max-level-2 grid: uniform
    level 1 with one level-1 cell refined to level 2
    (tests/test_native.py's refined set)."""
    level0 = np.arange(1, 4 * 4 * 4 + 1, dtype=np.uint64)
    level1 = mapping.get_all_children(level0).ravel()
    one = level1[21]
    return np.sort(np.concatenate([level1[level1 != one],
                                   mapping.get_all_children(one)]))


def _neighbors_all_engines(mapping_pair, cells, query, hood, fn):
    """``fn``'s result from the port's native engine, the port's NumPy
    path, the reference's native engine and its NumPy path."""
    (pm, pt), (rm, rt) = mapping_pair
    port_fn, ref_fn = fn
    out = {"port native": port_fn(pm, pt, cells, query, hood)}
    with native.engine(False):
        out["port numpy"] = port_fn(pm, pt, cells, query, hood)
    out["ref native"] = ref_fn(rm, rt, cells, query, hood)
    saved, ref_native.lib = ref_native.lib, None
    try:
        out["ref numpy"] = ref_fn(rm, rt, cells, query, hood)
    finally:
        ref_native.lib = saved
    return out


def _check_same(out):
    want = out.pop("port native")
    for name, got in out.items():
        _equal_tuples(got, want, name)


OF = (port_neighbors.find_neighbors_of, ref_neighbors.find_neighbors_of)
TO = (port_neighbors.find_neighbors_to_subset,
      ref_neighbors.find_neighbors_to_subset)


@pytest.mark.parametrize("hood_len", [0, 1, 2])
@pytest.mark.parametrize("periodic", [(False, False, False), (True, True, True)])
def test_find_neighbors_of_uniform(hood_len, periodic):
    pair = _metadata((5, 4, 3), 0, periodic)
    cells = np.arange(1, 5 * 4 * 3 + 1, dtype=np.uint64)
    hood = port.make_neighborhood(hood_len)
    _check_same(_neighbors_all_engines(pair, cells, cells, hood, OF))
    # the raw native stream (before dedup) against the NumPy engine's
    pm, pt = pair[0]
    raw = native.find_neighbors_of(pm, pt, cells, cells, hood)
    _equal_tuples(raw, port_neighbors._find_neighbors_of_numpy(
        pm, pt, cells, cells, hood), "raw stream")


@pytest.mark.parametrize("hood_len", [0, 1, 2])
@pytest.mark.parametrize("periodic", [(False, False, False), (True, False, True)])
def test_find_neighbors_of_refined(hood_len, periodic):
    pair = _metadata((4, 4, 4), 2, periodic)
    cells = _refined_cells(pair[0][0])
    hood = port.make_neighborhood(hood_len)
    _check_same(_neighbors_all_engines(pair, cells, cells, hood, OF))
    # a query subset (every third cell)
    _check_same(_neighbors_all_engines(pair, cells, cells[::3], hood, OF))


@pytest.mark.parametrize("hood_len", [0, 1, 2])
@pytest.mark.parametrize("periodic", [(False, False, False), (True, True, True)])
def test_find_neighbors_to_subset(hood_len, periodic):
    """The hard-query enumeration of find_neighbors_to_subset: uniform
    and refined grids, a subset of queries around the refined cell."""
    hood = port.make_neighborhood(hood_len)
    pair = _metadata((5, 4, 3), 0, periodic)
    cells = np.arange(1, 5 * 4 * 3 + 1, dtype=np.uint64)
    _check_same(_neighbors_all_engines(pair, cells, cells[::2], hood, TO))
    pair = _metadata((4, 4, 4), 2, periodic)
    cells = _refined_cells(pair[0][0])
    _check_same(_neighbors_all_engines(pair, cells, cells, hood, TO))
    _check_same(_neighbors_all_engines(pair, cells, cells[-40:], hood, TO))


def test_gap_raises_structure_error():
    (pm, pt), (rm, rt) = _metadata((3, 3, 3), 0, (False, False, False))
    cells = np.arange(1, 28, dtype=np.uint64)
    broken = cells[cells != 14]  # remove the middle cell
    hood = port.make_neighborhood(1)
    with pytest.raises(port.StructureError, match="does not tile"):
        native.find_neighbors_of(pm, pt, broken, broken, hood)
    with pytest.raises(port.StructureError):
        port.find_neighbors_of(pm, pt, broken, broken, hood)
    with native.engine(False), pytest.raises(port.StructureError):
        port.find_neighbors_of(pm, pt, broken, broken, hood)
    with pytest.raises(ref_neighbors.StructureError):
        ref_neighbors.find_neighbors_of(rm, rt, broken, broken, hood)


def test_level_jump_raises_structure_error():
    """A level-0 cell beside a level-2 cell (2:1 violated): the native
    engine raises the errors the reference's raises. Which cell it
    reports first, and so which of the two messages, depends on the
    OpenMP threads' order in both engines."""
    (pm, pt), (rm, rt) = _metadata((2, 1, 1), 2, (False, False, False))
    kids = pm.get_all_children(np.uint64(1))
    cells = np.sort(np.concatenate(
        [[np.uint64(2)], kids[kids != kids[1]],
         pm.get_all_children(kids[1])]).astype(np.uint64))
    hood = port.make_neighborhood(1)
    with pytest.raises(port.StructureError) as got:
        port.find_neighbors_of(pm, pt, cells, cells, hood)
    with pytest.raises(ref_neighbors.StructureError) as want:
        ref_neighbors.find_neighbors_of(rm, rt, cells, cells, hood)
    with native.engine(False), pytest.raises(port.StructureError):
        port.find_neighbors_of(pm, pt, cells, cells, hood)

    def shape(msg):
        return re.sub(r"\d+|\[[^]]*\]", "#", msg)

    known = {"no neighbor found for cell # at offset #: grid does not tile "
             "the domain",
             "cell # offset #: window neither tiled by level # cells nor "
             "coarser (#:# balance violated or grid has gaps)"}
    assert {shape(str(got.value)), shape(str(want.value))} <= known


def test_invalid_query_raises():
    (pm, pt), _ = _metadata((2, 2, 2), 0, (False, False, False))
    cells = np.arange(1, 9, dtype=np.uint64)
    hood = port.make_neighborhood(1)
    bad = np.array([999], dtype=np.uint64)
    with pytest.raises(ValueError, match="invalid cell id"):
        native.find_neighbors_of(pm, pt, cells, bad, hood)
    with pytest.raises(ValueError, match="invalid cell id"):
        native.find_neighbors_to_subset_raw(pm, pt, cells, bad, hood)
    with native.engine(False), pytest.raises(ValueError):
        port.find_neighbors_of(pm, pt, cells, bad, hood)


@pytest.mark.parametrize("n", [_NATIVE_BATCH, 10_000])
def test_bulk_mapping_queries(n):
    """refinement_levels / cell_indices on batches at and over the
    dispatch size, invalid ids included."""
    pm = port.Mapping((16, 16, 16), 2)
    rm = RefMapping((16, 16, 16), 2)
    rng = np.random.default_rng(3)
    cells = rng.integers(0, int(pm.last_cell) + 1000, n, dtype=np.uint64)
    queries = ("get_refinement_level", "get_indices",
               "get_cell_length_in_indices", "get_parent", "get_child",
               "get_level_0_parent", "get_all_children", "get_siblings")
    got = [getattr(pm, q)(cells) for q in queries]
    _equal_tuples(got[:2], (native.refinement_levels(pm, cells),
                            native.cell_indices(pm, cells)), "wrappers")
    with native.engine(False):
        _equal_tuples(got, [getattr(pm, q)(cells) for q in queries],
                      "port numpy")
    _equal_tuples(got, [getattr(rm, q)(cells) for q in queries], "reference")
    lvl = got[0]
    assert (lvl < 0).any()


def _geometry(kind, mapping, topology, mod):
    if kind == "cartesian":
        return mod[0](mapping, topology, start=(0.5, -1.0, 2.0),
                      level_0_cell_length=(0.1, 0.2, 0.3))
    if kind == "stretched":
        rng = np.random.default_rng(1)
        coords = [np.cumsum(np.abs(rng.standard_normal(n + 1)) + 0.05)
                  for n in (4, 3, 2)]
        return mod[1](mapping, topology, coordinates=coords)
    return mod[2](mapping, topology)


@pytest.mark.parametrize("kind", ["cartesian", "stretched", "none"])
def test_geometry_queries(kind):
    """get_length / get_center / get_min / get_max on a batch over the
    dispatch size: native, the port's NumPy path, per-slice (below the
    size) and the reference, bit for bit, NaN rows included."""
    (pm, pt), (rm, rt) = _metadata((4, 3, 2), 3, (False, True, False))
    pg = _geometry(kind, pm, pt, (port.CartesianGeometry,
                                  port.StretchedCartesianGeometry,
                                  port.NoGeometry))
    rg = _geometry(kind, rm, rt, (RefCartesian, RefStretched, RefNoGeometry))
    rng = np.random.default_rng(0)
    big = rng.integers(1, int(pm.get_last_cell()) + 1,
                       size=_NATIVE_BATCH + 100).astype(np.uint64)
    big[::97] = 0  # invalid ids: NaN rows
    for method in ("get_length", "get_center", "get_min", "get_max"):
        got = getattr(pg, method)(big)
        with native.engine(False):
            plain = getattr(pg, method)(big)
        small = np.concatenate([getattr(pg, method)(big[i:i + 1000])
                                for i in range(0, len(big), 1000)])
        for other, what in ((plain, "numpy"), (small, "slices"),
                            (getattr(rg, method)(big), "reference")):
            np.testing.assert_array_equal(got, other, err_msg=f"{method} {what}")
    # the (min corner, length) pass itself (CartesianGeometry's
    # get_length reads its per-level table instead)
    got = native.geometry_min_len(
        pm, [pg._boundaries(d) for d in range(3)], big)
    with native.engine(False):
        _equal_tuples(got, pg._min_and_length_flat(big), "min_len")


@pytest.mark.parametrize("hood_len", [0, 1, 2])
@pytest.mark.parametrize("periodic", [(True, True, True), (False, True, False)])
def test_uniform_tables_forced(monkeypatch, periodic, hood_len):
    """DCCRG_FORCE_TABLES=1 on a level-0 grid: the dense-table plan
    written by native.uniform_tables equals the port's NumPy build and
    the reference's."""
    monkeypatch.setenv("DCCRG_FORCE_TABLES", "1")
    r, p = grid_pair((5, 4, 3), 1, hood_len, periodic,
                     user_hood=[[1, 0, 0], [0, 0, -1]])
    with native.engine(False):
        _, q = grid_pair((5, 4, 3), 1, hood_len, periodic,
                         user_hood=[[1, 0, 0], [0, 0, -1]])
    assert p.plan.hoods[port.DEFAULT_NEIGHBORHOOD_ID].closed_form is None
    assert_plans_equal(r, p)
    assert_plans_equal(r, q)
    # the wrapper itself against the lattice maps of the NumPy build
    offs = port.make_neighborhood(hood_len)
    rows, mask = native.uniform_tables((5, 4, 3), periodic, offs,
                                       np.arange(60, dtype=np.int32), None, 99)
    hood = q.plan.hoods[port.DEFAULT_NEIGHBORHOOD_ID]
    np.testing.assert_array_equal(mask, hood.nbr_mask[0, :60])
    np.testing.assert_array_equal(np.where(mask, rows, 99),
                                  np.where(mask, hood.nbr_rows[0, :60], 99))


def _commit(g, step):
    """Commit ``step`` of the reference's stream-reuse sequence
    (tests/test_hybrid.py): two levels of refinement first, then
    recommits whose hard streams come from the reuse cache
    (dccrg_tpu/hybrid.py:548-564)."""
    if step == 0:
        for c in (1, 2, 3, 8, 9, 43, 44):
            g.refine_completely(c)
    else:
        lvl = g.mapping.get_refinement_level(g.plan.cells)
        if step == 2:
            for c in g.plan.cells[lvl == 2][:8]:
                g.unrefine_completely(c)
        else:
            for c in g.plan.cells[lvl == 1][step * 8:step * 8 + 8]:
                g.refine_completely(c)
    g.stop_refining()


HYBRID_WRITERS = ("level_lookup", "far_tables", "easy_tables", "hard_counts",
                  "hard_fill", "sorted_positions", "stream_remap_merge",
                  "find_neighbors_of")


@pytest.mark.parametrize("periodic", [(False, True, False), (True, True, True)])
def test_hybrid_plans_across_commits(monkeypatch, periodic):
    """Whole hybrid plans: the port's native build, its NumPy build and
    the reference's, bit for bit after the first commit and after each
    recommit (arena buffers reused in place); the native build's hard
    streams come from the reuse cache after the first commit, and each
    native writer of the build is called (by the native build only)."""
    calls = {name: 0 for name in HYBRID_WRITERS}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] += native.lib() is not None
            return fn(*args, **kw)
        return wrapper

    for name in HYBRID_WRITERS:
        monkeypatch.setattr(native, name, counted(name, getattr(native, name)))
    r, p = grid_pair((6, 6, 6), 2, 1, periodic)
    with native.engine(False):
        _, q = grid_pair((6, 6, 6), 2, 1, periodic)
    sink = []
    port_hybrid._PHASE_SINK = sink
    try:
        for step in range(4):
            _commit(r, step)
            _commit(p, step)
            with native.engine(False):
                _commit(q, step)
            assert_plans_equal(r, p, lists=step == 3)
            assert_plans_equal(r, q, lists=step == 3)
    finally:
        port_hybrid._PHASE_SINK = None
    reused = [lab for lab, _ in sink if lab.startswith("hard streams")]
    assert len(reused) == 8 and any("reused 0/" not in lab for lab in reused)
    assert all(calls.values()), calls


def test_engine_switched_between_commits():
    """One grid whose commits alternate between the engines: each plan
    reuses the previous build's arena buffers, and none of their stale
    contents reaches the plan (equal to the reference after each)."""
    r, p = grid_pair((6, 6, 6), 2, 2, (True, False, True),
                     user_hood=[[1, 0, 0], [0, -1, 0], [1, 1, 1]])
    for step in range(4):
        _commit(r, step)
        with native.engine(step % 2 == 1):
            _commit(p, step)
        assert_plans_equal(r, p, lists=False)
    assert p._plan_arena.stats()["hits"] > 0


def test_level_lookup_matches_numpy_lookup():
    """The batched native level lookup against _LevelBlock's per-offset
    NumPy lookup, at every symmetrized offset of a reach-2 hood, with
    the position lattice and with the binary search."""
    from dccrg_tpu_torch.hybrid import _check_offsets, _LevelBlock

    _, p = grid_pair((6, 5, 4), 2, 2, (False, True, False))
    _commit(p, 0)
    cells, m = p.plan.cells, p.mapping
    a = int(np.searchsorted(cells, np.uint64(m._level_first[1])))
    b = int(np.searchsorted(cells, np.uint64(m._level_first[2])))
    offs = _check_offsets({0: port.make_neighborhood(2)})
    with native.engine(False):
        plain = _LevelBlock(m, (False, True, False), cells, 1, a, b)
    for lattice in (True, False):
        blk = _LevelBlock(m, (False, True, False), cells, 1, a, b)
        if not lattice:
            blk._PLAT_MAX_NATIVE = 0
        blk.precompute(offs)
        assert blk._batch is not None
        for o in offs:
            pos, valid, exist = blk.lookup(o)
            ppos, pvalid, pexist = plain.lookup(o)
            np.testing.assert_array_equal(valid, pvalid)
            np.testing.assert_array_equal(exist, pexist)
            np.testing.assert_array_equal(pos, ppos)


def test_sorted_positions_and_stencil_table():
    rng = np.random.default_rng(5)
    hay = np.unique(rng.integers(0, 1 << 40, 5000, dtype=np.uint64))
    needles = np.sort(rng.choice(hay, 700, replace=False))
    needles[::5] += np.uint64(1)  # some absent: insertion points
    needles.sort()
    np.testing.assert_array_equal(native.sorted_positions(hay, needles),
                                  np.searchsorted(hay, needles))
    # build_stencil_table: a ragged stream padded per (device, row) in
    # entry order, against the plain stable-sort padding and the
    # reference's native wrapper
    n_dev, L, pad = 2, 40, 99
    n = 300
    dev = rng.integers(0, n_dev, n).astype(np.int32)
    src = rng.integers(0, L, n).astype(np.int32)
    nbr = rng.integers(0, L, n).astype(np.int32)
    offs = rng.integers(-4, 5, (n, 3)).astype(np.int64)
    got = native.build_stencil_table(dev, src, nbr, offs, n_dev, L, pad)
    want = ref_native.build_stencil_table(dev, src, nbr, offs, n_dev, L, pad)
    _equal_tuples(got, want, "reference")
    key = dev.astype(np.int64) * L + src
    order = np.argsort(key, kind="stable")
    ks = key[order]
    start = np.maximum.accumulate(np.where(
        np.r_[True, ks[1:] != ks[:-1]], np.arange(n), 0))
    slot = np.arange(n) - start
    S = int(slot.max()) + 1
    rows = np.full(n_dev * L * S, pad, np.int32)
    out_offs = np.zeros((n_dev * L * S, 3), np.int32)
    mask = np.zeros(n_dev * L * S, bool)
    flat = ks * S + slot
    rows[flat], out_offs[flat], mask[flat] = nbr[order], offs[order], True
    _equal_tuples(got, (rows.reshape(n_dev, L, S),
                        out_offs.reshape(n_dev, L, S, 3),
                        mask.reshape(n_dev, L, S)), "plain")


@pytest.mark.parametrize("max_lvl", [0, 1, 3])
def test_sfc_keys(max_lvl):
    """native.sfc_keys against the reference's morton_key / hilbert_key
    (its native and its NumPy paths)."""
    pm, rm = port.Mapping((8, 8, 8), max_lvl), RefMapping((8, 8, 8), max_lvl)
    rng = np.random.default_rng(7)
    cells = np.unique(rng.integers(1, int(pm.last_cell) + 1, 500,
                                   dtype=np.uint64))
    idx = pm.get_indices(cells)
    bits = max(int(x).bit_length() for x in pm.get_index_length())
    got = (native.sfc_keys(idx, bits, "morton"),
           native.sfc_keys(idx, bits, "hilbert"))
    _equal_tuples(got, (morton_key(rm, cells), hilbert_key(rm, cells)),
                  "reference native")
    saved, ref_native.lib = ref_native.lib, None
    try:
        want = (morton_key(rm, cells), hilbert_key(rm, cells))
    finally:
        ref_native.lib = saved
    _equal_tuples(got, want, "reference numpy")


_ONE_THREAD = """
import json, sys
import numpy as np
import torch
import dccrg_tpu_torch as port
from dccrg_tpu_torch import native
g = (port.Grid(cell_data={"v": torch.float32}).set_initial_length((12, 10, 8))
     .set_periodic(True, False, True).set_maximum_refinement_level(2)
     .set_neighborhood_length(1).initialize("cpu"))
for c in range(100, 400, 7):
    g.refine_completely(c)
g.stop_refining()
h = g.plan.hoods[port.DEFAULT_NEIGHBORHOOD_ID]
np.savez(sys.argv[1], **{k: getattr(h, k) for k in sys.argv[2].split(",")})
print(json.dumps(native.build_info))
"""
TABLES = "nbr_rows,nbr_mask,scale_rows,hard_rows,hard_nbr_rows,hard_offs,hard_mask"


def test_plan_with_one_openmp_thread(tmp_path):
    """The same plan built in a process with OMP_NUM_THREADS=1 and in
    one with the default thread count: equal bit for bit."""
    runs = {}
    for threads in ("1", None):
        env = dict(os.environ)
        env.pop("OMP_NUM_THREADS", None)
        if threads:
            env["OMP_NUM_THREADS"] = threads
        env["PYTHONPATH"] = str(ROOT)
        out = tmp_path / f"plan{threads}.npz"
        proc = subprocess.run(
            [sys.executable, "-c", _ONE_THREAD, str(out), TABLES],
            env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        runs[threads] = (json.loads(proc.stdout.splitlines()[-1]),
                         np.load(out))
    (info1, one), (info_n, many) = runs["1"], runs[None]
    assert info1["threads"] == 1
    assert info_n["openmp"] and info_n["threads"] >= 1
    for name in TABLES.split(","):
        np.testing.assert_array_equal(one[name], many[name], err_msg=name)


def test_switches(monkeypatch):
    """DCCRG_TPU_NATIVE=0 and engine(False) select the NumPy paths;
    engine() restores the previous choice, also after an error."""
    assert native.lib() is not None
    monkeypatch.setenv("DCCRG_TPU_NATIVE", "0")
    assert native.lib() is None
    assert native.uniform_tables((2, 2, 2), (True,) * 3,
                                 port.make_neighborhood(0),
                                 np.arange(8, dtype=np.int32), None, 8) is None
    monkeypatch.delenv("DCCRG_TPU_NATIVE")
    with pytest.raises(KeyError):
        with native.engine(False):
            assert native.lib() is None
            with native.engine(True):
                assert native.lib() is not None
            assert native.lib() is None
            raise KeyError("leave the block")
    assert native.lib() is not None
    info = native.build_info
    assert info["gxx"].startswith("g++") and Path(info["path"]).is_file()
    assert Path(info["path"]).parent == ROOT / "dccrg_tpu_torch" / "_build"
