"""The port's partitioner (``dccrg_tpu_torch/partition.py``) against the
reference's (``dccrg_tpu/partition.py``, the Zoltan replacement,
dccrg.hpp:8482-8720): the same cells, weights, pins and edges give the
same owners bit for bit, for every method, the hierarchy and the
cut refinement; the curve keys through both engines of each package."""

import numpy as np
import pytest

import dccrg_tpu.native as ref_native
from dccrg_tpu import partition as ref_part
from dccrg_tpu.mapping import Mapping as RefMapping

from dccrg_tpu_torch import faults, native
from dccrg_tpu_torch import partition as part
from dccrg_tpu_torch.mapping import Mapping
from dccrg_tpu_torch.neighbors import build_neighbor_lists, make_neighborhood
from dccrg_tpu_torch.topology import GridTopology

LENGTHS = [(8, 1, 1), (6, 5, 4), (9, 7, 3)]


def _maps(length, max_lvl=0):
    return (RefMapping(length, maximum_refinement_level=max_lvl),
            Mapping(length, maximum_refinement_level=max_lvl))


def _cells(length):
    return np.arange(1, int(np.prod(length)) + 1, dtype=np.uint64)


def _edges(mapping, cells, periodic=(False, False, False)):
    nl = build_neighbor_lists(mapping, GridTopology(periodic), cells,
                              make_neighborhood(1))
    return (nl.of_source.astype(np.int64),
            np.searchsorted(cells, nl.of_neighbor))


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("method", part.PARTITION_METHODS)
@pytest.mark.parametrize("n_parts", [1, 2, 3, 4, 8])
def test_owners_match_reference(length, method, n_parts):
    rm, pm = _maps(length)
    cells = _cells(length)
    edges = _edges(pm, cells) if method == "cut" else None
    want = ref_part.partition_cells(rm, cells, n_parts, method, edges=edges)
    got = part.partition_cells(pm, cells, n_parts, method, edges=edges)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", part.PARTITION_METHODS)
def test_weights_and_pins_match_reference(method):
    length = (6, 5, 4)
    rm, pm = _maps(length)
    cells = _cells(length)
    rng = np.random.default_rng(3)
    w = rng.random(len(cells)) * 4
    w[:7] = 0.0
    pins = {1: 3, 17: 0, 60: 2, 999: 1}  # an unknown id is ignored
    edges = _edges(pm, cells) if method == "cut" else None
    want = ref_part.partition_cells(rm, cells, 4, method, weights=w,
                                    pins=pins, edges=edges)
    got = part.partition_cells(pm, cells, 4, method, weights=w, pins=pins,
                               edges=edges)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 3 and got[16] == 0 and got[59] == 2


def test_refined_cells_match_reference():
    rm, pm = _maps((2, 2, 2), max_lvl=1)
    kids = pm.get_all_children(np.uint64(1))
    cells = np.sort(np.concatenate([np.arange(2, 9, dtype=np.uint64), kids]))
    for method in part.PARTITION_METHODS:
        np.testing.assert_array_equal(
            part.partition_cells(pm, cells, 3, method),
            ref_part.partition_cells(rm, cells, 3, method))


def test_bad_inputs_raise_like_reference():
    rm, pm = _maps((8, 1, 1))
    cells = _cells((8, 1, 1))
    for mod, m in ((ref_part, rm), (part, pm)):
        with pytest.raises(ValueError):
            mod.partition_cells(m, cells, 4, "block", pins={1: 9})
        with pytest.raises(ValueError):
            mod.partition_cells(m, cells, 4, "nope")
        with pytest.raises(ValueError):
            mod.partition_cells(m, cells, 1, "block", weights=-np.ones(8))
        with pytest.raises(ValueError):
            mod.partition_cells(m, cells, 2, "block", weights=np.ones(3))


@pytest.mark.parametrize("levels", [
    [{"processes": 4, "method": "block"}, {"processes": 1, "method": "hilbert"}],
    [{"processes": 2, "method": "rcb"}],
    [{"processes": 3, "method": "cut"}, {"processes": 1, "method": "morton"}],
    [],
])
def test_hierarchical_matches_reference(levels):
    length = (9, 7, 3)
    rm, pm = _maps(length)
    cells = _cells(length)
    w = np.linspace(0.5, 2.0, len(cells))
    edges = _edges(pm, cells, (True, True, False))
    want = ref_part.partition_cells_hierarchical(
        rm, cells, 8, levels, weights=w, pins={5: 7}, edges=edges)
    got = part.partition_cells_hierarchical(
        pm, cells, 8, levels, weights=w, pins={5: 7}, edges=edges)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        part.partition_cells_hierarchical(pm, cells, 2,
                                          [{"processes": 1, "method": "x"}])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refine_cut_and_swap_pass_match_reference(seed):
    rng = np.random.default_rng(seed)
    length = (8, 8, 2)
    pm = Mapping(length)
    cells = _cells(length)
    src, dst = _edges(pm, cells)
    owner = rng.integers(0, 4, len(cells)).astype(np.int32)
    w = rng.random(len(cells)) + 0.5
    np.testing.assert_array_equal(
        part.refine_cut(owner, w, src, dst, 4),
        ref_part.refine_cut(owner, w, src, dst, 4))
    target = w.sum() / 4
    np.testing.assert_array_equal(
        part._swap_pass(owner.copy(), w, src, dst, 4, 1.1 * target,
                        0.9 * target),
        ref_part._swap_pass(owner.copy(), w, src, dst, 4, 1.1 * target,
                            0.9 * target))


def test_swap_pass_heals_boundary_the_greedy_cannot():
    owner = np.array([0, 0, 0, 1, 0, 1, 1, 1], dtype=np.int32)
    n = len(owner)
    src = np.concatenate([np.arange(n - 1), np.arange(1, n)])
    dst = np.concatenate([np.arange(1, n), np.arange(n - 1)])
    out = part.refine_cut(owner, np.ones(n), src, dst, 2, tol=1.1)
    assert int(np.sum(out[src] != out[dst])) == 2
    np.testing.assert_array_equal(np.bincount(out), [4, 4])


@pytest.mark.parametrize("kind", ["morton", "hilbert"])
@pytest.mark.parametrize("engine", [True, False])
def test_curve_keys_match_reference(kind, engine, monkeypatch):
    """The keys of each engine of the port equal the reference's NumPy
    keys (``dccrg_tpu.native.lib = None``)."""
    length = (16, 8, 4)
    rm, pm = _maps(length, max_lvl=2)
    cells = np.concatenate([_cells(length),
                            pm.get_all_children(np.uint64(3))])
    monkeypatch.setattr(ref_native, "lib", None)
    want = getattr(ref_part, kind + "_key")(rm, cells)
    with native.engine(engine):
        got = getattr(part, kind + "_key")(pm, cells)
    np.testing.assert_array_equal(got, want)


def test_partition_fault_site_fires():
    pm = Mapping((4, 4, 1))
    cells = _cells((4, 4, 1))
    plan = faults.FaultPlan()
    plan.mutation_error(site="partition.compute")
    with plan, pytest.raises(faults.InjectedMutationError):
        part.partition_cells(pm, cells, 2, "rcb")
    assert plan.fired("partition.compute") == 1
