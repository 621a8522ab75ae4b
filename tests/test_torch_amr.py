"""The port's AMR commit and neighbor engine against the reference.

The counterpart of tests/test_amr.py and tests/test_neighbors.py for
``dccrg_tpu_torch``: the same seeded request sequences go through the
reference (on a one-device mesh) and the port (on the CPU), and after
every commit the cells, the created and removed sets, the plan layout
and every hood table agree bit for bit; the neighbor engine's entries,
the queries and the data projections agree exactly.
"""

import numpy as np
import pytest

from dccrg_tpu import amr as ref_amr
from dccrg_tpu import neighbors as ref_nb

from dccrg_tpu_torch import amr as port_amr
from dccrg_tpu_torch import neighbors as port_nb
from dccrg_tpu_torch.mapping import Mapping
from dccrg_tpu_torch.topology import GridTopology

from torch_amr_fixture import assert_plans_equal, both, grid_pair


def _kid(g, cell, k=0):
    return int(g.mapping.get_all_children(np.uint64(cell))[k])


# request sequences of tests/test_amr.py: each is a list of commits,
# each commit a list of (request, cell or callable(grid) -> cell)
SEQUENCES = {
    "refine": ((2, 2, 2), 1, [[("refine", 1)]]),
    "induced_2to1": ((4, 4, 4), 2, [[("refine", 1)],
                                    [("refine", lambda g: _kid(g, 1))]]),
    "dont_refine_spreads": ((4, 4, 4), 2, [
        [("refine", 1)],
        [("dont_refine", 2), ("refine", lambda g: _kid(g, 1))]]),
    "unrefine_merges": ((2, 2, 2), 1, [
        [("refine", 1)], [("unrefine", lambda g: _kid(g, 1, 3))]]),
    "dont_unrefine_blocks": ((2, 2, 2), 1, [
        [("refine", 1)],
        [("dont_unrefine", lambda g: _kid(g, 1, 0)),
         ("unrefine", lambda g: _kid(g, 1, 3))]]),
    "unrefine_blocked_by_refine": ((2, 2, 2), 2, [
        [("refine", 1)],
        [("unrefine", lambda g: _kid(g, 1, 0)),
         ("refine", lambda g: _kid(g, 1, 0))]]),
    "unrefine_blocked_by_fine_neighbor": ((2, 1, 1), 2, [
        [("refine", 1), ("refine", 2)],
        [("refine", lambda g: _kid(g, 1, 1))],
        [("unrefine", lambda g: _kid(g, 2, 0))]]),
    "deep_block": ((6, 6, 6), 2, [
        [("refine", c) for c in (1, 2, 3, 8, 9, 43, 44)],
        [("refine", lambda g, k=k: int(g.plan.cells[
            g.mapping.get_refinement_level(g.plan.cells) == 1][k]))
         for k in range(8)]]),
}

REQUESTS = {"refine": "refine_completely", "unrefine": "unrefine_completely",
            "dont_refine": "dont_refine", "dont_unrefine": "dont_unrefine"}


@pytest.mark.parametrize("periodic", [(False, False, False), (True, True, False)])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_commit_sequences_match_reference(name, periodic):
    """Every request's answer, each commit's created and removed cells
    and the plan after it (layout, tables, lists) bit for bit."""
    length, max_lvl, commits = SEQUENCES[name]
    pair = grid_pair(length, max_lvl, periodic=periodic)
    for commit in commits:
        for req, cell in commit:
            oks = both(pair, lambda g: getattr(g, REQUESTS[req])(
                cell(g) if callable(cell) else cell))
            assert oks[0] == oks[1], (req, oks)
        new_r, new_p = both(pair, lambda g: g.stop_refining())
        np.testing.assert_array_equal(new_p, new_r)
        rem_r, rem_p = both(pair, lambda g: g.get_removed_cells())
        np.testing.assert_array_equal(rem_p, rem_r)
        assert_plans_equal(*pair)
        port_nb.verify_tiling(pair[1].mapping, pair[1].get_cells())


@pytest.mark.parametrize("seed", range(4))
def test_resolve_adaptation_matches_reference(seed):
    """Random request sets on a refined grid: every AmrResult set
    (cells, owners, created, removed, refined and unrefined parents,
    the dirty set) equal."""
    rng = np.random.default_rng(seed)
    length = tuple(int(v) for v in rng.integers(3, 6, 3))
    periodic = tuple(bool(b) for b in rng.integers(0, 2, 3))
    r, p = grid_pair(length, 2, periodic=periodic)
    first = r.plan.cells[rng.integers(0, len(r.plan.cells), 3)]
    for g in (r, p):
        for c in first:
            g.refine_completely(c)
        g.stop_refining()
    cells = r.plan.cells
    pick = lambda k: {int(c) for c in rng.choice(cells, size=k)}
    reqs = (pick(4), pick(12), pick(2), pick(3))
    m, t = r.mapping, r.topology
    offs = r.neighborhoods[-0xDCC]
    want = ref_amr.resolve_adaptation(m, cells, r.plan.owner, offs, *reqs,
                                      topology=t, hood_len=1)
    got = port_amr.resolve_adaptation(p.mapping, p.plan.cells, p.plan.owner,
                                      offs, *reqs, topology=p.topology,
                                      hood_len=1)
    for f in ("cells", "owner", "new_cells", "removed_cells",
              "refined_parents", "unrefined_parents", "changed_cells"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    fr = ref_amr.frontier_induced_refines(m, cells, r.plan.owner, offs,
                                          reqs[0], [0], topology=t)
    fp = port_amr.frontier_induced_refines(p.mapping, p.plan.cells,
                                           p.plan.owner, offs, reqs[0], [0],
                                           topology=p.topology)
    np.testing.assert_array_equal(fp, fr)


def _refined_cells(length, max_lvl, picks, periodic):
    m = Mapping(length)
    m.set_maximum_refinement_level(max_lvl)
    t = GridTopology(periodic)
    cells = np.arange(1, int(np.prod(length)) + 1, dtype=np.uint64)
    for c in picks:
        kids = m.get_all_children(np.uint64(c))
        cells = np.sort(np.concatenate([cells[cells != c], kids]))
    return m, t, cells


@pytest.mark.parametrize("hood_len", [0, 1, 2])
@pytest.mark.parametrize("seed", range(3))
def test_neighbor_engine_matches_reference(seed, hood_len):
    """find_neighbors_of, find_neighbors_to_subset and the inverted
    lists on random refined cell sets (tests/test_neighbors.py:212,
    :253), entry for entry."""
    rng = np.random.default_rng(seed)
    length = tuple(int(v) for v in rng.integers(2, 5, 3))
    n0 = int(np.prod(length))
    picks = rng.choice(np.arange(1, n0 + 1), size=min(2, n0), replace=False)
    periodic = (True, seed % 2 == 0, False)
    m, t, cells = _refined_cells(length, 2, picks, periodic)
    hood = port_nb.make_neighborhood(hood_len)
    q = cells[rng.choice(len(cells), size=min(9, len(cells)), replace=False)]
    for a, b in zip(ref_nb.find_neighbors_of(m, t, cells, q, hood),
                    port_nb.find_neighbors_of(m, t, cells, q, hood)):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(ref_nb.find_neighbors_to_subset(m, t, cells, q, hood),
                    port_nb.find_neighbors_to_subset(m, t, cells, q, hood)):
        np.testing.assert_array_equal(b, a)
    lr = ref_nb.build_neighbor_lists(m, t, cells, hood)
    lp = port_nb.build_neighbor_lists(m, t, cells, hood)
    for f in ("of_source", "of_neighbor", "of_offset", "of_item",
              "to_source", "to_neighbor", "to_offset"):
        np.testing.assert_array_equal(getattr(lp, f), getattr(lr, f), err_msg=f)


def test_structure_errors():
    """Gaps and overlaps raise the reference's StructureError."""
    m = Mapping((2, 2, 2))
    m.set_maximum_refinement_level(1)
    cells = np.arange(1, 9, dtype=np.uint64)
    port_nb.verify_tiling(m, cells)
    with pytest.raises(port_nb.StructureError):
        port_nb.verify_tiling(m, cells[:-1])
    kids = m.get_all_children(np.uint64(1))
    with pytest.raises(port_nb.StructureError):
        port_nb.verify_tiling(m, np.sort(np.concatenate([cells, kids])))
    m1 = Mapping((2, 1, 1))
    one = np.array([1], dtype=np.uint64)
    with pytest.raises(port_nb.StructureError):
        port_nb.find_neighbors_of(m1, GridTopology(), one, one,
                                  port_nb.make_neighborhood(0))


def test_queries_match_reference():
    """Neighbor queries, find_cells, existing-cell lookups and the
    get_cells criteria on a refined grid."""
    pair = grid_pair((4, 4, 2), 2, periodic=(True, False, False),
                     user_hood=[[1, 0, 0], [0, -1, 0], [1, 1, 1]])
    for g in pair:
        g.refine_completely(1)
        g.refine_completely(6)
        g.stop_refining()
        g.refine_completely(_kid(g, 6, 7))
        g.stop_refining()
    r, p = pair
    cells = r.get_cells()
    for c in cells[::5]:  # single-cell engine queries: a sample
        for hid in (-0xDCC, 42):
            assert p.get_neighbors_of(c, hid) == r.get_neighbors_of(c, hid)
            assert p.get_neighbors_to(c, hid) == r.get_neighbors_to(c, hid)
        assert p.get_face_neighbors_of(c) == r.get_face_neighbors_of(c)
        for off in ((1, 0, 0), (-1, 1, 0), (0, 0, 0), (1, 1, 1)):
            assert (p.get_neighbors_of_at_offset(c, *off)
                    == r.get_neighbors_of_at_offset(c, *off))
    for lo, hi, lv in (((0, 0, 0), (3, 3, 3), (0, 2)),
                       ((2, 1, 0), (9, 5, 1), (1, 2)),
                       ((0, 0, 0), (15, 15, 7), (2, 2))):
        np.testing.assert_array_equal(p.find_cells(lo, hi, *lv),
                                      r.find_cells(lo, hi, *lv))
    for idx in ((0, 0, 0), (3, 5, 1), (15, 15, 7), (16, 0, 0)):
        assert (p.get_existing_cell_from_indices(idx)
                == r.get_existing_cell_from_indices(idx))
    for crit, exact in ((p.HAS_LOCAL_NEIGHBOR_OF, False),
                        (p.HAS_REMOTE_NEIGHBOR_BOTH, False),
                        (p.HAS_LOCAL_NEIGHBOR_BOTH, True)):
        np.testing.assert_array_equal(p.get_cells(crit, exact),
                                      r.get_cells(crit, exact))
    np.testing.assert_array_equal(p.neighbor_type_masks(42),
                                  r.neighbor_type_masks(42))


def test_coordinate_variants_and_validation():
    """The ``_at`` variants and the request validation answer as the
    reference's do."""
    pair = grid_pair((4, 4, 4), 1)
    for call in (lambda g: g.refine_completely_at((0.5, 0.5, 0.5)),
                 lambda g: g.refine_completely_at((-1.0, 0.0, 0.0)),
                 lambda g: g.dont_refine_at((2.5, 0.5, 0.5)),
                 lambda g: g.refine_completely(99999),
                 lambda g: g.unrefine_completely(7)):
        a, b = both(pair, call)
        assert a == b
    new_r, new_p = both(pair, lambda g: g.stop_refining())
    np.testing.assert_array_equal(new_p, new_r)
    assert len(new_p) == 8
    for call in (lambda g: g.unrefine_completely_at((0.25, 0.25, 0.25)),
                 lambda g: g.dont_unrefine_at((0.75, 0.25, 0.25)),
                 lambda g: g.refine_completely(_kid(g, 1))):
        a, b = both(pair, call)
        assert a == b
    both(pair, lambda g: g.stop_refining())
    assert_plans_equal(*pair)


def test_data_projection_matches_reference():
    """The adapter.hpp protocol: children inherit the parent's value,
    unrefined parents average their children, survivors keep theirs,
    old data readable until cleared."""
    pair = grid_pair((2, 2, 2), 1)
    cells = pair[0].get_cells()
    for g in pair:
        g.set("v", cells, np.arange(1, 9, dtype=np.float32) * 10)
        g.refine_completely(3)
        g.refine_completely(5)
    new_r, new_p = both(pair, lambda g: g.stop_refining())
    for g in pair:
        assert g.get_old_data("v", np.uint64(5))[0] == 50.0
        g.assign_children_from_parents(fields=["v"])
        g.clear_refined_unrefined_data()
        with pytest.raises(KeyError):
            g.get_old_data("v", np.uint64(5))
    rng = np.random.default_rng(2)
    vals = rng.random(len(new_r)).astype(np.float32)
    for g in pair:
        g.set("v", new_r, vals)
        g.unrefine_completely(int(new_r[0]))
        g.stop_refining()
        g.average_parents_from_children(fields=["v"])
    r, p = pair
    np.testing.assert_array_equal(p.get_cells(), r.get_cells())
    np.testing.assert_array_equal(p.get("v", p.get_cells()),
                                  r.get("v", r.get_cells()))


def test_load_cells_matches_reference():
    """load_cells installs an arbitrary valid cell set (data reset)
    and refuses an invalid one."""
    pair = grid_pair((2, 2, 2), 1)
    kids = pair[0].mapping.get_all_children(np.uint64(8))
    cells = np.concatenate([np.arange(1, 8, dtype=np.uint64), kids])
    for g in pair:
        g.set("v", np.uint64(1), 3.0)
        g.load_cells(cells[::-1])
    assert_plans_equal(*pair)
    assert pair[1].get("v", np.uint64(1)) == 0.0
    with pytest.raises(port_nb.StructureError):
        pair[1].load_cells(cells[:-1])
