"""The port's refined-grid plans on n partitions against the reference on
a mesh of n virtual CPU devices (``Mesh(np.array(jax.devices()[:n]))``
against ``["cpu"] * n``), bit for bit: cells, owners, rows, ghost ids,
the far/easy/hard tables, the pair tables and the to-tables, for
tests/test_hybrid.py's and tests/test_recommit.py's configurations on
2, 3, 4 and 8 partitions, ``block`` and ``morton``, with the hybrid
builder and under ``DCCRG_FORCE_GENERIC=1``, with the native engine
and with the NumPy engine. Before them, the native engine's table
writers with owner arrays against the same functions written in NumPy,
cross-partition ``-2 - position`` sentinels included."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dccrg_tpu.grid import Grid as RefGrid

from dccrg_tpu_torch import native
from dccrg_tpu_torch.grid import Grid
from dccrg_tpu_torch.uniform import _NeighborMaps

from torch_amr_fixture import assert_plans_equal


@pytest.fixture
def engine():
    """The native engine must be there: without it the comparisons
    below would hold the NumPy paths against themselves."""
    if native.lib() is None:
        pytest.fail("the port's native engine did not build (g++ missing?)")


COUNTS = (2, 3, 4, 8)


def mesh_of(n):
    return Mesh(np.array(jax.devices()[:n]), ("dev",))


# ---------------------------------------------------------------------
# the native engine's owner-array writers

def _sentinel_rows(nbr, reader, owner_of, row_of, pad, valid):
    """The writers' contract in NumPy: a neighbour the reader's
    partition owns gives its row, another partition's gives
    ``-2 - nbr`` and a fixup, an invalid slot the pad row."""
    rows = np.where(owner_of[np.where(valid, nbr, 0)] == reader,
                    row_of[np.where(valid, nbr, 0)], -2 - nbr)
    rows = np.where(valid, rows, pad).astype(np.int32)
    fix = valid & (owner_of[np.where(valid, nbr, 0)] != reader)
    return rows, fix


@pytest.mark.parametrize("n_own", [2, 3, 4])
@pytest.mark.parametrize("periodic", [(False, True, False), (True, True, True)])
def test_far_tables_with_owners(engine, n_own, periodic):
    rng = np.random.default_rng(10 + n_own)
    dims = (6, 5, 4)
    n0 = int(np.prod(dims))
    offs = np.array([[o0, o1, o2] for o2 in (-1, 0, 1) for o1 in (-1, 0, 1)
                     for o0 in (-1, 0, 1) if (o0, o1, o2) != (0, 0, 0)],
                    dtype=np.int64)
    k = len(offs)
    far_slots = np.sort(rng.choice(n0, 70, replace=False)).astype(np.int64)
    n_rows = 90
    far_rowidx = rng.choice(n_rows, len(far_slots), replace=False).astype(np.int64)
    row_of_pos0 = rng.integers(0, 1000, n0).astype(np.int32)
    owner0 = rng.integers(0, n_own, n0).astype(np.int32)
    rows_t = np.full((n_rows, k), 7, np.int32)
    mask_t = np.zeros((n_rows, k), bool)
    fix = native.far_tables(dims, periodic, offs, far_slots, far_rowidx,
                            row_of_pos0, owner0, 999, rows_t, mask_t)

    maps = _NeighborMaps(dims, periodic)
    want_rows = np.full((n_rows, k), 7, np.int32)
    want_mask = np.zeros((n_rows, k), bool)
    want_fix = []
    for j, o in enumerate(offs):
        ng, valid = maps.shift(o)
        ng, valid = ng[far_slots], valid[far_slots]
        r, f = _sentinel_rows(ng, owner0[far_slots], owner0, row_of_pos0,
                              999, valid)
        want_rows[far_rowidx, j] = r
        want_mask[far_rowidx, j] = valid
        want_fix.append(np.nonzero(f)[0] * k + j)
    np.testing.assert_array_equal(rows_t, want_rows)
    np.testing.assert_array_equal(mask_t, want_mask)
    want = np.sort(np.concatenate(want_fix))
    assert len(want) > 0
    # the fixup records are appended in thread order: compare as sets
    np.testing.assert_array_equal(np.sort(fix), want)
    # no owners: no sentinels and no fixups
    rows_1 = np.full((n_rows, k), 7, np.int32)
    assert len(native.far_tables(dims, periodic, offs, far_slots, far_rowidx,
                                 row_of_pos0, None, 999, rows_1, mask_t)) == 0
    assert int(rows_1.min()) >= 0


@pytest.mark.parametrize("n_own", [2, 3, 4])
def test_easy_tables_with_owners(engine, n_own):
    rng = np.random.default_rng(20 + n_own)
    n, m, kb, k = 300, 120, 9, 5
    ei = np.sort(rng.choice(m, 80, replace=False)).astype(np.int64)
    ridx = rng.choice(200, len(ei), replace=False).astype(np.int64)
    sel = rng.choice(kb, k, replace=False).astype(np.int64)
    pos_all = rng.integers(0, n, (kb, m)).astype(np.int32)
    valid_all = rng.random((kb, m)) < 0.8
    row_of_pos = rng.integers(0, 500, n).astype(np.int32)
    owner = rng.integers(0, n_own, n).astype(np.int32)
    edev = rng.integers(0, n_own, len(ei)).astype(np.int32)
    rows_t = np.full((200, k), 5, np.int32)
    mask_t = np.zeros((200, k), bool)
    fix = native.easy_tables(ei, ridx, sel, pos_all, valid_all, m, row_of_pos,
                             owner, edev, 777, rows_t, mask_t)

    want_rows = np.full((200, k), 5, np.int32)
    want_mask = np.zeros((200, k), bool)
    want_fix = []
    for j in range(k):
        p = pos_all[sel[j], ei].astype(np.int64)
        v = valid_all[sel[j], ei]
        r, f = _sentinel_rows(p, edev, owner, row_of_pos, 777, v)
        want_rows[ridx, j] = r
        want_mask[ridx, j] = v
        want_fix.append(np.nonzero(f)[0] * k + j)
    np.testing.assert_array_equal(rows_t, want_rows)
    np.testing.assert_array_equal(mask_t, want_mask)
    want = np.sort(np.concatenate(want_fix))
    assert len(want) > 0
    np.testing.assert_array_equal(np.sort(fix), want)


@pytest.mark.parametrize("n_own", [2, 3, 4])
def test_hard_tables_with_owners(engine, n_own):
    rng = np.random.default_rng(30 + n_own)
    n = 400
    src = np.sort(rng.choice(n, 60, replace=False))
    sizes = rng.integers(1, 12, len(src))
    s_p = np.repeat(src, sizes).astype(np.int64)
    nE = len(s_p)
    s_n = rng.integers(0, n, nE).astype(np.int64)
    s_off = rng.integers(-4, 5, (nE, 3)).astype(np.int64)
    owner = rng.integers(0, n_own, n).astype(np.int32)
    row_of_pos = rng.integers(0, 300, n).astype(np.int32)

    nG, s_need, counts = native.hard_counts(s_p, owner, n_own)
    g_dev = owner[src].astype(np.int64)
    assert (nG, s_need) == (len(src), int(sizes.max()))
    np.testing.assert_array_equal(counts, np.bincount(g_dev, minlength=n_own))

    Hmax, S, L, pad = int(counts.max()) + 2, int(sizes.max()) + 1, 300, 399
    rows_d = np.full((n_own, Hmax), -9, np.int32)
    nbr_d = np.full((n_own, Hmax, S), -9, np.int32)
    offs_d = np.full((n_own, Hmax, S, 3), -9, np.int32)
    mask_d = np.ones((n_own, Hmax, S), bool)
    fix = native.hard_fill(s_p, s_n, s_off, owner, row_of_pos, n_own, Hmax, S,
                           L, pad, rows_d, nbr_d, offs_d, mask_d)

    # NumPy: groups in stream order, dense per-partition positions
    want_rows = np.full((n_own, Hmax), L, np.int32)
    want_nbr = np.full((n_own, Hmax, S), pad, np.int32)
    want_offs = np.zeros((n_own, Hmax, S, 3), np.int32)
    want_mask = np.zeros((n_own, Hmax, S), bool)
    starts = np.r_[0, np.cumsum(sizes)[:-1]]
    dense = np.zeros(len(src), np.int64)
    for d in range(n_own):
        dense[g_dev == d] = np.arange(int((g_dev == d).sum()))
    grp = np.repeat(np.arange(len(src)), sizes)
    slot = np.arange(nE) - starts[grp]
    e_dev, e_pos = g_dev[grp], dense[grp]
    want_rows[g_dev, dense] = row_of_pos[src]
    r, f = _sentinel_rows(s_n, e_dev, owner, row_of_pos, pad,
                          np.ones(nE, bool))
    want_nbr[e_dev, e_pos, slot] = r
    want_offs[e_dev, e_pos, slot] = s_off
    want_mask[e_dev, e_pos, slot] = True
    for got, want in ((rows_d, want_rows), (nbr_d, want_nbr),
                      (offs_d, want_offs), (mask_d, want_mask)):
        np.testing.assert_array_equal(got, want)
    flat_at = (e_dev * Hmax + e_pos) * S + slot
    want_fix = np.sort(flat_at[f])
    assert len(want_fix) > 0
    np.testing.assert_array_equal(np.sort(fix), want_fix)


# ---------------------------------------------------------------------
# plans

def make_pair(length=(6, 5, 4), periodic=(False, True, False), hood_len=1,
              n_dev=4, max_ref=2, partition="block", user_hood=None,
              refine=(1, 2, 3), unrefine=()):
    """tests/test_hybrid.py's ``make_grid`` on both packages."""
    out = []
    for cls, dev, dt in ((RefGrid, mesh_of(n_dev), jnp.float32),
                         (Grid, ["cpu"] * n_dev, torch.float32)):
        g = (cls(cell_data={"v": dt})
             .set_initial_length(length).set_periodic(*periodic)
             .set_maximum_refinement_level(max_ref)
             .set_neighborhood_length(hood_len)
             .initialize(dev, partition=partition))
        if user_hood is not None:
            g.add_neighborhood(42, user_hood)
        for c in refine:
            g.refine_completely(c)
        g.stop_refining()
        for c in unrefine:
            g.unrefine_completely(c)
        if unrefine:
            g.stop_refining()
        out.append(g)
    return tuple(out)


# tests/test_hybrid.py's CONFIGS (their n_dev and partition set below)
HYBRID_CONFIGS = [
    dict(),
    dict(periodic=(True, True, True), length=(4, 4, 4), refine=(1, 64)),
    dict(hood_len=0),
    dict(hood_len=2, length=(5, 5, 5), refine=(1, 62)),
    dict(refine=(1, 2, 9, 17)),
    dict(user_hood=[[1, 0, 0], [0, -1, 0], [1, 1, 1]]),
    dict(refine=(1,)),
    dict(length=(4, 4, 2), refine=(1, 2, 5), unrefine=(33,)),
]


# every configuration on every count; block and morton alternate, so
# each configuration and each count meets both partitioners
HYBRID_CASES = [(i, n, ("block", "morton")[(i + j) % 2])
                for i in range(len(HYBRID_CONFIGS))
                for j, n in enumerate(COUNTS)]


@pytest.mark.parametrize("i,n,partition", HYBRID_CASES,
                         ids=[f"c{i}-{n}-{p}" for i, n, p in HYBRID_CASES])
def test_hybrid_plan_matches_reference(i, n, partition):
    r, p = make_pair(n_dev=n, partition=partition, **HYBRID_CONFIGS[i])
    assert p.plan.hoods[-0xDCC].hard_nbr_rows is not None
    assert_plans_equal(r, p, lists=False)
    assert p._cap_memo == {k: v for k, v in r._cap_memo.items()
                           if k != "removed"}


@pytest.mark.parametrize("n", COUNTS)
@pytest.mark.parametrize("kw", HYBRID_CONFIGS[:4] + HYBRID_CONFIGS[7:],
                         ids=["c0", "c1", "c2", "c3", "c7"])
def test_generic_plan_matches_reference(monkeypatch, kw, n):
    """``DCCRG_FORCE_GENERIC=1``: the generic builder on partitions (its
    ghost ids from every hood's of- and to-lists, ``row_by_gidx`` per
    partition), bit for bit, the neighbor lists too."""
    monkeypatch.setenv("DCCRG_FORCE_GENERIC", "1")
    r, p = make_pair(n_dev=n, partition="morton" if n % 2 else "block", **kw)
    assert p.plan.hoods[-0xDCC].hard_nbr_rows is None
    assert_plans_equal(r, p)


@pytest.mark.parametrize("n", COUNTS)
def test_hybrid_equals_generic_content(monkeypatch, n):
    """tests/test_hybrid.py:test_hybrid_matches_generic on the port
    alone: the hybrid and the generic builders give the same layout,
    ghost sets, pair tables and per-cell entry sets."""
    kw = dict(length=(6, 6, 6), refine=(1, 2, 3, 8, 9, 43, 44))
    _r, hyb = make_pair(n_dev=n, **kw)
    monkeypatch.setenv("DCCRG_FORCE_GENERIC", "1")
    _r, gen = make_pair(n_dev=n, **kw)
    hp, gp = hyb.plan, gen.plan
    assert (hp.L, hp.R) == (gp.L, gp.R)
    for d in range(n):
        np.testing.assert_array_equal(hp.local_ids[d], gp.local_ids[d])
        np.testing.assert_array_equal(hp.ghost_ids[d], gp.ghost_ids[d])
    hh, hg = hp.hoods[-0xDCC], gp.hoods[-0xDCC]
    np.testing.assert_array_equal(hh.n_inner, hg.n_inner)
    np.testing.assert_array_equal(hh.send_rows, hg.send_rows)
    np.testing.assert_array_equal(hh.recv_rows, hg.recv_rows)

    def entries(plan, rows, offs, mask):
        out = {}
        for d in range(n):
            ids = np.concatenate([plan.local_ids[d], plan.ghost_ids[d]])
            nl = len(plan.local_ids[d])
            for r, cid in enumerate(plan.local_ids[d]):
                e = []
                for s in np.nonzero(mask[d, r])[0]:
                    row = rows[d, r, s]
                    nid = ids[row] if row < plan.L else ids[nl + row - plan.L]
                    e.append((int(nid), tuple(int(x) for x in offs[d, r, s])))
                out[int(cid)] = sorted(e)
        return out

    assert (entries(hp, *hh.merged_of_tables(hp.R - 1))
            == entries(gp, hg.nbr_rows, hg.nbr_offs, hg.nbr_mask))
    assert (entries(hp, hh.to_rows, hh.to_offs, hh.to_mask)
            == entries(gp, hg.to_rows, hg.to_offs, hg.to_mask))


def adapt_sequence(g):
    """tests/test_recommit.py's refine -> recommit -> unrefine."""
    for c in (1, 2, 3):
        g.refine_completely(c)
    yield g.stop_refining()
    for c in g.plan.cells[:6]:
        g.refine_completely(int(c))
    yield g.stop_refining()
    lvl = g.mapping.get_refinement_level(g.plan.cells)
    deepest = g.plan.cells[lvl == lvl.max()]
    g.unrefine_completely(int(deepest[0]))
    yield g.stop_refining()


# tests/test_recommit.py's CONFIGS
RECOMMIT_CONFIGS = [
    dict(),
    dict(periodic=(True, True, True), length=(4, 4, 4)),
    dict(length=(5, 4, 4)),
    dict(length=(4, 4, 2), max_ref=3),
]


@pytest.mark.parametrize("n", COUNTS)
@pytest.mark.parametrize("kw", RECOMMIT_CONFIGS,
                         ids=[f"c{i}" for i in range(len(RECOMMIT_CONFIGS))])
def test_recommit_sequence_both_engines(engine, kw, n):
    """Each commit of the refine / recommit (stream reuse) / unrefine
    sequence: the port's plan with the native engine and with the NumPy
    engine equals the reference's, bit for bit."""
    args = dict(length=(6, 5, 4), periodic=(False, True, False), max_ref=2)
    args.update(kw)
    grids = []
    for engine in (True, False):
        with native.engine(engine):
            grids.append(
                (Grid(cell_data={"v": torch.float32})
                 .set_initial_length(args["length"])
                 .set_periodic(*args["periodic"])
                 .set_maximum_refinement_level(args["max_ref"])
                 .initialize(["cpu"] * n,
                             partition="morton" if n == 3 else "block")))
    ref = (RefGrid(cell_data={"v": jnp.float32})
           .set_initial_length(args["length"]).set_periodic(*args["periodic"])
           .set_maximum_refinement_level(args["max_ref"])
           .initialize(mesh_of(n), partition="morton" if n == 3 else "block"))
    seqs = [adapt_sequence(g) for g in grids]
    for created in adapt_sequence(ref):
        for engine, (g, seq) in zip((True, False), zip(grids, seqs)):
            with native.engine(engine):
                np.testing.assert_array_equal(next(seq), created)
            assert_plans_equal(ref, g, lists=False)
