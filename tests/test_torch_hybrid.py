"""The port's refined-grid plans and table gather path against the
reference.

The counterpart of tests/test_hybrid.py for ``dccrg_tpu_torch``, on one
device: after the same refine sequence, the hybrid plan, the generic
plan (``DCCRG_FORCE_GENERIC=1``) and, on level-0 grids, the dense-table
plan (``DCCRG_FORCE_TABLES=1``) equal the reference's bit for bit —
layout, every hood's dense, hard, to- and pair tables. Stencils and
step loops over refined plans (plain kernels, ``SlotwiseKernel``s,
``include_to``, extra args) match the reference's values to float32
reassociation (the slot sums run in another order); on a level-0 grid
the port's forced-table path equals its own closed-form path bit for
bit.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import dccrg_tpu_torch as port
from dccrg_tpu_torch import hybrid as port_hybrid
from dccrg_tpu_torch.models.advection import GridAdvection

from torch_amr_fixture import assert_plans_equal, grid_pair

# the reference's hybrid configurations (tests/test_hybrid.py:78-87),
# one device
CONFIGS = [
    dict(),
    dict(periodic=(True, True, True), length=(4, 4, 4), refine=(1, 64)),
    dict(hood_len=0),
    dict(hood_len=2, length=(5, 5, 5), refine=(1, 62)),
    dict(refine=(1, 2, 9, 17)),
    dict(user_hood=[[1, 0, 0], [0, -1, 0], [1, 1, 1]]),
    dict(length=(4, 4, 2), refine=(1, 2, 5), unrefine=(33,)),
]

# field values after stencils: both sides do the same float32 ops, but
# the slot sums (up to 26 terms, more on hard rows) reassociate: a few
# float32 ulps of the field's peak magnitude per step
RTOL, ATOL = 1e-6, 1e-6


def _refined_pair(length=(6, 5, 4), periodic=(False, True, False), hood_len=1,
                  max_ref=2, user_hood=None, refine=(1, 2, 3), unrefine=()):
    pair = grid_pair(length, max_ref, hood_len, periodic, user_hood)
    for g in pair:
        for c in refine:
            g.refine_completely(c)
        g.stop_refining()
        for c in unrefine:
            g.unrefine_completely(c)
        if unrefine:
            g.stop_refining()
    return pair


@pytest.mark.parametrize("generic", [False, True], ids=["hybrid", "generic"])
@pytest.mark.parametrize("kw", CONFIGS)
def test_refined_plans_match_reference(monkeypatch, kw, generic):
    if generic:
        monkeypatch.setenv("DCCRG_FORCE_GENERIC", "1")
    pair = _refined_pair(**kw)
    assert_plans_equal(*pair)
    hood = pair[1].plan.hoods[port.DEFAULT_NEIGHBORHOOD_ID]
    assert (hood.hard_nbr_rows is None) == generic


def test_deep_refinement_and_stream_reuse(monkeypatch):
    """Two levels of refinement (easy level-1 cells inside the block,
    hard shells at both transitions), then recommits whose hard streams
    come from the reuse cache: equal to the reference after each, and
    to a fresh (cache-less) build."""
    pair = _refined_pair(length=(6, 6, 6), refine=(1, 2, 3, 8, 9, 43, 44))
    for step in range(3):
        for g in pair:
            lvl = g.mapping.get_refinement_level(g.plan.cells)
            if step == 1:
                for c in g.plan.cells[lvl == 2][:8]:
                    g.unrefine_completely(c)
            else:
                for c in g.plan.cells[lvl == 1][step * 8:step * 8 + 8]:
                    g.refine_completely(c)
            g.stop_refining()
        assert_plans_equal(*pair, lists=False)
    p = pair[1]
    fresh = port.Grid(cell_data={"v": torch.float32}) \
        .set_initial_length((6, 6, 6)).set_periodic(False, True, False) \
        .set_maximum_refinement_level(2).set_neighborhood_length(1) \
        .initialize("cpu")
    fresh._cap_memo = dict(p._cap_memo)
    fresh.load_cells(p.plan.cells)
    a, b = p.plan.hoods[port.DEFAULT_NEIGHBORHOOD_ID], \
        fresh.plan.hoods[port.DEFAULT_NEIGHBORHOOD_ID]
    for name in ("nbr_rows", "nbr_mask", "hard_rows", "hard_nbr_rows",
                 "hard_offs", "hard_mask", "scale_rows"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


@pytest.mark.parametrize("hood_len", [0, 1, 2])
@pytest.mark.parametrize("periodic", [(True, True, True), (False, True, False)])
def test_forced_tables_match_reference(monkeypatch, periodic, hood_len):
    """DCCRG_FORCE_TABLES=1 on a level-0 grid: the dense-table plan
    (rows, mask, offsets, to-tables) equals the reference's."""
    monkeypatch.setenv("DCCRG_FORCE_TABLES", "1")
    pair = grid_pair((5, 4, 3), 1, hood_len, periodic,
                     user_hood=[[1, 0, 0], [0, 0, -1]])
    assert pair[1].plan.hoods[port.DEFAULT_NEIGHBORHOOD_ID].closed_form is None
    assert_plans_equal(*pair)


def test_closed_form_to_tables_match_reference():
    """The closed-form plan's lazy to-tables equal the reference's."""
    assert_plans_equal(*grid_pair((4, 3, 5), 0, 1, (True, False, True)))


def _seed(pair, seed):
    rng = np.random.default_rng(seed)
    cells = pair[0].get_cells()
    vals = rng.random(len(cells)).astype(np.float32)
    for g in pair:
        g.set("v", cells, vals)
    return cells


def _diffuse(xp):
    where, total = (jnp.where, jnp.sum) if xp == "jax" else (torch.where, torch.sum)
    axis = "axis" if xp == "jax" else "dim"

    def kernel(cell, nbr, offs, mask, *extra):
        s = total(where(mask, nbr["v"] - cell["v"][:, None], 0.0), **{axis: 1})
        # offsets reach the result, so a wrong offset table shows
        o = total(where(mask, offs[..., 0] + 2 * offs[..., 1] - offs[..., 2],
                        0), **{axis: 1})
        scale = extra[0] if extra else 0.01
        return {"v": cell["v"] + scale * s + 1e-3 * o}

    return kernel


def _slotwise(xp):
    where = jnp.where if xp == "jax" else torch.where
    if xp == "jax":
        from dccrg_tpu.grid import SlotwiseKernel
    else:
        SlotwiseKernel = port.SlotwiseKernel

    def init(cell, *extra):
        return cell["v"] * 0

    def slot(acc, cell, nbr_j, offs_j, mask_j, *extra):
        ox = offs_j[..., 0] if offs_j.ndim == 2 else offs_j[0]
        return acc + where(mask_j, nbr_j["v"] * (1 + 0.5 * ox), 0.0)

    def finish(acc, cell, *extra):
        return {"v": cell["v"] + 0.02 * acc}

    return SlotwiseKernel(init, slot, finish)


def _to_kernel(xp):
    where, total = (jnp.where, jnp.sum) if xp == "jax" else (torch.where, torch.sum)
    axis = "axis" if xp == "jax" else "dim"

    def kernel(cell, nbr, offs, mask, to_nbr, to_offs, to_mask, dt):
        of = total(where(mask, nbr["v"] * offs[..., 0], 0.0), **{axis: 1})
        to = total(where(to_mask, to_nbr["v"] * to_offs[..., 1], 0.0), **{axis: 1})
        return {"v": cell["v"] + dt * (of - to)}

    return kernel


def _check_values(pair, cells, what):
    r, p = pair
    want = r.get("v", cells)
    np.testing.assert_allclose(p.get("v", cells), want, rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


@pytest.mark.parametrize("generic", [False, True], ids=["hybrid", "generic"])
@pytest.mark.parametrize("kw", [CONFIGS[1], CONFIGS[2], CONFIGS[5]])
def test_stencils_on_refined_plans_match_reference(monkeypatch, kw, generic):
    """apply_stencil (plain kernel with extra args, SlotwiseKernel,
    include_to) and run_steps (plain, SlotwiseKernel) on a refined
    plan: the hard-row split (hybrid) or the explicit-offset tables
    (generic), and include_to through the merged tables."""
    if generic:
        monkeypatch.setenv("DCCRG_FORCE_GENERIC", "1")
    pair = _refined_pair(**kw)
    cells = _seed(pair, 1)
    r, p = pair
    r.apply_stencil(_diffuse("jax"), ["v"], ["v"], extra_args=(jnp.float32(0.03),))
    p.apply_stencil(_diffuse("torch"), ["v"], ["v"], extra_args=(0.03,))
    _check_values(pair, cells, "plain + extra")
    if not generic:
        # the reference's generic plan has no offs_const for the
        # slot-wise contract's [3] offsets; its hybrid plan does
        r.apply_stencil(_slotwise("jax"), ["v"], ["v"])
        p.apply_stencil(_slotwise("torch"), ["v"], ["v"])
        _check_values(pair, cells, "slotwise")
    r.apply_stencil(_to_kernel("jax"), ["v"], ["v"], include_to=True,
                    extra_args=(jnp.float32(0.01),))
    p.apply_stencil(_to_kernel("torch"), ["v"], ["v"], include_to=True,
                    extra_args=(0.01,))
    _check_values(pair, cells, "include_to")
    r.run_steps(_diffuse("jax"), ["v"], ["v"], 4)
    p.run_steps(_diffuse("torch"), ["v"], ["v"], 4)
    assert p.last_step_path == "table"
    _check_values(pair, cells, "run_steps plain")
    if not generic:
        r.run_steps(_slotwise("jax"), ["v"], ["v"], 3)
        p.run_steps(_slotwise("torch"), ["v"], ["v"], 3)
        _check_values(pair, cells, "run_steps slotwise")


@pytest.mark.parametrize("periodic", [(True, True, False), (False, False, False)])
def test_forced_tables_equal_closed_form(monkeypatch, periodic):
    """On a level-0 grid the port's dense-table path runs the same
    float32 operations as its closed-form path: the advection main
    path's SlotwiseKernel (GridAdvection on the plain path) and a plain
    kernel with extra args on a 26-neighbour grid, bit for bit."""
    def run(force):
        if force:
            monkeypatch.setenv("DCCRG_FORCE_TABLES", "1")
        else:
            monkeypatch.delenv("DCCRG_FORCE_TABLES", raising=False)
        app = GridAdvection(n=12, nz=5, device="cpu", periodic=periodic)
        app.run(3, bulk=False)
        g = (port.Grid(cell_data={"v": torch.float32})
             .set_initial_length((7, 6, 5)).set_periodic(*periodic)
             .set_neighborhood_length(2).initialize("cpu"))
        cells = g.get_cells()
        g.set("v", cells, np.linspace(0, 1, len(cells), dtype=np.float32))
        g.apply_stencil(_diffuse("torch"), ["v"], ["v"], extra_args=(0.02,))
        g.run_steps(_diffuse("torch"), ["v"], ["v"], 2, bulk=False)
        return (app.grid.last_step_path, app.grid.data["density"].clone(),
                g.data["v"].clone())

    path_t, dens_t, v_t = run(True)
    path_c, dens_c, v_c = run(False)
    assert (path_t, path_c) == ("table", "roll")
    assert torch.equal(dens_t, dens_c)
    assert torch.equal(v_t, v_c)


def test_phase_sink_records_build_phases():
    """The hybrid build's phases land in _PHASE_SINK (chip_smoke.py's
    [amr] line reads them)."""
    r, p = grid_pair((4, 4, 4), 1)
    sink = []
    port_hybrid._PHASE_SINK = sink
    try:
        p.refine_completely(1)
        p.stop_refining()
    finally:
        port_hybrid._PHASE_SINK = None
    labels = [lab for lab, _dt in sink]
    assert labels[0].startswith("classify") and "row layout" in labels
    assert all(dt >= 0 for _lab, dt in sink)
    arena = p._plan_arena.stats()
    assert arena["misses"] > 0 and arena["owned_bytes"] > 0
