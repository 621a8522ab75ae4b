"""The port's AMR applications against the reference.

``AmrAdvection`` (stepwise and fused, with adapt epochs),
``GameOfLife`` on refined grids (tests/test_grid.py:295-333) and the AMR
``PoissonSolver`` cases of tests/test_poisson.py (``:135``
``test_amr_linear_exact``, ``:265`` ``test_fused_solve_matches_host_loop``),
each run by the reference on a one-device mesh and by the port on the
CPU from the same seeded state. The cell set after every adapt is
equal; field values agree to the float32 tolerances stated below (the
stencils' slot sums reassociate).
"""

import numpy as np
import pytest

from dccrg_tpu.models import poisson as ref_poisson
from dccrg_tpu.models.advection_amr import AmrAdvection as RefAmr
from dccrg_tpu.models.game_of_life import GameOfLife as RefLife

from dccrg_tpu_torch import convert
from dccrg_tpu_torch.models import poisson as port_poisson
from dccrg_tpu_torch.models.advection_amr import AmrAdvection
from dccrg_tpu_torch.models.game_of_life import GameOfLife

from torch_amr_fixture import mesh1

# density after steps: float32, the flux sums reassociate
RTOL, ATOL = 1e-5, 1e-7
# mass conservation across adapt epochs (tests/test_advection_amr.py:101)
MASS_REL = 1e-5


def _pair(length, max_lvl):
    return (RefAmr(length, max_refinement_level=max_lvl, mesh=mesh1()),
            AmrAdvection(length, max_refinement_level=max_lvl, device="cpu"))


def _assert_same_state(r, p):
    cr, cp = r.grid.get_cells(), p.grid.get_cells()
    np.testing.assert_array_equal(cp, cr)
    np.testing.assert_allclose(p.grid.get("density", cp),
                               r.grid.get("density", cr), rtol=RTOL, atol=ATOL)
    assert p.time == pytest.approx(r.time, rel=1e-12)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
def test_amr_advection_matches_reference(fused):
    """Three adapt epochs at (16, 16, 1), max level 2: after each adapt
    the same cells (created and removed), densities within tolerance,
    total mass conserved in both."""
    r, p = _pair((16, 16, 1), 2)
    m0 = (r.total_mass(), p.total_mass())
    assert m0[1] == pytest.approx(m0[0], rel=1e-12)
    for _ in range(3):
        r.run(4, adapt_n=4, fused=fused)
        p.run(4, adapt_n=4, fused=fused)
        _assert_same_state(r, p)
        assert p.total_mass() == pytest.approx(m0[1], rel=MASS_REL)
    lvl = p.grid.mapping.get_refinement_level(p.grid.get_cells())
    assert lvl.max() == 2  # the hump's edge reached the finest level


def test_adapt_and_max_time_step_match_reference():
    """One adapt's created/removed sets and the CFL limit per epoch."""
    r, p = _pair((8, 8, 1), 1)
    assert p.max_time_step() == r.max_time_step()
    cr, rr = r.adapt()
    cp, rp = p.adapt()
    np.testing.assert_array_equal(cp, cr)
    np.testing.assert_array_equal(rp, rr)
    assert p.max_time_step() == r.max_time_step()
    np.testing.assert_array_equal(p.grid.get("max_diff", p.grid.get_cells()),
                                  np.zeros(len(p.grid.get_cells()), np.float32))


def test_fused_matches_stepwise_and_balance():
    """run(fused=True) with adapt and balance events equals
    fused=False (tests/test_advection_amr.py:86); the one-device
    balance keeps cells and data."""
    a = AmrAdvection((8, 8, 1), max_refinement_level=1, device="cpu")
    b = AmrAdvection((8, 8, 1), max_refinement_level=1, device="cpu")
    a.run(6, adapt_n=3, balance_n=2, fused=False)
    b.run(6, adapt_n=3, balance_n=2, fused=True)
    ca, cb = a.grid.get_cells(), b.grid.get_cells()
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_allclose(a.grid.get("density", ca),
                               b.grid.get("density", cb), rtol=1e-5, atol=1e-6)
    before = b.grid.get("density", cb)
    epoch = b.grid.plan.epoch
    b.balance()
    assert b.grid.plan.epoch == epoch + 1
    np.testing.assert_array_equal(b.grid.get_cells(), cb)
    np.testing.assert_array_equal(b.grid.get("density", cb), before)


def _gol_id(x, y, nx=10):
    return np.uint64(1 + x + nx * y)


@pytest.mark.parametrize("refine", [
    [(9, 9), (8, 9), (9, 8)],     # far from the pattern
    [(5, 5), (6, 5)],             # next to it
])
def test_refined_game_of_life_matches_reference(refine):
    """The blinker on a refined grid (tests/test_grid.py:312-333):
    stepwise and through the step loop, live cells equal the
    reference's every generation."""
    vertical = [_gol_id(4, 3), _gol_id(4, 4), _gol_id(4, 5)]
    games = (RefLife(mesh=mesh1(), max_refinement_level=1),
             GameOfLife(device="cpu", max_refinement_level=1))
    for g in games:
        g.set_alive(vertical)
        g.refine([_gol_id(x, y) for x, y in refine])
    np.testing.assert_array_equal(games[1].grid.get_cells(),
                                  games[0].grid.get_cells())
    for turn in range(4):
        for g in games:
            g.step()
        np.testing.assert_array_equal(np.sort(games[1].alive_cells()),
                                      np.sort(games[0].alive_cells()))
    for g in games:
        g.run(3)
    np.testing.assert_array_equal(np.sort(games[1].alive_cells()),
                                  np.sort(games[0].alive_cells()))
    np.testing.assert_array_equal(
        games[1].grid.get("total", games[1].grid.get_cells()),
        games[0].grid.get("total", games[0].grid.get_cells()))


def test_amr_poisson_linear_exact():
    """tests/test_poisson.py:135: the coarse-fine face factors reproduce
    a linear solution; the port's geometry factors equal the
    reference's and its solution matches."""
    out = []
    for mod, kw in ((ref_poisson, dict(mesh=mesh1())),
                    (port_poisson, dict(device="cpu"))):
        s = mod.PoissonSolver((4, 1, 1), periodic=(False, False, False),
                              max_refinement_level=1, **kw)
        s.grid.refine_completely(2)
        s.grid.stop_refining()
        cells = s.grid.get_cells()
        x = s.grid.geometry.get_center(cells)[:, 0]
        exact = (2.0 * x - 1.0).astype(np.float32)
        edge = (x == x.min()) | (x == x.max())
        s.grid.set("solution", cells[edge], exact[edge])
        s.set_rhs(np.zeros(len(cells), dtype=np.float32))
        info = s.solve(rtol=1e-10, max_iterations=500,
                       cells_to_solve=cells[~edge])
        np.testing.assert_allclose(s.solution(), exact, rtol=1e-3, atol=2e-3,
                                   err_msg=str(info))
        out.append((s, info))
    (r, ir), (p, ip) = out
    for name in ("fxp", "fxn", "scale", "ctype", "ilen"):
        np.testing.assert_array_equal(p.grid.get(name, p.grid.get_cells()),
                                      r.grid.get(name, r.grid.get_cells()))
    assert ip["iterations"] == ir["iterations"]
    np.testing.assert_allclose(p.solution(), r.solution(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_amr_poisson_fused_and_host_loop(fused):
    """tests/test_poisson.py:265's refined problem: the port's solve,
    fused and host-driven, takes the reference's iterations and lands
    on its solution (to 1e-5 of the peak: the dots reduce in another
    order)."""
    def make(mod, **kw):
        s = mod.PoissonSolver(length=(8, 8, 4), periodic=(True, False, False),
                              max_refinement_level=1, **kw)
        g = s.grid
        g.refine_completely(1)
        g.stop_refining()
        cells = g.get_cells()
        centers = g.geometry.get_center(cells)
        rng = np.random.default_rng(0)
        s.set_rhs(np.sin(centers[:, 0]) + 0.1 * rng.random(len(cells)))
        return s, cells[centers[:, 1] > 1.5]

    (r, rs), (p, ps) = make(ref_poisson, mesh=mesh1()), make(port_poisson, device="cpu")
    ir = r.solve(rtol=1e-6, max_iterations=60, cells_to_solve=rs, fused=fused)
    ip = p.solve(rtol=1e-6, max_iterations=60, cells_to_solve=ps, fused=fused)
    assert ip["iterations"] == ir["iterations"] > 0
    xr = r.solution()
    np.testing.assert_allclose(p.solution() / np.abs(xr).max(),
                               xr / np.abs(xr).max(), rtol=0, atol=1e-5)


def test_fields_carried_by_cell_id():
    """convert.py moves a refined reference grid's fields into the port
    by cell id (through each side's own plan rows)."""
    r, p = _pair((8, 8, 1), 1)
    r.run(2, adapt_n=2)
    p.adapt()
    # the port grid has another cell set; load the reference's
    p.grid.load_cells(r.grid.get_cells())
    cells = r.grid.plan.cells
    arrays = {n: np.asarray(r.grid.data[n]) for n in ("density", "ilen")}
    by_id = convert.fields_to_cells(r.grid.plan.row_of_pos, arrays)
    convert.fields_from_cells(p.grid, cells, by_id)
    np.testing.assert_array_equal(p.grid.get("density", cells),
                                  r.grid.get("density", cells))
    np.testing.assert_array_equal(p.grid.get("ilen", cells),
                                  r.grid.get("ilen", cells))
    with pytest.raises(TypeError):
        convert.fields_from_cells(p.grid, cells,
                                  {"ilen": by_id["ilen"].astype(np.int64)})
    back = convert.fields_to_cells(p.grid.plan.row_of_pos,
                                   convert.fields_to_numpy(p.grid))
    np.testing.assert_array_equal(back["density"], by_id["density"])
