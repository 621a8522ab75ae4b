"""``AmrAdvection`` on n partitions: the port on ``["cpu"] * n`` against
the reference on a mesh of n virtual CPU devices and against the port
on one partition (tests/test_device_counts.py:67-73 and
tests/test_advection_amr.py:116-156 on the port). After every adapt the
cell sets are equal; the densities agree to rtol 1e-5, atol 1e-7 with
the reference (the flux's slot sums reassociate, ROADMAP section 3) and
to the reference's own device-count bound (rtol 1e-5, atol 1e-6)
across partition counts. The refined ``GameOfLife`` runs on partitions
too, its live cells equal to the reference's."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from dccrg_tpu.models.advection_amr import AmrAdvection as RefAmr
from dccrg_tpu.models.game_of_life import GameOfLife as RefLife

from dccrg_tpu_torch.models.advection_amr import AmrAdvection
from dccrg_tpu_torch.models.game_of_life import GameOfLife

RTOL, ATOL = 1e-5, 1e-7


def mesh_of(n):
    return Mesh(np.array(jax.devices()[:n]), ("dev",))


def _same_state(a, b, rtol=RTOL, atol=ATOL):
    ca, cb = a.grid.get_cells(), b.grid.get_cells()
    np.testing.assert_array_equal(cb, ca)
    np.testing.assert_allclose(b.grid.get("density", cb),
                               a.grid.get("density", ca), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", [1, 3, 5, 7])
def test_amr_advection_conserves_mass(n):
    app = AmrAdvection((8, 8, 1), max_refinement_level=1, device=["cpu"] * n)
    m0 = app.total_mass()
    app.run(6, adapt_n=3)
    assert abs(app.total_mass() - m0) < 1e-5 * max(m0, 1.0)
    assert app.grid.n_dev == n and app.grid.last_step_path == "table"


def test_matches_reference_on_partitions():
    """Three epochs of 4 fused steps and an adapt at (16, 16, 1), max
    level 2, on 8 partitions: cells (created and removed) equal after
    every adapt, the CFL limit equal, densities within tolerance, the
    mass the same."""
    r = RefAmr((16, 16, 1), max_refinement_level=2, mesh=mesh_of(8))
    p = AmrAdvection((16, 16, 1), max_refinement_level=2, device=["cpu"] * 8)
    np.testing.assert_array_equal(p.grid.plan.owner, r.grid.plan.owner)
    assert p.total_mass() == pytest.approx(r.total_mass(), rel=1e-12)
    for _ in range(3):
        assert p.max_time_step() == r.max_time_step()
        r.run_fused(4)
        p.run_fused(4)
        cr, rr = r.adapt()
        cp, rp = p.adapt()
        np.testing.assert_array_equal(cp, cr)
        np.testing.assert_array_equal(rp, rr)
        np.testing.assert_array_equal(p.grid.plan.owner, r.grid.plan.owner)
        _same_state(r, p)
        assert p.total_mass() == pytest.approx(r.total_mass(), rel=1e-6)
    lvl = p.grid.mapping.get_refinement_level(p.grid.get_cells())
    assert lvl.max() == 2


def test_full_loop_with_balance():
    """tests/test_advection_amr.py:116-125: solve, adapt every 2,
    balance every 4 on 4 partitions, against the reference's run."""
    r = RefAmr((8, 8, 1), max_refinement_level=1, mesh=mesh_of(4))
    p = AmrAdvection((8, 8, 1), max_refinement_level=1, device=["cpu"] * 4)
    m0 = p.total_mass()
    r.run(8, adapt_n=2, balance_n=4)
    p.run(8, adapt_n=2, balance_n=4)
    np.testing.assert_array_equal(p.grid.plan.owner, r.grid.plan.owner)
    _same_state(r, p)
    assert p.total_mass() == pytest.approx(m0, rel=1e-4)
    rho = p.grid.get("density", p.grid.get_cells())
    assert rho.min() >= -1e-5 and rho.max() <= 0.55


def test_one_against_eight_partitions():
    """tests/test_advection_amr.py:142-156 on the port: stepwise and
    fused with adapts and a balance, one partition against eight."""
    out = []
    for n in (1, 8):
        app = AmrAdvection((8, 8, 1), max_refinement_level=1,
                           device=["cpu"] * n)
        dt = 0.4 * app.max_time_step()
        cells = []
        for i in range(4):
            app.step(dt)
            if i % 2 == 1:
                app.adapt()
                cells.append(app.grid.get_cells())
        app.run(6, adapt_n=3, balance_n=6)
        cells.append(app.grid.get_cells())
        out.append((cells, app))
    for a, b in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(b, a)
    _same_state(out[0][1], out[1][1], rtol=1e-5, atol=1e-6)
    assert out[1][1].max_time_step() == out[0][1].max_time_step()


def test_long_loop_deep_refinement():
    """tests/test_advection_amr.py:128-139 on 8 partitions: repeated
    adapts and balances keep the 2:1 structure and the mass."""
    app = AmrAdvection((12, 12, 1), max_refinement_level=2,
                       device=["cpu"] * 8)
    m0 = app.total_mass()
    app.run(12, adapt_n=3, balance_n=6)
    assert app.total_mass() == pytest.approx(m0, rel=1e-4)
    lvl = app.grid.mapping.get_refinement_level(app.grid.get_cells())
    assert lvl.max() == 2


def _gol_id(x, y, nx=10):
    return np.uint64(1 + x + nx * y)


@pytest.mark.parametrize("n,partition", [(3, "block"), (4, "morton")])
def test_refined_game_of_life_on_partitions(n, partition):
    """tests/test_grid.py:312-333's blinker on a refined grid, on n
    partitions: live cells equal the reference's every generation,
    stepwise and through the step loop."""
    vertical = [_gol_id(4, 3), _gol_id(4, 4), _gol_id(4, 5)]
    games = (RefLife(mesh=mesh_of(n), partition=partition,
                     max_refinement_level=1),
             GameOfLife(device=["cpu"] * n, partition=partition,
                        max_refinement_level=1))
    for g in games:
        g.set_alive(vertical)
        g.refine([_gol_id(5, 5), _gol_id(6, 5), _gol_id(9, 9)])
    np.testing.assert_array_equal(games[1].grid.plan.owner,
                                  games[0].grid.plan.owner)
    for _turn in range(3):
        for g in games:
            g.step()
        np.testing.assert_array_equal(np.sort(games[1].alive_cells()),
                                      np.sort(games[0].alive_cells()))
    for g in games:
        g.run(3)
    np.testing.assert_array_equal(np.sort(games[1].alive_cells()),
                                  np.sort(games[0].alive_cells()))
