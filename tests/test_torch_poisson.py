"""The port's general-grid PoissonSolver against the reference.

The cases of tests/test_poisson.py that need no AMR, each run by both
packages on one device with the same seeded numpy rhs: the reference's
own assertion holds for the port, and the port's solution and iteration
count match the reference's. After ``prepare`` the geometry factors,
the cell types and the index lengths are bit for bit the reference's;
one forward and one transpose matvec (``_apply``) agree to rtol 1e-6.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dccrg_tpu.dense import dense_mesh
from dccrg_tpu.grid import Grid as RefGrid
from dccrg_tpu.models import poisson as ref

import torch

from dccrg_tpu_torch import Grid
from dccrg_tpu_torch.models import poisson as port

FACTORS = ("fxp", "fxn", "fyp", "fyn", "fzp", "fzn", "scale", "ctype", "ilen")


def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("dev",))


def rel_error(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _pair(length, periodic=(True, True, True), jdtype=jnp.float32,
          tdtype=torch.float32):
    return (ref.PoissonSolver(length, mesh=mesh1(), periodic=periodic, dtype=jdtype),
            port.PoissonSolver(length, device="cpu", periodic=periodic, dtype=tdtype))


def _solve_both(pair, rhs, cells_to_solve=None, cells_to_skip=None,
                setup=None, **kw):
    """Same rhs (and Dirichlet data) into both solvers, both solved;
    returns their infos and solutions."""
    out = []
    for s in pair:
        if setup is not None:
            setup(s)
        s.set_rhs(rhs)
        info = s.solve(cells_to_solve=cells_to_solve, cells_to_skip=cells_to_skip,
                       **kw)
        out.append((info, np.asarray(s.solution(), np.float64)))
    return out


def _assert_factors_equal(pair):
    r, p = pair
    for name in FACTORS:
        a = np.asarray(r.grid.data[name])
        b = p.grid.data[name].numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def _assert_same_solve(res, atol, same_iterations=True):
    """Equal iteration counts and solutions within ``atol`` of the
    reference solution's largest magnitude: both run the same
    operations, only the reductions' summation order differs."""
    (ir, xr), (ip, xp) = res
    if same_iterations:
        assert ip["iterations"] == ir["iterations"], (ip, ir)
    denom = max(np.abs(xr).max(), 1e-30)
    np.testing.assert_allclose(xp / denom, xr / denom, rtol=0, atol=atol)


@pytest.mark.parametrize("fused", [True, False])
def test_1d_periodic_analytic(fused):
    """tests/test_poisson.py:24 on one device."""
    n = 32
    pair = _pair((n, 1, 1), periodic=(True, False, False))
    cells = pair[1].grid.get_cells()
    x = pair[1].grid.geometry.get_center(cells)[:, 0] / n
    u = np.sin(2 * np.pi * x)
    lam = -(2 - 2 * np.cos(2 * np.pi / n))
    res = _solve_both(pair, (lam * u).astype(np.float32), rtol=1e-6,
                      max_iterations=500, fused=fused)
    _assert_factors_equal(pair)
    _assert_same_solve(res, 1e-5)
    got = res[1][1] - res[1][1].mean()
    assert rel_error(got, u - u.mean()) < 1e-3


def test_2d_serial():
    """tests/test_poisson.py:41, its single-device (serial) solve."""
    n = 8
    rng = np.random.default_rng(3)
    rhs = rng.standard_normal(n * n).astype(np.float32)
    rhs -= rhs.mean()
    pair = _pair((n, n, 1), periodic=(True, True, False))
    res = _solve_both(pair, rhs, rtol=1e-6, max_iterations=1000)
    _assert_same_solve(res, 1e-5)


def test_residual_actually_small():
    """tests/test_poisson.py:58: recompute A x through ``_apply``."""
    n = 8
    rng = np.random.default_rng(0)
    rhs = rng.standard_normal(n ** 3).astype(np.float32)
    pair = _pair((n, n, n))
    res = _solve_both(pair, rhs, rtol=1e-5, max_iterations=2000)
    _assert_same_solve(res, 1e-5)
    s = pair[1]
    g = s.grid
    g.data["p0"] = g.data["solution"]
    s._exchange_p(["p0"])
    s._apply(transpose=False)
    Ax = g.get("Ap0", g.get_cells())
    want = rhs - rhs.mean()
    assert np.linalg.norm(Ax - want) / np.linalg.norm(want) < 1e-3


def _dirichlet_setup(s):
    cells = s.grid.get_cells()
    x = s.grid.geometry.get_center(cells)[:, 0]
    boundary = cells[(x < 1) | (x > len(cells) - 1)]
    s.grid.set("solution", boundary,
               (3 * s.grid.geometry.get_center(boundary)[:, 0] + 1).astype(np.float32))


@pytest.mark.parametrize("fused", [True, False])
def test_dirichlet_boundary_cells(fused):
    """tests/test_poisson.py:76: boundary cells hold Dirichlet data; the
    factor scheme is exact for a linear solution."""
    n = 8
    pair = _pair((n, 1, 1), periodic=(False, False, False))
    cells = pair[1].grid.get_cells()
    x = pair[1].grid.geometry.get_center(cells)[:, 0]
    interior = cells[(x > 1) & (x < n - 1)]
    res = _solve_both(pair, np.zeros(n, np.float32), cells_to_solve=interior,
                      setup=_dirichlet_setup, rtol=1e-8, max_iterations=500,
                      fused=fused)
    _assert_factors_equal(pair)
    _assert_same_solve(res, 1e-6)
    np.testing.assert_allclose(res[1][1], 3 * x + 1, rtol=1e-4, atol=1e-3)


def test_skip_cells_decouple():
    """tests/test_poisson.py:96: a skipped cell keeps its data and
    decouples the two halves."""
    n = 9
    pair = _pair((n, 1, 1), periodic=(False, False, False))
    cells = pair[1].grid.get_cells()
    x = pair[1].grid.geometry.get_center(cells)[:, 0]
    mid = cells[n // 2]
    rng = np.random.default_rng(5)
    rhs = rng.standard_normal(n).astype(np.float32)
    half_l, half_r = x < x[n // 2], x > x[n // 2]
    rhs[half_l] -= rhs[half_l].mean()
    rhs[half_r] -= rhs[half_r].mean()

    def setup(s):
        s.grid.set("solution", np.array([mid]), np.array([123.0], np.float32))

    solve = cells[cells != mid]
    res = _solve_both(pair, rhs, cells_to_solve=solve, cells_to_skip=[mid],
                      setup=setup, rtol=1e-6, max_iterations=500)
    _assert_factors_equal(pair)
    _assert_same_solve(res, 1e-5)
    s = pair[1]
    assert float(s.grid.get("solution", np.uint64(mid))) == 123.0
    g = s.grid
    g.data["p0"] = g.data["solution"]
    s._exchange_p(["p0"])
    s._apply(transpose=False)
    r = g.get("Ap0", solve) - rhs[cells != mid]
    left = g.geometry.get_center(solve)[:, 0] < x[n // 2]
    for m in (left, ~left):
        r[m] -= r[m].mean()
    assert np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-3


def test_stretched_linear_exact():
    """tests/test_poisson.py:155: stretched geometry feeds the factors
    through get_length (closed-form level-0 plan in the port too)."""
    coords = [[0.0, 0.5, 1.5, 3.0, 5.0, 7.5], [0.0, 1.0], [0.0, 1.0]]
    jg = (RefGrid(cell_data=dict(ref.POISSON_FIELDS)).set_initial_length((5, 1, 1))
          .set_neighborhood_length(1).set_geometry("stretched", coordinates=coords)
          .initialize(mesh1()))
    tg = (Grid(cell_data=dict(port.POISSON_FIELDS)).set_initial_length((5, 1, 1))
          .set_neighborhood_length(1).set_geometry("stretched", coordinates=coords)
          .initialize("cpu"))
    pair = (ref.PoissonSolver(grid=jg), port.PoissonSolver(grid=tg))
    cells = tg.get_cells()
    x = tg.geometry.get_center(cells)[:, 0]
    exact = (0.5 * x + 2.0).astype(np.float32)
    ends = (x == x.min()) | (x == x.max())

    def setup(s):
        s.grid.set("solution", cells[ends], exact[ends])

    res = _solve_both(pair, np.zeros(5, np.float32), cells_to_solve=cells[~ends],
                      setup=setup, rtol=1e-10, max_iterations=200)
    _assert_factors_equal(pair)
    _assert_same_solve(res, 1e-6)
    np.testing.assert_allclose(res[1][1], exact, rtol=1e-4, atol=1e-3)


def test_dense_poisson_3d():
    """tests/test_poisson.py:181 on a one-device dense grid. The rhs is
    a discrete eigenvector, so CG reaches float32's rounding floor in
    its first iterations and the stopping test then compares rounding
    noise against rtol: the iteration counts of the two packages differ
    (2 and 6 here), and the solutions agree to 1e-4 of their peak."""
    n = 32
    x = (np.arange(n) + 0.5) / n
    u = (np.sin(2 * np.pi * x)[:, None, None] * np.sin(2 * np.pi * x)[None, :, None]
         * np.ones((1, 1, n)))
    rhs = (-2 * (2 * np.pi) ** 2 * u).astype(np.float32)
    xr, ir = ref.DensePoissonSolver(
        (n, n, n), mesh=dense_mesh(jax.devices()[:1], (1, 1, 1))).solve(
        jnp.asarray(rhs), rtol=1e-6, max_iterations=800)
    xp, ip = port.DensePoissonSolver((n, n, n), device="cpu").solve(
        rhs, rtol=1e-6, max_iterations=800)
    _assert_same_solve(((ir, np.asarray(xr, np.float64)),
                        (ip, xp.numpy().astype(np.float64))), 1e-4,
                       same_iterations=False)
    got = xp.numpy().astype(np.float64)
    got -= got.mean()
    assert rel_error(got, u - u.mean()) < 0.02


def test_dense_matches_general_small():
    """tests/test_poisson.py:200: the port's dense and general solvers
    agree on the same problem (rhs scaled by dx^2 for the unit-cell
    general grid)."""
    n = 8
    rng = np.random.default_rng(1)
    rhs3 = rng.standard_normal((n, n, n)).astype(np.float32)
    rhs3 -= rhs3.mean()
    dense_sol, _ = port.DensePoissonSolver((n, n, n), device="cpu").solve(
        rhs3, rtol=1e-6, max_iterations=2000)
    s = port.PoissonSolver((n, n, n), device="cpu")
    cells = s.grid.get_cells()
    idx = s.grid.mapping.get_indices(cells).astype(np.int64)
    s.set_rhs(rhs3[idx[:, 0], idx[:, 1], idx[:, 2]] * np.float32((1.0 / n) ** 2))
    s.solve(rtol=1e-6, max_iterations=2000)
    gen = s.solution()
    dense_at = dense_sol.numpy()[idx[:, 0], idx[:, 1], idx[:, 2]]
    gen -= gen.mean()
    dense_at -= dense_at.mean()
    assert rel_error(gen, dense_at) < 1e-3


def test_f64_parity_mode():
    """tests/test_poisson.py:227: float64 resolves the discrete solution
    to near machine precision, float32 to its rounding floor; the port's
    float64 solution equals the reference's to 1e-12."""

    def run(pkg, jdt, tdt):
        if pkg is ref:
            s = ref.PoissonSolver(length=(16, 16, 1), mesh=mesh1(), dtype=jdt)
        else:
            s = port.PoissonSolver(length=(16, 16, 1), device="cpu", dtype=tdt)
        cells = s.grid.get_cells()
        c = s.grid.geometry.get_center(cells)
        rhs = np.sin(2 * np.pi * c[:, 0] / 16) * np.sin(2 * np.pi * c[:, 1] / 16)
        s.set_rhs(rhs)
        info = s.solve(rtol=1e-12, max_iterations=400)
        sol = s.grid.get("solution", cells).astype(np.float64)
        lam = 2 * (np.cos(2 * np.pi / 16) - 1) * 2
        exact = rhs / lam
        sol -= sol.mean()
        exact -= exact.mean()
        return float(np.abs(sol - exact).max() / np.abs(exact).max()), sol, info

    err64, sol64, info64 = run(port, None, torch.float64)
    err32, _, _ = run(port, None, torch.float32)
    assert err64 < 1e-9, err64
    assert err64 < err32 < 1e-4, (err64, err32)
    _, ref64, rinfo64 = run(ref, jnp.float64, None)
    assert info64["iterations"] == rinfo64["iterations"]
    np.testing.assert_allclose(sol64, ref64, rtol=0, atol=1e-12)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("periodic", [(True, True, True), (False, True, False)])
def test_apply_matches_reference(periodic, transpose):
    """One forward (Ap0) or transpose (r1) matvec through apply_stencil
    on seeded p0/p1, with Dirichlet and skipped cells, against the
    reference to rtol 1e-6; rows past the cells keep their values."""
    dims = (6, 5, 4)
    pair = _pair(dims, periodic=periodic)
    n = int(np.prod(dims))
    rng = np.random.default_rng(11)
    cells = pair[1].grid.get_cells()
    solve, skip = cells[rng.random(n) < 0.8], cells[rng.random(n) < 0.1]
    p = rng.standard_normal(n).astype(np.float32)
    outs = []
    for s in pair:
        s.prepare(cells_to_solve=solve, cells_to_skip=skip)
        s.grid.set("p1" if transpose else "p0", cells, p)
        s._apply(transpose=transpose)
        outs.append(np.asarray(s.grid.data["r1" if transpose else "Ap0"]))
    _assert_factors_equal(pair)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-6)
    assert np.abs(outs[1]).max() > 0


def test_fused_matches_host_loop():
    """The fused solve (device scalars, one flag read per iteration)
    walks the same trajectory as the host loop: a uniform non-periodic
    grid with Dirichlet cells takes the same number of iterations, with
    the reference's tolerances for the residual and the solution
    (tests/test_poisson.py:292-297)."""

    def make():
        s = port.PoissonSolver(length=(8, 8, 4), device="cpu",
                               periodic=(True, False, False))
        cells = s.grid.get_cells()
        centers = s.grid.geometry.get_center(cells)
        rng = np.random.default_rng(0)
        s.set_rhs(np.sin(centers[:, 0]) + 0.1 * rng.random(len(cells)))
        return s, cells[centers[:, 1] > 1.5]

    s1, solve1 = make()
    out1 = s1.solve(rtol=1e-6, max_iterations=60, cells_to_solve=solve1, fused=True)
    s2, solve2 = make()
    out2 = s2.solve(rtol=1e-6, max_iterations=60, cells_to_solve=solve2, fused=False)
    assert out1["iterations"] == out2["iterations"] > 0
    np.testing.assert_allclose(out1["residual"], out2["residual"], rtol=5e-2, atol=1e-10)
    np.testing.assert_allclose(s1.solution(), s2.solution(), rtol=5e-4, atol=5e-6)


def test_grid_surface():
    """get_cells, add_neighborhood, the lazy neighbor lists, the one-device
    exchange no-op and int32 fields through get/set."""
    s = port.PoissonSolver((4, 3, 2), device="cpu")
    g = s.grid
    cells = g.get_cells()
    np.testing.assert_array_equal(cells, np.arange(1, 25, dtype=np.uint64))
    epoch = g.plan.epoch
    assert not g.add_neighborhood(port.POISSON_NEIGHBORHOOD_ID, [[1, 0, 0]])
    assert g.add_neighborhood(7, [[1, 0, 0], [0, 0, -1]])
    assert g.plan.epoch == epoch + 1
    with pytest.raises(ValueError):
        g.add_neighborhood(8, [[2, 0, 0]])
    nl = g.plan.hoods[7].lists
    assert len(nl.of_source) == 48 and nl.of_item.max() == 1
    g.update_copies_of_remote_neighbors(neighborhood_id=7, fields=["ctype"])
    with pytest.raises(KeyError):
        g.update_copies_of_remote_neighbors(fields=["nope"])
    g.set("ctype", cells[:3], np.array([1, -1, 0], np.int32))
    got = g.get("ctype", cells[:3])
    assert got.dtype == np.int32 and got.tolist() == [1, -1, 0]
    # extra args and the neighbors_to triple reach the kernel (the
    # closed-form plan's to-tables materialize for include_to)
    g.set("p0", cells, np.arange(len(cells), dtype=np.float32))

    def to_sum(cell, nbr, offs, mask, to_nbr, to_offs, to_mask, scale):
        of = torch.sum(torch.where(mask, nbr["p0"], 0.0), dim=1)
        to = torch.sum(torch.where(to_mask, to_nbr["p0"], 0.0), dim=1)
        return {"Ap0": scale * (of - to)}

    g.apply_stencil(to_sum, ["p0"], ["Ap0"], neighborhood_id=7,
                    include_to=True, extra_args=(2.0,))
    nl = g.plan.hoods[7].lists
    p0 = np.arange(len(cells), dtype=np.float64)
    want = np.zeros(len(cells))
    np.add.at(want, nl.of_source, p0[np.searchsorted(cells, nl.of_neighbor)])
    np.add.at(want, nl.to_source, -p0[np.searchsorted(cells, nl.to_neighbor)])
    np.testing.assert_array_equal(g.get("Ap0", cells), 2.0 * want)


def test_state_carried_across():
    """convert.py moves the Poisson grid's float and int32 fields, and a
    DenseGrid's arrays, from the reference into the port: the port then
    computes the reference's matvec from the reference's state."""
    from dccrg_tpu.dense import DenseGrid as RefDenseGrid

    from dccrg_tpu_torch.convert import (dense_from_numpy, dense_to_numpy,
                                         fields_from_numpy, fields_to_numpy)
    from dccrg_tpu_torch.dense import DenseGrid

    r, p = _pair((5, 4, 3), periodic=(False, True, True))
    rng = np.random.default_rng(2)
    cells = r.grid.get_cells()
    r.prepare(cells_to_solve=cells[rng.random(len(cells)) < 0.7])
    r.grid.set("p0", cells, rng.standard_normal(len(cells)).astype(np.float32))
    state = {n: np.asarray(a) for n, a in r.grid.data.items()}
    fields_from_numpy(p.grid, state, L=r.grid.plan.L)
    back = fields_to_numpy(p.grid)
    for n, a in state.items():
        assert back[n].dtype == a.dtype
        np.testing.assert_array_equal(back[n], a, err_msg=n)
    p._solve_mask = p.grid.local_row_mask() * (p.grid.data["ctype"] == port.SOLVE_CELL)
    r._apply(transpose=False)
    p._apply(transpose=False)
    np.testing.assert_allclose(p.grid.data["Ap0"].numpy(), np.asarray(r.grid.data["Ap0"]),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(TypeError):
        fields_from_numpy(p.grid, {"ctype": state["ctype"].astype(np.int64)})

    rd = RefDenseGrid((4, 6, 2), {"p": jnp.float32, "k": jnp.int32},
                      mesh=dense_mesh(jax.devices()[:1], (1, 1, 1)))
    rd.init_fields(lambda x, y, z: {"p": x + 10 * y + 100 * z,
                                    "k": (8 * x).astype(jnp.int32)})
    pd = DenseGrid((4, 6, 2), {"p": torch.float32, "k": torch.int32}, device="cpu")
    dense_from_numpy(pd, {n: rd.to_host(n) for n in ("p", "k")})
    out = dense_to_numpy(pd)
    for n in ("p", "k"):
        assert out[n].dtype == rd.to_host(n).dtype
        np.testing.assert_array_equal(out[n], rd.to_host(n))
    with pytest.raises(ValueError):
        dense_from_numpy(pd, {"p": np.zeros((4, 6, 3), np.float32)})


def test_dense_grid_surface():
    """DenseGrid on one device: centers, init_fields, the halo pad
    (periodic wrap or the boundary value) and the one-device rule."""
    from dccrg_tpu.dense import DenseGrid as RefDenseGrid

    from dccrg_tpu_torch.dense import DenseGrid

    kw = dict(periodic=(True, False, True), start=(1.0, -2.0, 0.5),
              cell_length=(0.5, 0.25, 2.0))
    rd = RefDenseGrid((3, 4, 2), {"u": jnp.float32},
                      mesh=dense_mesh(jax.devices()[:1], (1, 1, 1)), **kw)
    pd = DenseGrid((3, 4, 2), {"u": torch.float32}, device="cpu", **kw)
    for d in range(3):
        np.testing.assert_array_equal(pd.cell_centers(d).numpy(),
                                      np.asarray(rd.cell_centers(d)))
    fn = lambda x, y, z: {"u": x * y - z}
    rd.init_fields(fn)
    pd.init_fields(fn)
    np.testing.assert_array_equal(pd.to_host("u"), rd.to_host("u"))
    step_r = rd.make_step(lambda b: {"u": b["u"][2:, 1:-1, :-2] * 2.0}, ("u",), ("u",),
                          halo=1, boundary=-1.0)
    step_p = pd.make_step(lambda b: {"u": b["u"][2:, 1:-1, :-2] * 2.0}, ("u",), ("u",),
                          halo=1, boundary=-1.0)
    np.testing.assert_array_equal(step_p(pd.arrays)["u"].numpy(),
                                  np.asarray(step_r(rd.arrays)["u"]))
    # a meta device is refused; one device's list is a mesh of blocks
    # along x, distinct devices' a mesh of blocks on each (item 5b.1b)
    with pytest.raises(ValueError, match="meta"):
        DenseGrid((4, 4, 4), {"u": torch.float32}, device=["cpu", "meta"])
    assert DenseGrid((4, 4, 4), {"u": torch.float32},
                     device=["cpu:0", "cpu:1"]).mesh.spans_devices
    two = DenseGrid((4, 4, 4), {"u": torch.float32}, device=["cpu", "cpu"])
    assert two.mesh_shape == (2, 1, 1) and two.block == (2, 4, 4)
