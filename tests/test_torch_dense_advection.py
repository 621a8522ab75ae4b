"""The port's dense-path ``AdvectionSolver`` against the reference's.

The reference runs on a one-device mesh (``mesh3((1, 1, 1))``), the port
on the CPU; both start from the hump and the rotation field and take
the same float32 ``dt``. Under the test suite's 64-bit JAX the
reference widens ``rho`` to float64 after its first step (its
``dt / cell_length`` is a float64 scalar), the port stays in float32 as
on the card: ``rho`` agrees to rtol 1e-6 and atol 1e-7 of the peak
density (a few float32 roundings per step over 8 steps). Then the
reference file's own checks (tests/test_advection.py) on the port:
mass conservation, bounds, convergence with resolution, 3-D replicating
2-D, the CFL step, and the grid path against the dense path.
"""

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as P

from dccrg_tpu.dense import AXES, _shard_map, dense_mesh
from dccrg_tpu.models.advection import AdvectionSolver as RefSolver

from dccrg_tpu_torch.models import AdvectionSolver, GridAdvection

RTOL, ATOL_OF_PEAK = 1e-6, 1e-7


def mesh3(shape):
    n = int(np.prod(shape))
    return dense_mesh(jax.devices()[:n], shape)


def _pair(n, nz):
    return (RefSolver(n=n, nz=nz, mesh=mesh3((1, 1, 1))),
            AdvectionSolver(n=n, nz=nz, device="cpu"))


def _run_both(ref, got, steps, dt):
    for _ in range(steps):
        ref.step(np.float32(dt))
        got.step(np.float32(dt))


def _assert_rho_close(ref, got):
    want = np.asarray(ref.grid.to_host("rho"), dtype=np.float64)
    have = got.grid.to_host("rho")
    assert have.dtype == np.float32 and have.shape == want.shape
    np.testing.assert_allclose(have, want, rtol=RTOL,
                               atol=ATOL_OF_PEAK * float(np.abs(want).max()))


@pytest.mark.parametrize("n, nz", [(16, 4), (16, 1), (12, 6)])
def test_matches_reference(n, nz):
    ref, got = _pair(n, nz)
    assert np.isclose(got.max_time_step(), ref.max_time_step(), rtol=1e-6)
    np.testing.assert_allclose(got.total_mass(), ref.total_mass(), rtol=1e-6)
    dt = 0.4 * ref.max_time_step()
    _run_both(ref, got, 8, dt)
    _assert_rho_close(ref, got)
    assert got.time == pytest.approx(ref.time, rel=1e-6)
    np.testing.assert_allclose(got.total_mass(), ref.total_mass(), rtol=1e-6)
    assert abs(got.l2_error() - ref.l2_error()) < 1e-6


def _set_vz(solver, value, pad):
    """Give the solver a uniform vz (re-padding the velocities), so
    mass reaches the non-periodic z faces."""
    g = solver.grid
    g.arrays["vz"] = g.arrays["vz"] * 0 + value
    solver._vel_padded = tuple(pad(g.arrays[f]) for f in ("vx", "vy", "vz"))


@pytest.mark.parametrize("vz", [0.3, -0.2])
def test_non_periodic_z_faces_masked(vz):
    """With a velocity through the z faces, the reference's masked
    boundary fluxes (lax.axis_index there, position 0 here) keep the
    mass in the box: the port matches it and conserves mass."""
    ref, got = _pair(16, 6)
    pad = _shard_map(lambda b: ref.grid.pad_with_halo(b, 1),
                     mesh=ref.grid.mesh, in_specs=P(*AXES), out_specs=P(*AXES))
    _set_vz(ref, vz, jax.jit(pad))
    _set_vz(got, vz, lambda a: got.grid.pad_with_halo(a, 1))
    m0 = got.total_mass()
    dt = 0.4 * min(ref.max_time_step(), got.max_time_step())
    _run_both(ref, got, 8, dt)
    _assert_rho_close(ref, got)
    assert abs(got.total_mass() - m0) < 1e-6 * m0
    # mass moved along z: the layers differ now
    rho = got.grid.to_host("rho")
    assert not np.allclose(rho[:, :, 0], rho[:, :, -1])


def test_mesh_raises():
    """A mesh naming ``meta`` is refused; a mesh of blocks on one
    device, and one on distinct host devices (item 5b.1b), run, bit for
    bit with one block."""
    from dccrg_tpu_torch.dense import dense_mesh as port_mesh

    with pytest.raises(ValueError, match="meta"):
        AdvectionSolver(n=8, mesh=port_mesh(["cpu", "meta"], (2, 1, 1)))
    one = AdvectionSolver(n=8, nz=4, device="cpu")
    blocks = AdvectionSolver(n=8, nz=4, mesh=port_mesh(["cpu"] * 4, (2, 1, 2)))
    spread = AdvectionSolver(n=8, nz=4, mesh=port_mesh(
        ["cpu:0", "cpu:1", "cpu:2", "cpu:3"], (2, 1, 2)))
    for s in (one, blocks, spread):
        s.step()
    for s in (blocks, spread):
        np.testing.assert_array_equal(s.grid.to_host("rho"),
                                      one.grid.to_host("rho"))


def test_mass_conservation():
    s = AdvectionSolver(n=32, device="cpu")
    m0 = s.total_mass()
    for _ in range(20):
        s.step()
    assert abs(s.total_mass() - m0) < 1e-6 * max(m0, 1.0)


def test_density_bounds_and_positivity():
    s = AdvectionSolver(n=32, device="cpu")
    for _ in range(20):
        s.step()
    rho = s.grid.to_host("rho")
    assert rho.min() >= -1e-6
    assert rho.max() <= 0.5 + 1e-5  # first-order upwind never overshoots


def test_convergence_with_resolution():
    errs = []
    for n in (32, 64):
        s = AdvectionSolver(n=n, device="cpu")
        t_target = np.pi / 8
        while s.time < t_target:
            s.step(min(s.cfl * s.max_time_step(), t_target - s.time))
        errs.append(s.l2_error())
    assert errs[1] < errs[0]  # finer grid -> smaller error


def test_3d_replicates_2d_along_z():
    s = AdvectionSolver(n=16, nz=4, device="cpu")
    for _ in range(5):
        s.step()
    rho = s.grid.to_host("rho")
    for k in range(1, 4):
        np.testing.assert_allclose(rho[:, :, k], rho[:, :, 0], rtol=1e-6,
                                   atol=1e-7)


def test_max_time_step_matches_cfl():
    s = AdvectionSolver(n=32, device="cpu")
    vx, vy = s.grid.to_host("vx"), s.grid.to_host("vy")
    expect = min((1 / 32) / np.abs(vx)[np.abs(vx) > 0].max(),
                 (1 / 32) / np.abs(vy)[np.abs(vy) > 0].max())
    assert np.isclose(s.max_time_step(), expect, rtol=1e-6)


def test_grid_path_matches_dense_path():
    """GridAdvection (the general Grid step loop) against the dense path,
    cell for cell, at the reference's bounds (tests/test_advection.py)."""
    n, nz = 16, 4
    dense = AdvectionSolver(n=n, nz=nz, device="cpu")
    gridp = GridAdvection(n=n, nz=nz, device="cpu")
    dt = 0.4 * dense.max_time_step()
    assert np.isclose(gridp.max_time_step(), dense.max_time_step(), rtol=1e-6)
    for _ in range(8):
        dense.step(dt)
    gridp.run(8, dt)
    want = dense.grid.to_host("rho")  # [nx, ny, nz]
    got = gridp.density()  # cells sorted by id: x fastest, then y, z
    got3 = got.reshape(nz, n, n).transpose(2, 1, 0)
    np.testing.assert_allclose(got3, want, rtol=2e-5, atol=1e-6)
    assert abs(gridp.l2_error() - dense.l2_error()) < 1e-6
    assert np.isfinite(gridp.checksum())
