"""The port's dense grid on a mesh of blocks against the reference's.

The reference shards ``DenseGrid`` over a 3-D device mesh and fills the
halos with ``lax.ppermute`` inside ``shard_map`` (dccrg_tpu/dense.py);
the port keeps every block on one device and copies the neighbour
blocks' face slabs. Both run here on the same seeded numpy inputs: the
reference on the conftest's virtual CPU devices, the port on the CPU.

- ``pad_with_halo`` (the padded blocks side by side) and ``make_step``
  (a step reading ``axis_index`` and blocked and whole extras) on meshes
  (1,1,1), (2,1,1), (2,2,2) and (1,2,4) with periodic mixes: bit for bit;
- ``AdvectionSolver`` on tests/test_advection.py's meshes: within rtol
  2e-5, atol 1e-6 of the reference (its float64 widening under the
  suite's 64-bit JAX), and bit for bit with the port's one-block run,
  also with a velocity through the non-periodic z faces, whose mask
  needs the global index;
- ``DensePoissonSolver`` on (2,2,2): the solution within 1e-4 of its
  peak of the reference's, bit for bit with one block.
"""

import numpy as np
import pytest
import torch

import jax
from jax import lax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from dccrg_tpu.dense import AXES, DenseGrid as RefDenseGrid, _shard_map
from dccrg_tpu.dense import dense_mesh as ref_mesh
from dccrg_tpu.models.advection import AdvectionSolver as RefAdvection
from dccrg_tpu.models.poisson import DensePoissonSolver as RefDensePoisson

from dccrg_tpu_torch.dense import BLOCKS, WHOLE, DenseGrid, dense_mesh
from dccrg_tpu_torch.models import AdvectionSolver
from dccrg_tpu_torch.models.poisson import DensePoissonSolver

LENGTH = (4, 6, 8)
MESHES = [(1, 1, 1), (2, 1, 1), (2, 2, 2), (1, 2, 4)]
PERIODIC = [(True, True, True), (False, False, False), (True, False, True)]


def _meshes(shape):
    n = int(np.prod(shape))
    return ref_mesh(jax.devices()[:n], shape), dense_mesh(["cpu"] * n, shape)


def _grids(shape, periodic, fields):
    rm, pm = _meshes(shape)
    kw = dict(periodic=periodic, start=(0.0, 1.0, -1.0),
              cell_length=(0.5, 0.25, 0.125))
    rd = RefDenseGrid(LENGTH, {n: jnp.float32 for n in fields}, mesh=rm, **kw)
    pd = DenseGrid(LENGTH, {n: torch.float32 for n in fields}, mesh=pm, **kw)
    rng = np.random.default_rng(11)
    for n in fields:
        v = rng.standard_normal(LENGTH).astype(np.float32)
        rd.arrays[n] = jax.device_put(jnp.asarray(v), rd.sharding())
        pd.arrays[n] = torch.as_tensor(v)
    return rd, pd


@pytest.mark.parametrize("periodic", PERIODIC)
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("halo", [1, 2])
def test_pad_with_halo_matches_shard_map(shape, periodic, halo):
    rd, pd = _grids(shape, periodic, ("u",))
    pad = jax.jit(_shard_map(lambda b: rd.pad_with_halo(b, halo, -1.5),
                             mesh=rd.mesh, in_specs=P(*AXES),
                             out_specs=P(*AXES)))
    want = np.asarray(pad(rd.arrays["u"]))
    got = pd.pad_with_halo(pd.arrays["u"], halo, -1.5).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _ref_step_fn(length):
    def fn(b, ext, w):
        u = b["u"]
        core = u[1:-1, 1:-1, 1:-1]
        nloc = core.shape
        out = u[2:, 1:-1, 1:-1] - u[:-2, 1:-1, 1:-1] + ext[1:-1, 1:-1, 1:-1]
        for d in range(3):
            pos = lax.axis_index(AXES[d])
            glob = pos * nloc[d] + lax.broadcasted_iota(jnp.int32, nloc, d)
            out = jnp.where(glob == length[d] - 1, out + w, out)
        return {"v": out, "u": core - w}
    return fn


def _port_step_fn(length, grid):
    def fn(b, ext, w):
        u = b["u"]
        core = u[1:-1, 1:-1, 1:-1]
        nloc = core.shape
        out = u[2:, 1:-1, 1:-1] - u[:-2, 1:-1, 1:-1] + ext[1:-1, 1:-1, 1:-1]
        for d in range(3):
            shape = [1, 1, 1]
            shape[d] = nloc[d]
            glob = (grid.axis_index(AXES[d]) * nloc[d]
                    + torch.arange(nloc[d]).view(shape))
            out = torch.where(glob == length[d] - 1, out + w, out)
        return {"v": out, "u": core - w}
    return fn


@pytest.mark.parametrize("periodic", PERIODIC)
@pytest.mark.parametrize("shape", MESHES)
def test_make_step_matches_shard_map(shape, periodic):
    """A step over blocks that reads its mesh position, a blocked extra
    (the padded blocks of another field) and a whole extra."""
    rd, pd = _grids(shape, periodic, ("u", "v"))
    rpad = jax.jit(_shard_map(lambda b: rd.pad_with_halo(b, 1),
                              mesh=rd.mesh, in_specs=P(*AXES),
                              out_specs=P(*AXES)))
    r_ext = rpad(rd.arrays["v"])
    p_ext = pd.pad_with_halo(pd.arrays["v"], 1)
    np.testing.assert_array_equal(p_ext.numpy(), np.asarray(r_ext))
    rstep = rd.make_step(_ref_step_fn(LENGTH), ("u",), ("v", "u"), halo=1,
                         boundary=2.0, extra_specs=(P(*AXES), P()))
    pstep = pd.make_step(_port_step_fn(LENGTH, pd), ("u",), ("v", "u"), halo=1,
                         boundary=2.0, extra_specs=(BLOCKS, WHOLE))
    w = np.float32(0.75)
    want = rstep(rd.arrays, r_ext, jnp.float32(w))
    got = pstep(pd.arrays, p_ext, torch.tensor(w))
    for n in ("u", "v"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    # a list of per-block extras is the same as the tensor split
    blocks = pd._split(p_ext)
    again = pstep(pd.arrays, blocks, torch.tensor(w))
    np.testing.assert_array_equal(again["v"].numpy(), got["v"].numpy())


def test_mesh_surface():
    rm, pm = _meshes((2, 1, 2))
    rd = RefDenseGrid((4, 6, 8), {"u": jnp.float32}, mesh=rm)
    pd = DenseGrid((4, 6, 8), {"u": torch.float32}, mesh=pm)
    assert pd.n_cells == rd.n_cells == 192
    assert pd.mesh_shape == rd.mesh_shape and pd.block == rd.block
    for ijk in [(0, 0, 0), (3, 5, 7), (1, 2, 3)]:
        assert pd.cell_id_of_index(*ijk) == rd.cell_id_of_index(*ijk)
    assert pm.axis_names == AXES and pm.shape == (2, 1, 2)
    assert len(pm.devices) == 4
    assert dense_mesh(["cpu"] * 3).shape == (3, 1, 1)
    with pytest.raises(ValueError, match="does not cover"):
        dense_mesh(["cpu"] * 4, (2, 1, 1))
    with pytest.raises(ValueError, match="not divisible"):
        DenseGrid((4, 6, 7), {"u": torch.float32}, mesh=pm)
    with pytest.raises(ValueError):
        DenseGrid((4, 6, 8), {"u": torch.float32}, device="cpu", mesh=pm)
    with pytest.raises(ValueError, match="meta"):
        dense_mesh(["cpu", "meta"])
    assert dense_mesh(["cpu:0", "cpu:1"]).spans_devices
    with pytest.raises(RuntimeError):
        pd.axis_index("x")


def test_exchange_bytes_counts_slabs_between_blocks():
    """(2, 1, 1) periodic in x: each of two blocks receives two 6 x 8
    slabs of one float32 per halo cell; non-periodic, one each. Axes of
    one block copy their own wrap, which moves nothing between blocks."""
    pm = dense_mesh(["cpu"] * 2)
    per = DenseGrid(LENGTH, {"u": torch.float32}, mesh=pm,
                    periodic=(True, True, True))
    assert per.exchange_bytes(1) == 4 * 48 * 4
    assert per.exchange_bytes(2) == 2 * 4 * 48 * 4
    edge = DenseGrid(LENGTH, {"u": torch.float32, "w": torch.float64},
                     mesh=pm)
    assert edge.exchange_bytes(1, ["u"]) == 2 * 48 * 4
    assert edge.exchange_bytes(1) == 2 * 48 * 12
    # on (2, 2, 1) the y slabs span the x-padded extent
    sq = DenseGrid(LENGTH, {"u": torch.float32},
                   mesh=dense_mesh(["cpu"] * 4, (2, 2, 1)),
                   periodic=(True, True, True))
    x_cells = 4 * 2 * (3 * 8)
    y_cells = 4 * 2 * ((2 + 2) * 8)
    assert sq.exchange_bytes(1) == (x_cells + y_cells) * 4


ADVECTION_CASES = [  # tests/test_advection.py's solvers
    (32, 1, (2, 2, 1), 20),
    (64, 1, (4, 2, 1), 10),
    (16, 8, (2, 2, 2), 10),
    (16, 4, (2, 1, 2), 10),
    (32, 1, (1, 1, 1), 10),
]


@pytest.mark.parametrize("n, nz, shape, steps", ADVECTION_CASES)
def test_advection_solver_on_mesh(n, nz, shape, steps):
    rm, pm = _meshes(shape)
    ref = RefAdvection(n=n, nz=nz, mesh=rm)
    got = AdvectionSolver(n=n, nz=nz, mesh=pm)
    one = AdvectionSolver(n=n, nz=nz, device="cpu")
    dt = 0.4 * ref.max_time_step()
    assert got.max_time_step() == one.max_time_step()
    for _ in range(steps):
        for s in (ref, got, one):
            s.step(np.float32(dt))
    want = np.asarray(ref.grid.to_host("rho"), dtype=np.float64)
    have = got.grid.to_host("rho")
    np.testing.assert_allclose(have, want, rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(have, one.grid.to_host("rho"))
    assert abs(got.total_mass() - ref.total_mass()) < 1e-6


def _set_vz(solver, value, pad):
    g = solver.grid
    g.arrays["vz"] = g.arrays["vz"] * 0 + value
    solver._vel_padded = tuple(pad(g.arrays[f]) for f in ("vx", "vy", "vz"))


@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 2, 4)])
def test_advection_z_faces_masked_at_global_index(shape):
    """With a velocity through the non-periodic z faces, blocks split
    along z mask only the grid's outer faces (mesh position x block
    extent + local index): bit for bit with one block, the mass kept,
    and the reference's result within its tolerance."""
    rm, pm = _meshes(shape)
    ref = RefAdvection(n=16, nz=8, mesh=rm)
    got = AdvectionSolver(n=16, nz=8, mesh=pm)
    one = AdvectionSolver(n=16, nz=8, device="cpu")
    rpad = jax.jit(_shard_map(lambda b: ref.grid.pad_with_halo(b, 1),
                              mesh=rm, in_specs=P(*AXES), out_specs=P(*AXES)))
    _set_vz(ref, 0.3, rpad)
    for s in (got, one):
        _set_vz(s, 0.3, lambda a, s=s: s.grid.pad_with_halo(a, 1))
    m0 = one.total_mass()
    dt = 0.4 * min(ref.max_time_step(), one.max_time_step())
    for _ in range(8):
        for s in (ref, got, one):
            s.step(np.float32(dt))
    have = got.grid.to_host("rho")
    np.testing.assert_array_equal(have, one.grid.to_host("rho"))
    np.testing.assert_allclose(have, np.asarray(ref.grid.to_host("rho")),
                               rtol=2e-5, atol=1e-6)
    assert abs(got.total_mass() - m0) < 1e-6 * m0
    assert not np.allclose(have[:, :, 0], have[:, :, -1])


@pytest.mark.parametrize("periodic", [(True, True, True), (True, True, False)])
def test_dense_poisson_on_mesh(periodic):
    n = 8
    rng = np.random.default_rng(5)
    rhs = rng.standard_normal((n, n, n))
    rhs = (rhs - rhs.mean()).astype(np.float32)
    ref = RefDensePoisson((n, n, n), mesh=ref_mesh(jax.devices()[:8], (2, 2, 2)),
                          periodic=periodic)
    got = DensePoissonSolver((n, n, n), periodic=periodic,
                             mesh=dense_mesh(["cpu"] * 8, (2, 2, 2)))
    one = DensePoissonSolver((n, n, n), periodic=periodic, device="cpu")
    xr, ir = ref.solve(rhs, rtol=1e-5)
    xg, ig = got.solve(rhs, rtol=1e-5)
    xo, io = one.solve(rhs, rtol=1e-5)
    torch.testing.assert_close(xg, xo, rtol=0, atol=0)
    assert ig == io
    assert abs(ig["iterations"] - ir["iterations"]) <= 2
    want = np.asarray(xr, dtype=np.float64)
    assert np.abs(xg.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    # the operator's matvec itself, block by block, against the reference
    p = torch.as_tensor(rhs)
    lap = got.matvec(p).numpy()
    ref_lap = ref._matvec({"p": jnp.asarray(rhs), "Ap": jnp.asarray(rhs)})["Ap"]
    np.testing.assert_allclose(lap, np.asarray(ref_lap), rtol=1e-6,
                               atol=1e-6 * np.abs(lap).max())
