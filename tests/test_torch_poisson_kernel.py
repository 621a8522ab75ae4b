"""The port's Poisson matvec and its CG solvers against the reference.

The same seeded numpy inputs go through ``dccrg_tpu`` (the Pallas matvec
in interpret mode, the XLA dense solver on a one-device mesh) and
through ``dccrg_tpu_torch`` on the CPU, where kernel C's wrapper runs
its plain PyTorch version. Kernel C itself is held against that plain
version on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dccrg_tpu.dense import dense_mesh
from dccrg_tpu.models.poisson import DensePoissonSolver as RefDense
from dccrg_tpu.ops.poisson_kernel import PallasPoissonSolver, make_laplacian_matvec

import torch

from dccrg_tpu_torch.models.poisson import DensePoissonSolver, cg_solve
from dccrg_tpu_torch.ops import poisson_kernel as pk

SHAPE = (16, 8, 128)
PERIODIC = [(True, True, True), (False, True, True), (False, False, False)]


def _p(seed=3, shape=SHAPE):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("periodic", PERIODIC)
def test_matvec_plain_matches_pallas_f32(periodic):
    """float32: both apply the same operations in the same order, each
    rounded once, so the plain version equals the Pallas kernel bit for
    bit (tolerance 0)."""
    p = _p()
    want = np.asarray(make_laplacian_matvec(SHAPE, periodic=periodic,
                                            interpret=True)(p))
    mv = pk.make_laplacian_matvec(SHAPE, periodic=periodic)
    got = mv(torch.from_numpy(p)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("periodic", PERIODIC)
def test_matvec_plain_matches_pallas_bf16(periodic):
    """bfloat16: every operation rounded to bfloat16 on both sides, so
    the results are equal bit for bit as well."""
    p = _p(4)
    want = make_laplacian_matvec(SHAPE, periodic=periodic, dtype=jnp.bfloat16,
                                 interpret=True)(jnp.asarray(p, jnp.bfloat16))
    want = np.asarray(want).astype(np.float32)
    mv = pk.make_laplacian_matvec(SHAPE, periodic=periodic, dtype=torch.bfloat16)
    got = mv(torch.from_numpy(p))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_matvec_odd_shapes_and_edges():
    """Any extents work (the TPU tiling constraints are gone), including
    axes of length 1 and 2: the plain version against a numpy loop over
    the neighbors."""
    for shape, per in (((3, 1, 5), (True, True, False)),
                       ((2, 7, 2), (True, False, True)),
                       ((5, 6, 7), (False, True, False))):
        p = _p(5, shape).astype(np.float64)
        cl = (0.5, 0.25, 2.0)
        rd = [1.0 / c ** 2 for c in cl]
        want = np.zeros_like(p)
        for d in range(3):
            n = shape[d]
            t = [np.roll(p, 1, d) - p, np.roll(p, -1, d) - p]
            if not per[d]:
                idx = np.arange(n).reshape([-1 if e == d else 1 for e in range(3)])
                t = [np.where(idx > 0, t[0], 0.0), np.where(idx < n - 1, t[1], 0.0)]
            want += rd[d] * (t[0] + t[1])
        mv = pk.make_laplacian_matvec(shape, cell_length=cl, periodic=per)
        got = mv(torch.from_numpy(p.astype(np.float32))).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_matvec_wrapper_checks():
    mv = pk.make_laplacian_matvec((4, 4, 4))
    with pytest.raises(ValueError):
        mv(torch.zeros((4, 4, 5)))
    with pytest.raises(ValueError):
        pk.make_laplacian_matvec((4, 4, 4), dtype=torch.float64)
    before = pk.laplacian_matvec.launches
    mv(torch.zeros((4, 4, 4)))
    # the CPU path runs the plain version: no kernel launch is counted
    assert pk.laplacian_matvec.launches == before


def test_cuda_solver_matches_pallas_solver():
    """CudaPoissonSolver on the CPU (plain matvec) against
    PallasPoissonSolver in interpret mode on the same rhs: the same
    number of CG iterations, and solutions within 1e-5 of the solution's
    largest magnitude (the two sides reduce their dots in different
    orders, so the float32 iterates differ in the last bits)."""
    rng = np.random.default_rng(5)
    rhs = rng.random(SHAPE).astype(np.float32)
    rhs -= rhs.mean()
    xr, info_r = PallasPoissonSolver(SHAPE, interpret=True).solve(rhs, rtol=1e-5)
    solver = pk.CudaPoissonSolver(SHAPE, device="cpu")
    xp, info_p = solver.solve(rhs, rtol=1e-5)
    assert info_p["iterations"] == info_r["iterations"] > 0
    xr = np.asarray(xr, np.float64)
    xp = xp.numpy().astype(np.float64)
    denom = np.abs(xr).max()
    np.testing.assert_allclose(xp / denom, xr / denom, atol=1e-5)
    np.testing.assert_allclose(info_p["residual"], info_r["residual"], rtol=1e-3)


def test_dense_solver_matches_reference():
    """The port's DensePoissonSolver against the reference's on the same
    rhs (tests/test_poisson_kernel.py:54-73): one matvec bit for bit,
    then the whole solve to the same tolerance as the CUDA solver."""
    rng = np.random.default_rng(5)
    rhs = rng.random(SHAPE).astype(np.float32)
    rhs -= rhs.mean()
    ref = RefDense(SHAPE, mesh=dense_mesh(jax.devices()[:1], (1, 1, 1)))
    port = DensePoissonSolver(SHAPE, device="cpu")
    p = _p(7)
    want = np.asarray(ref._matvec({"p": jnp.asarray(p), "Ap": jnp.asarray(p)})["Ap"])
    np.testing.assert_array_equal(port.matvec(torch.from_numpy(p)).numpy(), want)
    xr, info_r = ref.solve(jnp.asarray(rhs), rtol=1e-5)
    xp, info_p = port.solve(rhs, rtol=1e-5)
    assert info_p["iterations"] == info_r["iterations"] > 0
    xr = np.asarray(xr, np.float64)
    denom = np.abs(xr).max()
    np.testing.assert_allclose(xp.numpy() / denom, xr / denom, atol=1e-5)


@pytest.mark.parametrize("periodic", [(True, True, True), (True, False, False)])
def test_dense_matvec_equals_kernel_plain(periodic):
    """The dense yardstick and kernel C's plain version compute the same
    function in the same order: bit for bit."""
    p = torch.from_numpy(_p(8, (12, 10, 9)))
    dense = DensePoissonSolver((12, 10, 9), device="cpu", periodic=periodic)
    mv = pk.make_laplacian_matvec((12, 10, 9), periodic=periodic)
    assert torch.equal(dense.matvec(p), mv(p))


def test_cg_solve_nonsingular_and_max_iterations():
    """cg_solve on a Neumann problem with singular=False stops at
    max_iterations, and reports the residual it reached."""
    mv = pk.make_laplacian_matvec((8, 8, 8), periodic=(False, False, False))
    rhs = torch.from_numpy(_p(9, (8, 8, 8)))
    rhs = rhs - rhs.mean()
    x, info = cg_solve(mv, rhs, singular=False, dtype=torch.float32,
                       rtol=1e-12, max_iterations=3)
    assert info["iterations"] == 3 and x.shape == (8, 8, 8)
    r = rhs - mv(x)
    assert np.isclose(float(torch.linalg.vector_norm(r)), info["residual"],
                      rtol=1e-3)
