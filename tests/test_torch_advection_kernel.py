"""The port's rotation step (kernel B's plain version) against the
reference's Pallas kernel ``make_rotation_step`` in interpret mode.

The same seeded numpy density and face velocities go through both; on
CPU tensors the port's step runs the plain PyTorch version of kernel B.
Tolerances are those of tests/test_pallas_kernel.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dccrg_tpu.ops.advection_kernel import make_rotation_step as ref_make_step

from dccrg_tpu_torch.models.advection import (CudaRotationAdvection,
                                              analytic_density)
from dccrg_tpu_torch.ops import advection_kernel
from dccrg_tpu_torch.ops.advection_kernel import make_rotation_step

N, Z = 32, 128


def _inputs(seed=0):
    dx = 1.0 / N
    x = (np.arange(N) + 0.5) * dx
    rho = np.random.default_rng(seed).random((N, N, Z)).astype(np.float32)
    vxf = (0.5 - x).astype(np.float32)[None, :]
    vy = (x - 0.5).astype(np.float32)
    vyx = np.concatenate([vy[-8:], vy, vy[:8]])[:, None]
    return rho, vxf, vyx, np.float32(0.3 * dx)


@pytest.mark.parametrize("steps_per_pass", [1, 2, 4, 7])
def test_rotation_step_matches_reference_kernel(steps_per_pass):
    rho, vxf, vyx, dt = _inputs()
    ref = ref_make_step((N, N, Z), steps_per_pass=steps_per_pass,
                        tile=(8, 128), interpret=True)
    want = np.asarray(ref(jnp.asarray(rho), jnp.asarray(vxf),
                          jnp.asarray(vyx), dt))
    step = make_rotation_step((N, N, Z), steps_per_pass=steps_per_pass)
    before = advection_kernel.rotation_step.launches
    got = step(torch.from_numpy(rho), torch.from_numpy(vxf),
               torch.from_numpy(vyx), dt)
    assert advection_kernel.rotation_step.launches == before  # plain on CPU
    assert got.shape == (N, N, Z) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_rotation_step_bfloat16_matches_reference_kernel():
    """bfloat16 storage: both compute in the storage type and round
    every operation to it, so the two agree bit for bit."""
    rho, vxf, vyx, dt = _inputs(seed=1)
    ref = ref_make_step((N, N, Z), dtype=jnp.bfloat16, steps_per_pass=4,
                        tile=(8, 128), interpret=True)
    want = np.asarray(ref(jnp.asarray(rho), jnp.asarray(vxf),
                          jnp.asarray(vyx), dt)).astype(np.float32)
    step = make_rotation_step((N, N, Z), dtype=torch.bfloat16,
                              steps_per_pass=4)
    got = step(torch.from_numpy(rho), torch.from_numpy(vxf),
               torch.from_numpy(vyx), dt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_rotation_step_any_extent_and_checks():
    """The TPU tiling constraints (Z % 128, tx % 8) are gone; shapes,
    the band and z chunk of the tile (``(by, tz)``: threads and shared
    memory of one block) are still checked."""
    step = make_rotation_step((12, 10, 20), steps_per_pass=3)
    assert step.tile == advection_kernel.DEFAULT_TILE == (64, 16)
    x = (np.arange(12) + 0.5) / 12
    rho = torch.rand(12, 10, 20, generator=torch.Generator().manual_seed(0))
    vxf = torch.full((1, 10), 0.1)
    vyf = torch.from_numpy(np.concatenate([x[-8:], x, x[:8]])[:, None]
                           .astype(np.float32) - 0.5)
    out = step(rho, vxf, vyf, 0.01)
    assert out.shape == (12, 10, 20) and torch.isfinite(out).all()
    # mass is conserved by the periodic upwind update
    assert abs(float(out.double().sum() - rho.double().sum())) < 1e-3
    # a band of 8 rows and 8 z-columns: the same step
    small = make_rotation_step((12, 10, 20), steps_per_pass=3, tile=(8, 8))
    assert small.tile == (8, 8)
    assert torch.equal(small(rho, vxf, vyf, 0.01), out)
    with pytest.raises(ValueError):
        step(rho[:, :, :10], vxf, vyf, 0.01)
    with pytest.raises(ValueError):
        step(rho, vxf, vyf[:12], 0.01)
    with pytest.raises(ValueError):
        make_rotation_step((12, 10, 20), steps_per_pass=9)
    # tz must be 8, 16 or 32
    with pytest.raises(ValueError):
        make_rotation_step((64, 64, 64), tile=(64, 64), steps_per_pass=8)
    # (by + 2 * spp) * tz / 2 threads above 1024
    with pytest.raises(ValueError):
        make_rotation_step((64, 64, 64), tile=(60, 32), steps_per_pass=8)
    with pytest.raises(ValueError):
        make_rotation_step((64, 64, 64), tile=(0, 16))
    # any X fits: the folded y velocities stream through a fixed ring
    long = make_rotation_step((60000, 4, 4), steps_per_pass=8)
    assert long.tile == advection_kernel.DEFAULT_TILE


def _l2_vs_analytic(s):
    n, nz = s.n, s.nz
    x = torch.as_tensor((np.arange(n) + 0.5) / n)
    exact = analytic_density(x[:, None, None], x[None, :, None], s.time)
    err = (s.rho.double() - exact).pow(2).mean().sqrt()
    assert s.rho.shape == (n, n, nz)
    return float(err)


def test_rotation_solver_l2():
    s = CudaRotationAdvection(n=32, nz=128, steps_per_pass=4, device="cpu")
    dt = 0.5 * s.max_time_step()
    for _ in range(4):
        s.step(dt)
    assert _l2_vs_analytic(s) < 0.05


def test_rotation_solver_bfloat16_mass_and_l2():
    """bfloat16 state stays narrow through the steps; mass and the L2
    error keep the bounds of tests/test_pallas_kernel.py."""
    s = CudaRotationAdvection(n=32, nz=128, dtype=torch.bfloat16,
                              steps_per_pass=4, device="cpu")
    assert s.rho.dtype == torch.bfloat16
    dt = 0.5 * s.max_time_step()
    m0 = float(s.rho.float().sum())
    for _ in range(4):
        s.step(dt)
    assert s.rho.dtype == torch.bfloat16
    m1 = float(s.rho.float().sum())
    assert abs(m1 - m0) < 3e-2 * max(m0, 1.0)
    assert _l2_vs_analytic(s) < 0.08
