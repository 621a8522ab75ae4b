"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these tests need an NVIDIA GPU and ``nvcc``, and skip
where there is none. This file imports neither ``jax`` nor the reference
package, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from dccrg_tpu_torch import DEFAULT_NEIGHBORHOOD_ID
from dccrg_tpu_torch import fleet
from dccrg_tpu_torch.models.advection import GridAdvection
from dccrg_tpu_torch.models.poisson import DensePoissonSolver
from dccrg_tpu_torch.ops import advection_kernel, poisson_kernel, roll_executor

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("periodic", [(True, True, False), (False, True, True)])
def test_bulk_kernel_matches_plain(device, periodic, k, dtype, monkeypatch):
    """Kernel A's pass against its plain version on the same inputs,
    at a grid whose extents are not multiples of the brick."""
    monkeypatch.setenv("DCCRG_BULK_SPP", str(k))
    a = GridAdvection(n=20, nz=7, device=device, periodic=periodic, dtype=dtype)
    g = a.grid
    n0 = 20 * 20 * 7
    gen = torch.Generator(device=device).manual_seed(k)
    g.data["density"][0, :n0] = torch.rand(n0, generator=gen, device=device).to(dtype)
    hood = g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID]
    spec = roll_executor._grid_spec_for(g, hood, k)
    fields = {f: g.data[f][0, :g.plan.L] for f in ("density", "vx", "vy")}
    extras = (torch.tensor(0.4 * a.max_time_step(), dtype=torch.float32),)
    before = roll_executor.bulk_pass.launches
    got = roll_executor.bulk_pass(spec, a._kernel, fields, extras)["density"]
    assert roll_executor.bulk_pass.launches == before + 1
    want = roll_executor.bulk_pass_plain(spec, a._kernel, fields, extras)["density"]
    assert got.dtype == dtype and got.shape == (g.plan.L,)
    # fmad off and the same order of operations: bit for bit
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spp", [1, 5, 8])
def test_rotation_kernel_matches_plain(device, spp, dtype):
    shape = (24, 40, 33)
    cell_length = (1.0 / 24, 1.0 / 40, 1.0 / 33)
    step = advection_kernel.make_rotation_step(shape, dtype=dtype,
                                               steps_per_pass=spp,
                                               tile=(8, 8),
                                               cell_length=cell_length)
    gen = torch.Generator(device=device).manual_seed(spp)
    rho = torch.rand(shape, generator=gen, device=device)
    x = (np.arange(24) + 0.5) / 24
    vxf = torch.linspace(-0.5, 0.5, 40, device=device)[None, :]
    vy = (x - 0.5).astype(np.float32)
    vyf = torch.as_tensor(np.concatenate([vy[-8:], vy, vy[:8]])[:, None],
                          device=device)
    before = advection_kernel.rotation_step.launches
    got = step(rho, vxf, vyf, 0.01)
    assert advection_kernel.rotation_step.launches == before + 1
    want = advection_kernel.rotation_step_plain(
        rho.to(dtype), vxf, vyf, 0.01, 1.0 / cell_length[0],
        1.0 / cell_length[1], spp)
    assert torch.equal(got, want)


def test_grid_run_steps_on_the_card(device):
    a = GridAdvection(n=32, device=device)
    before = roll_executor.bulk_pass.launches
    a.run(3)
    assert a.grid.last_step_path == "bulk"
    assert roll_executor.bulk_pass.launches == before + 3
    b = GridAdvection(n=32, device=device)
    b.run(3, bulk=False)
    assert b.grid.last_step_path == "roll"
    assert torch.equal(a.grid.data["density"], b.grid.data["density"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("periodic", [(True, True, True), (False, True, True),
                                      (False, False, False), (True, False, True)])
@pytest.mark.parametrize("shape", [(16, 8, 128), (24, 20, 36), (1, 2, 33)])
def test_laplacian_kernel_matches_plain(device, shape, periodic, dtype):
    """Kernel C against its plain version on the same inputs, at extents
    that are multiples of nothing and axes of length 1 and 2: fmad off
    and the same order of operations, so bit for bit."""
    mv = poisson_kernel.make_laplacian_matvec(
        shape, cell_length=(0.5, 0.25, 0.125), periodic=periodic, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(sum(shape))
    p = torch.rand(shape, generator=gen, device=device).to(dtype)
    before = poisson_kernel.laplacian_matvec.launches
    got = mv(p)
    assert poisson_kernel.laplacian_matvec.launches == before + 1
    want = poisson_kernel.laplacian_matvec_plain(p, mv.rdd2, mv.periodic)
    assert got.dtype == dtype and got.shape == p.shape
    assert torch.equal(got, want)


def test_cuda_poisson_solver_on_the_card(device):
    """CudaPoissonSolver runs every matvec through kernel C and walks the
    same trajectory as the dense plain solver (same arithmetic)."""
    n = 32
    gen = torch.Generator(device=device).manual_seed(1)
    rhs = torch.rand((n, n, n), generator=gen, device=device)
    rhs = rhs - rhs.mean()
    before = poisson_kernel.laplacian_matvec.launches
    x, info = poisson_kernel.CudaPoissonSolver((n, n, n)).solve(rhs, rtol=1e-5)
    assert poisson_kernel.laplacian_matvec.launches == before + info["iterations"]
    xd, info_d = DensePoissonSolver((n, n, n), device=device).solve(rhs, rtol=1e-5)
    assert info_d["iterations"] == info["iterations"] > 0
    assert torch.equal(x, xd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["diffuse", "advect_x"])
@pytest.mark.parametrize("periodic", [(True, True, True), (False, True, True),
                                      (False, False, False)])
@pytest.mark.parametrize("length", [(8, 8, 8), (24, 20, 36)])
def test_fleet_bulk_kernel_matches_plain(device, length, periodic, kernel, dtype):
    """Kernel A' against its plain version on a [B, R] state (pad rows
    included at (24, 20, 36)), each slot with its own parameter: fmad
    off and the same order of operations, so bit for bit."""
    B = 3
    job = fleet.FleetJob("p", length=length, kernel=kernel, periodic=periodic,
                         cell_data={"rho": dtype})
    grid = fleet.template_grid(job, device)
    twin = fleet.FLEET_BULK_KERNELS[kernel]
    step = roll_executor.make_fleet_bulk_step(grid, twin, ("rho",), ("rho",), 1)
    spec = step.spec
    gen = torch.Generator(device=device).manual_seed(sum(length))
    state = (torch.rand((B, spec.R), generator=gen, device=device) * 100).to(dtype)
    state[:, -1] = 0
    extras = torch.tensor([[0.02], [0.05], [0.11]], device=device)
    before = roll_executor.fleet_bulk_pass.launches
    got = roll_executor.fleet_bulk_pass(spec, twin, state, extras)
    assert roll_executor.fleet_bulk_pass.launches == before + 1
    want = roll_executor.fleet_bulk_pass_plain(spec, twin, state, extras)
    assert got.dtype == dtype and got.shape == state.shape
    assert torch.equal(got, want)


def test_grid_batch_bulk_quantum_on_the_card(device):
    """A GridBatch bucket on the card launches kernel A' once per step,
    its invariants are exact, and a table-program bucket of the same
    jobs digests equal to run_solo."""
    jobs = [fleet.FleetJob(f"j{i}", length=(16, 16, 16), n_steps=4,
                           params=(0.02 + 0.003 * i,), seed=i) for i in range(3)]
    bulk = fleet.GridBatch(jobs[0], 4, device=device)
    table = fleet.GridBatch(jobs[0], 4, device=device, bulk=False)
    for b in (bulk, table):
        for j in jobs:
            j.apply_init(b.grid)
            b.admit(j)
    budget = np.array([4, 4, 2, 0], np.int32)
    before = roll_executor.fleet_bulk_pass.launches
    bulk.step(budget)
    assert bulk.bulk_active() and not table.bulk_active()
    assert roll_executor.fleet_bulk_pass.launches == before + 4
    table.step(budget)
    np.testing.assert_array_equal(bulk.last_inv["fp_out"]["rho"],
                                  bulk.fingerprint_slots()["rho"])
    torch.testing.assert_close(bulk.state["rho"], table.state["rho"],
                               rtol=1e-5, atol=1e-6)
    jobs[2].n_steps = 2
    for slot in range(3):
        assert table.digest(slot) == fleet.run_solo(jobs[slot], device=device)
    assert bulk.finite_slots()[:3].all()
