"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these tests need an NVIDIA GPU and ``nvcc``, and skip
where there is none. This file imports neither ``jax`` nor the reference
package, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import dccrg_tpu_torch as port
from dccrg_tpu_torch import DEFAULT_NEIGHBORHOOD_ID
from dccrg_tpu_torch import fleet
from dccrg_tpu_torch.models.advection import (AdvectionSolver, GridAdvection,
                                              make_uniform_flux_kernel)
from dccrg_tpu_torch.models.poisson import DensePoissonSolver, cg_solve
from dccrg_tpu_torch.ops import advection_kernel, poisson_kernel, roll_executor

pytestmark = pytest.mark.cuda

FIELDS = ("density", "vx", "vy")
# a user neighbourhood with reach 2 in y and z: kernel A's direct route
REACH2_HOOD = [(1, 2, 0), (-1, -2, 0), (1, 0, 2), (-1, 0, -2), (0, 1, 0)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def _hood_grid(dims, periodic, hood_len, dtype, device, seed):
    """A grid with the advection fields: seeded density and velocities
    of both signs, so both upwind sides are taken."""
    g = (port.Grid(cell_data={f: torch.float32 for f in FIELDS}, dtype=dtype)
         .set_initial_length(dims).set_periodic(*periodic)
         .set_maximum_refinement_level(0).set_neighborhood_length(hood_len)
         .initialize(device))
    n0 = int(np.prod(dims))
    gen = torch.Generator(device=device).manual_seed(seed)
    for f, shift in (("density", 0.0), ("vx", 0.5), ("vy", 0.5)):
        v = torch.rand(n0, generator=gen, device=device) - shift
        g.data[f][0, :n0] = v.to(dtype)
    return g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hood", ["face", "cube", "reach2"])
@pytest.mark.parametrize("periodic", [(True, True, False), (False, True, True),
                                      (False, False, False)])
@pytest.mark.parametrize("dims", [(20, 20, 7), (24, 20, 36), (17, 9, 5)])
def test_bulk_kernel_matches_plain(device, dims, periodic, hood, dtype):
    """Kernel A (one launch) against its plain version on the same
    inputs, at extents that are not multiples of the tile (and, at
    (17, 9, 5), of the vector width), on both routes: the face set
    (plane tiles, unrolled) and, for the 26-cube and a user
    neighbourhood of reach 2, the direct kernel."""
    hood_len = {"face": 0, "cube": 1, "reach2": 2}[hood]
    g = _hood_grid(dims, periodic, hood_len, dtype, device, seed=sum(dims))
    hood_id = DEFAULT_NEIGHBORHOOD_ID
    if hood == "reach2":
        hood_id = 7
        assert g.add_neighborhood(hood_id, REACH2_HOOD)
    spec = roll_executor._grid_spec_for(g, g.plan.hoods[hood_id])
    assert spec.face4 == (hood == "face")
    kern = make_uniform_flux_kernel(tuple(1.0 / d for d in dims))
    fields = {f: g.data[f][0, :g.plan.L] for f in FIELDS}
    extras = (torch.tensor(0.02, dtype=torch.float32),)
    before = roll_executor.bulk_pass.launches
    got = roll_executor.bulk_pass(spec, kern, fields, extras)["density"]
    assert roll_executor.bulk_pass.launches == before + 1
    want = roll_executor.bulk_pass_plain(spec, kern, fields, extras)["density"]
    assert got.dtype == dtype and got.shape == (g.plan.L,)
    # fmad off and the same order of operations: bit for bit
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", range(2, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hood", ["face", "cube", "reach2"])
@pytest.mark.parametrize("periodic", [(True, True, False), (False, True, True),
                                      (False, False, False)])
@pytest.mark.parametrize("dims", [(20, 20, 7), (24, 20, 36), (17, 9, 5),
                                  (300, 200, 4), (16, 8, 70), (130, 70, 1)])
def test_bulk_k_kernel_matches_plain(device, dims, periodic, hood, dtype, k):
    """Kernel A's k-deep pass (one launch) against its plain version (k
    plain steps) and against k launches of the one-step kernel, on both
    of its routes: the face set's plane route and the bricks of the
    26-cube and the reach-2 neighbourhood, whose halo wraps more than
    once where it is wider than the grid. The plane route's blocking is
    ragged at (300, 200, 4) (two bands of 160 columns for 300, segments
    of 50 rows), at (16, 8, 70) (a 32-column band for 16, one segment)
    and at (130, 70, 1) (a 160-column band, a single plane). A k the
    rule declines raises before any launch."""
    hood_len = {"face": 0, "cube": 1, "reach2": 2}[hood]
    g = _hood_grid(dims, periodic, hood_len, dtype, device, seed=sum(dims) + k)
    hood_id = DEFAULT_NEIGHBORHOOD_ID
    if hood == "reach2":
        hood_id = 7
        assert g.add_neighborhood(hood_id, REACH2_HOOD)
    spec = roll_executor._grid_spec_for(g, g.plan.hoods[hood_id])
    kern = make_uniform_flux_kernel(tuple(1.0 / d for d in dims))
    fields = {f: g.data[f][0, :g.plan.L] for f in FIELDS}
    extras = (torch.tensor(0.02, dtype=torch.float32),)
    before = roll_executor.bulk_pass_k.launches
    deep = spec.deep(k)
    assert (deep is not None) == (hood != "reach2" or k <= 5)
    if deep is None:
        with pytest.raises(ValueError):
            roll_executor.bulk_pass_k(spec, kern, fields, extras, k)
        assert roll_executor.bulk_pass_k.launches == before
        return
    got = roll_executor.bulk_pass_k(spec, kern, fields, extras, k)["density"]
    torch.cuda.synchronize()
    assert roll_executor.bulk_pass_k.launches == before + 1
    want = roll_executor.bulk_pass_k_plain(spec, kern, fields, extras,
                                           k)["density"]
    assert got.dtype == dtype and got.shape == (g.plan.L,)
    assert torch.equal(got, want)
    cur = dict(fields)
    for _ in range(k):
        cur.update(roll_executor.bulk_pass(spec, kern, cur, extras))
    assert torch.equal(got, cur["density"])


@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_run_steps_k_deep_on_the_card(device, k, dtype, monkeypatch):
    """``DCCRG_BULK_SPP=k`` on the card: 2k + 1 steps launch the k-deep
    pass twice and the one-step kernel once, bit for bit with the plain
    roll path."""
    monkeypatch.setenv("DCCRG_BULK_SPP", str(k))
    a = GridAdvection(n=32, device=device, dtype=dtype)
    deep, one = roll_executor.bulk_pass_k.launches, roll_executor.bulk_pass.launches
    a.run(2 * k + 1)
    assert a.grid.last_step_path == "bulk"
    assert roll_executor.bulk_pass_k.launches == deep + 2
    assert roll_executor.bulk_pass.launches == one + 1
    b = GridAdvection(n=32, device=device, dtype=dtype)
    b.run(2 * k + 1, bulk=False)
    assert torch.equal(a.grid.data["density"], b.grid.data["density"])


@pytest.mark.parametrize("k", [2, 3])
def test_grid_run_steps_k_deep_bricks_on_the_card(device, k, monkeypatch):
    """``DCCRG_BULK_SPP=k`` on a 128³ grid of the 26-cube, where the
    step loop takes the bricks at k = 2 and declines them at k = 3 (the
    rule takes them only at k = 2): 2k + 1 steps bit for bit with the
    plain roll path, with the launches the rule names."""
    monkeypatch.setenv("DCCRG_BULK_SPP", str(k))
    dims = (128, 128, 128)
    a, b = (_hood_grid(dims, (True, True, False), 1, torch.float32, device, 5)
            for _ in range(2))
    spec = roll_executor._grid_spec_for(a, a.plan.hoods[DEFAULT_NEIGHBORHOOD_ID])
    assert spec.deep_pays(k) == (k == 2)
    kern = make_uniform_flux_kernel(tuple(1.0 / d for d in dims))
    dt = torch.tensor(0.4 / 128, dtype=torch.float32)
    deep, one = roll_executor.bulk_pass_k.launches, roll_executor.bulk_pass.launches
    n = 2 * k + 1
    a.run_steps(kern, FIELDS, ["density"], n, extra_args=(dt,))
    assert a.last_step_path == "bulk"
    want = (2, 1) if k == 2 else (0, n)
    assert (roll_executor.bulk_pass_k.launches - deep,
            roll_executor.bulk_pass.launches - one) == want
    b.run_steps(kern, FIELDS, ["density"], n, extra_args=(dt,), bulk=False)
    assert torch.equal(a.data["density"], b.data["density"])


def _rho_grid(dims, periodic, hood_len, dtype, device, seed):
    """A grid with the fleet twins' field ``rho``, seeded."""
    g = (port.Grid(cell_data={"rho": torch.float32}, dtype=dtype)
         .set_initial_length(dims).set_periodic(*periodic)
         .set_maximum_refinement_level(0).set_neighborhood_length(hood_len)
         .initialize(device))
    n0 = int(np.prod(dims))
    gen = torch.Generator(device=device).manual_seed(seed)
    g.data["rho"][0, :n0] = (torch.rand(n0, generator=gen, device=device)
                             * 100).to(dtype)
    return g


# the fleet twins' flux extras: diffuse's dt, advect_x's cfl
TWIN_EXTRA = {"diffuse": 0.05, "advect_x": 0.4}
TWIN_DIMS = [(20, 20, 7), (17, 9, 5), (8, 4, 2)]
TWIN_PERIODIC = [(True, True, True), (True, True, False), (False, False, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hood_len", [0, 1, 2])
@pytest.mark.parametrize("flux", ["diffuse", "advect_x"])
@pytest.mark.parametrize("periodic", TWIN_PERIODIC)
@pytest.mark.parametrize("dims", TWIN_DIMS)
def test_bulk_twin_kernel_matches_plain(device, dims, periodic, flux,
                                        hood_len, dtype):
    """Kernel A's direct route for the fleet twins (one launch over the
    flux's slot table: 6, 26 or 124 slots for diffuse, 1 or 2 for
    advect_x) against its plain version bit for bit, at extents smaller
    than the reach of length 2 ((8, 4, 2): a neighbour wraps more than
    once on a periodic axis)."""
    g = _rho_grid(dims, periodic, hood_len, dtype, device, sum(dims))
    kern = fleet.FLEET_BULK_KERNELS[flux]
    spec = roll_executor._grid_spec_for(
        g, g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID], flux)
    assert not spec.face4
    fields = {"rho": g.data["rho"][0, :g.plan.L]}
    extras = (torch.tensor(TWIN_EXTRA[flux], dtype=torch.float32),)
    before = roll_executor.bulk_pass.launches
    got = roll_executor.bulk_pass(spec, kern, fields, extras)["rho"]
    assert roll_executor.bulk_pass.launches == before + 1
    want = roll_executor.bulk_pass_plain(spec, kern, fields, extras)["rho"]
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hood_len", [0, 1, 2])
@pytest.mark.parametrize("flux", ["diffuse", "advect_x"])
@pytest.mark.parametrize("periodic", TWIN_PERIODIC)
@pytest.mark.parametrize("dims", [(20, 20, 7), (17, 9, 5), (40, 36, 18)])
def test_bulk_twin_bricks_match_plain(device, dims, periodic, flux, hood_len,
                                      dtype, k):
    """Kernel A's bricks for the fleet twins (one field staged a plane),
    launched directly whatever the step loop's rule, against k plain
    steps and k one-step launches bit for bit; a k the rule declines
    (no tile fits) raises before any launch."""
    g = _rho_grid(dims, periodic, hood_len, dtype, device, sum(dims) + k)
    kern = fleet.FLEET_BULK_KERNELS[flux]
    spec = roll_executor._grid_spec_for(
        g, g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID], flux)
    fields = {"rho": g.data["rho"][0, :g.plan.L]}
    extras = (torch.tensor(TWIN_EXTRA[flux], dtype=torch.float32),)
    before = roll_executor.bulk_pass_k.launches
    if spec.deep(k) is None:
        with pytest.raises(ValueError):
            roll_executor.bulk_pass_k(spec, kern, fields, extras, k)
        assert roll_executor.bulk_pass_k.launches == before
        return
    assert spec.deep(k)[0] == "bricks"
    got = roll_executor.bulk_pass_k(spec, kern, fields, extras, k)["rho"]
    torch.cuda.synchronize()
    assert roll_executor.bulk_pass_k.launches == before + 1
    want = roll_executor.bulk_pass_k_plain(spec, kern, fields, extras, k)["rho"]
    assert torch.equal(got, want)
    cur = dict(fields)
    for _ in range(k):
        cur.update(roll_executor.bulk_pass(spec, kern, cur, extras))
    assert torch.equal(got, cur["rho"])


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("hood_len", [0, 1, 2])
@pytest.mark.parametrize("flux", ["diffuse", "advect_x"])
def test_grid_run_steps_twins_on_the_card(device, flux, hood_len, k,
                                          monkeypatch):
    """``Grid.run_steps`` with a fleet twin on the card takes the bulk
    path: 2k + 1 steps launch kernel A's k-deep pass n // k times where
    the step loop's rule takes it and the one-step kernel for the rest,
    bit for bit with the plain roll path."""
    monkeypatch.setenv("DCCRG_BULK_SPP", str(k))
    dims = (24, 20, 12)
    a, b = (_rho_grid(dims, (True, False, True), hood_len, torch.float32,
                      device, 9) for _ in range(2))
    kern = fleet.FLEET_BULK_KERNELS[flux]
    spec = roll_executor._grid_spec_for(
        a, a.plan.hoods[DEFAULT_NEIGHBORHOOD_ID], flux)
    n = 2 * k + 1
    dt = torch.tensor(TWIN_EXTRA[flux], dtype=torch.float32)
    deep, one = (roll_executor.bulk_pass_k.launches,
                 roll_executor.bulk_pass.launches)
    a.run_steps(kern, ["rho"], ["rho"], n, extra_args=(dt,))
    assert a.last_step_path == "bulk"
    want = divmod(n, k) if spec.deep_pays(k) else (0, n)
    assert (roll_executor.bulk_pass_k.launches - deep,
            roll_executor.bulk_pass.launches - one) == want
    b.run_steps(kern, ["rho"], ["rho"], n, extra_args=(dt,), bulk=False)
    assert b.last_step_path == "roll"
    assert torch.equal(a.data["rho"], b.data["rho"])


@pytest.mark.parametrize("tile", [None, (8, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spp", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("shape", [(24, 40, 33), (24, 20, 36), (17, 9, 5),
                                   (70000, 3, 8)])
def test_rotation_kernel_matches_plain(device, shape, spp, dtype, tile):
    """Kernel B against its plain version, at extents that are
    multiples of nothing and smaller than the halo (rows and planes
    wrap more than once), and at a long x extent (the y velocities'
    ring refilled many times), with the default band and a small
    one."""
    X, Y, Z = shape
    cell_length = (1.0 / X, 1.0 / Y, 1.0 / Z)
    step = advection_kernel.make_rotation_step(shape, dtype=dtype,
                                               steps_per_pass=spp,
                                               tile=tile,
                                               cell_length=cell_length)
    gen = torch.Generator(device=device).manual_seed(spp)
    rho = torch.rand(shape, generator=gen, device=device)
    x = (np.arange(X) + 0.5) / X
    vxf = torch.linspace(-0.5, 0.5, Y, device=device)[None, :]
    vy = (x - 0.5).astype(np.float32)
    vyf = torch.as_tensor(vy[(np.arange(X + 16) - 8) % X][:, None],
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
    same trajectory, bit for bit, as ``cg_solve`` over kernel C's plain
    matvec on the card: the same dots (``float(torch.sum(a * b))``) and
    a matvec that equals the kernel bit for bit. DensePoissonSolver sums
    its dots with ``comm.exact_sum`` (another order of additions, so
    other roundings of alpha and beta), so it is held to the solution
    within 1e-4 of its largest magnitude (CG stops at rtol 1e-5 of the
    residual) and to the iteration count within 2."""
    n = 32
    gen = torch.Generator(device=device).manual_seed(1)
    rhs = torch.rand((n, n, n), generator=gen, device=device)
    rhs = rhs - rhs.mean()
    solver = poisson_kernel.CudaPoissonSolver((n, n, n))
    before = poisson_kernel.laplacian_matvec.launches
    x, info = solver.solve(rhs, rtol=1e-5)
    assert poisson_kernel.laplacian_matvec.launches == before + info["iterations"]
    mv = solver._matvec

    def plain(p):
        return poisson_kernel.laplacian_matvec_plain(
            p.to(torch.float32).contiguous(), mv.rdd2, mv.periodic)

    xp, info_p = cg_solve(plain, rhs, singular=True, dtype=torch.float32,
                          rtol=1e-5, device=device)
    assert poisson_kernel.laplacian_matvec.launches == before + info["iterations"]
    assert info_p["iterations"] == info["iterations"] > 0
    assert torch.equal(x, xp)
    xd, info_d = DensePoissonSolver((n, n, n), device=device).solve(rhs, rtol=1e-5)
    assert abs(info_d["iterations"] - info["iterations"]) <= 2
    assert float((x - xd).abs().max()) <= 1e-4 * float(x.abs().max())


def _bits(t):
    """The raw storage words of a float32 or bfloat16 tensor."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _fleet_case(device, length, periodic, kernel, dtype, B, seed):
    job = fleet.FleetJob("p", length=length, kernel=kernel, periodic=periodic,
                         cell_data={"rho": dtype})
    grid = fleet.template_grid(job, device)
    twin = fleet.FLEET_BULK_KERNELS[kernel]
    step = roll_executor.make_fleet_bulk_step(grid, twin, ("rho",), ("rho",), 1)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = (torch.rand((B, step.spec.R), generator=gen, device=device)
             * 100).to(dtype)
    state[:, -1] = 0
    extras = (0.02 + 0.03 * torch.arange(B, device=device,
                                         dtype=torch.float32))[:, None]
    return step.spec, twin, state.contiguous(), extras.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["diffuse", "advect_x"])
@pytest.mark.parametrize("periodic", [(True, True, True), (False, True, True),
                                      (False, False, False)])
@pytest.mark.parametrize("length", [(8, 8, 8), (24, 20, 36), (17, 9, 5),
                                    (300, 200, 4), (16, 8, 70)])
def test_fleet_bulk_kernel_matches_plain(device, length, periodic, kernel, dtype):
    """Kernel A' against its plain version on a [B, R] state (pad rows
    included at (24, 20, 36)), each slot with its own parameter: fmad
    off and the same order of operations, so bit for bit. Both routes:
    the plane route (x extents up to 256 that are a multiple of the
    16-byte vector width) and the direct route ((17, 9, 5), whose x
    extent is not, and (300, 200, 4), wider than 256). With B = 5 most
    slot bases are not 16-byte aligned; with B = 200 at (16, 8, 70) the
    plane route marches 64-plane z chunks, the last one partial. Then
    the same state with the freeze: at step 1 of budgets cycling
    [2, 0, 1, 3, 1], the slots with budget 0 or 1 are frozen and keep
    their bytes exactly (a NaN with a payload and a -0.0 in slot 2
    included), the others step."""
    B = {(300, 200, 4): 2, (16, 8, 70): 200}.get(length, 5)
    spec, twin, state, extras = _fleet_case(device, length, periodic, kernel,
                                            dtype, B, sum(length))
    route = "direct" if length[0] in (17, 300) else "planes"
    assert roll_executor.fleet_route(spec, state) == route
    before = roll_executor.fleet_bulk_pass.launches
    got = roll_executor.fleet_bulk_pass(spec, twin, state, extras)
    assert roll_executor.fleet_bulk_pass.launches == before + 1
    want = roll_executor.fleet_bulk_pass_plain(spec, twin, state, extras)
    assert got.dtype == dtype and got.shape == state.shape
    assert torch.equal(got, want)

    budget = torch.tensor([(2, 0, 1, 3, 1)[s % 5] for s in range(B)],
                          dtype=torch.int32, device=device)
    if B > 2:
        words = _bits(state)
        words[2, 3] = 0x7FC01234 if dtype == torch.float32 else 0x7FC5
        state[2, 4] = -0.0
    got = roll_executor.fleet_bulk_pass(spec, twin, state, extras, budget, 1)
    assert roll_executor.fleet_bulk_pass.launches == before + 2
    want = roll_executor.fleet_freeze(
        roll_executor.fleet_bulk_pass_plain(spec, twin, state, extras),
        state, budget, 1)
    assert torch.equal(_bits(got), _bits(want))
    frozen = (budget <= 1).nonzero().flatten()
    assert torch.equal(_bits(got[frozen]), _bits(state[frozen]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["diffuse", "advect_x"])
@pytest.mark.parametrize("hood_len", [0, 2])
@pytest.mark.parametrize("periodic", [(True, True, True), (False, True, True),
                                      (False, False, False)])
@pytest.mark.parametrize("length", [(8, 8, 8), (24, 20, 36), (17, 9, 5),
                                    (8, 4, 2)])
def test_fleet_slots_route_matches_plain(device, length, periodic, hood_len,
                                         kernel, dtype):
    """Kernel A''s slot-table route (a bucket of neighbourhood length 0
    or 2) against its plain version on a [5, R] state bit for bit, and
    with the freeze at step 1 of budgets [2, 0, 1, 3, 1]: the frozen
    slots keep their bytes, a NaN with a payload and a -0.0 included.
    At (8, 4, 2) a reach of 2 crosses the extent more than once."""
    job = fleet.FleetJob("p", length=length, kernel=kernel, periodic=periodic,
                         cell_data={"rho": dtype}, hood_len=hood_len)
    grid = fleet.template_grid(job, device)
    twin = fleet.FLEET_BULK_KERNELS[kernel]
    spec = roll_executor.make_fleet_bulk_step(grid, twin, ("rho",), ("rho",),
                                              1).spec
    B = 5
    gen = torch.Generator(device=device).manual_seed(sum(length) + hood_len)
    state = (torch.rand((B, spec.R), generator=gen, device=device)
             * 100).to(dtype)
    state[:, -1] = 0
    extras = (0.02 + 0.03 * torch.arange(B, device=device,
                                         dtype=torch.float32))[:, None]
    assert roll_executor.fleet_route(spec, state) == "slots"
    before = roll_executor.fleet_bulk_pass.launches
    got = roll_executor.fleet_bulk_pass(spec, twin, state, extras)
    assert roll_executor.fleet_bulk_pass.launches == before + 1
    want = roll_executor.fleet_bulk_pass_plain(spec, twin, state, extras)
    assert torch.equal(got, want)
    budget = torch.tensor([2, 0, 1, 3, 1], dtype=torch.int32, device=device)
    _bits(state)[2, 3] = 0x7FC01234 if dtype == torch.float32 else 0x7FC5
    state[2, 4] = -0.0
    got = roll_executor.fleet_bulk_pass(spec, twin, state, extras, budget, 1)
    want = roll_executor.fleet_freeze(
        roll_executor.fleet_bulk_pass_plain(spec, twin, state, extras),
        state, budget, 1)
    assert torch.equal(_bits(got), _bits(want))
    frozen = (budget <= 1).nonzero().flatten()
    assert torch.equal(_bits(got[frozen]), _bits(state[frozen]))


@pytest.mark.parametrize("hood_len", [0, 2])
def test_grid_batch_hood_len_on_the_card(device, hood_len):
    """A GridBatch bucket of neighbourhood length 0 or 2 on the card
    takes kernel A' (the slot-table route), one launch a step, equal
    to q plain passes each followed by the freeze bit for bit, and to
    the table program within float re-association (at length 2 a dt
    below 1 / 124, the explicit step's stability limit there)."""
    dt0 = 0.002 if hood_len == 2 else 0.02
    jobs = [fleet.FleetJob(f"j{i}", length=(16, 12, 10), n_steps=3,
                           params=(dt0 + 0.001 * i,), seed=i,
                           hood_len=hood_len) for i in range(3)]
    bulk = fleet.GridBatch(jobs[0], 3, device=device)
    table = fleet.GridBatch(jobs[0], 3, device=device, bulk=False)
    for b in (bulk, table):
        for j in jobs:
            j.apply_init(b.grid)
            b.admit(j)
    budget = np.array([3, 1, 3], np.int32)
    spec = roll_executor.make_fleet_bulk_step(
        bulk.grid, bulk.bulk_kernel, ("rho",), ("rho",), 1).spec
    ref = bulk.state["rho"].clone()
    extras = torch.as_tensor(bulk._extras, device=device)
    budget_dev = torch.as_tensor(budget, device=device)
    for i in range(3):
        ref = roll_executor.fleet_freeze(
            roll_executor.fleet_bulk_pass_plain(spec, bulk.bulk_kernel, ref,
                                                extras), ref, budget_dev, i)
    before = roll_executor.fleet_bulk_pass.launches
    bulk.step(budget)
    assert bulk.bulk_active() and not table.bulk_active()
    assert roll_executor.fleet_bulk_pass.launches == before + 3
    assert torch.equal(_bits(bulk.state["rho"]), _bits(ref))
    table.step(budget)
    torch.testing.assert_close(bulk.state["rho"], table.state["rho"],
                               rtol=1e-5, atol=1e-6)


def test_grid_batch_bulk_quantum_on_the_card(device):
    """A GridBatch bucket on the card launches kernel A' once per step,
    freeze included, and equals q plain passes each followed by the
    where freeze bit for bit; its invariants are exact, and a
    table-program bucket of the same jobs digests equal to run_solo."""
    jobs = [fleet.FleetJob(f"j{i}", length=(16, 16, 16), n_steps=4,
                           params=(0.02 + 0.003 * i,), seed=i) for i in range(3)]
    bulk = fleet.GridBatch(jobs[0], 4, device=device)
    table = fleet.GridBatch(jobs[0], 4, device=device, bulk=False)
    for b in (bulk, table):
        for j in jobs:
            j.apply_init(b.grid)
            b.admit(j)
    budget = np.array([4, 4, 2, 0], np.int32)
    spec = roll_executor.make_fleet_bulk_step(
        bulk.grid, bulk.bulk_kernel, ("rho",), ("rho",), 1).spec
    ref = bulk.state["rho"].clone()
    extras = torch.as_tensor(bulk._extras, device=device)
    budget_dev = torch.as_tensor(budget, device=device)
    for i in range(4):
        ref = roll_executor.fleet_freeze(
            roll_executor.fleet_bulk_pass_plain(spec, bulk.bulk_kernel, ref,
                                                extras), ref, budget_dev, i)
    before = roll_executor.fleet_bulk_pass.launches
    bulk.step(budget)
    assert bulk.bulk_active() and not table.bulk_active()
    assert roll_executor.fleet_bulk_pass.launches == before + 4
    assert torch.equal(_bits(bulk.state["rho"]), _bits(ref))
    table.step(budget)
    np.testing.assert_array_equal(bulk.last_inv["fp_out"]["rho"],
                                  bulk.fingerprint_slots()["rho"])
    torch.testing.assert_close(bulk.state["rho"], table.state["rho"],
                               rtol=1e-5, atol=1e-6)
    jobs[2].n_steps = 2
    for slot in range(3):
        assert table.digest(slot) == fleet.run_solo(jobs[slot], device=device)
    assert bulk.finite_slots()[:3].all()


def test_refined_run_steps_on_the_card(device):
    """A 16^3 refined grid (bench/recommit_bench.py's two slab commits)
    and its table-path run_steps on the card against
    the same run on the CPU: plans bit for bit, densities to rtol 1e-6,
    atol 1e-7 (chip_smoke.py's AMR tolerance: the slot sums reduce in
    another order)."""
    from dccrg_tpu_torch.profiling import amr_diffuse, amr_slab_grid

    card, cpu = amr_slab_grid(16, device), amr_slab_grid(16, torch.device("cpu"))
    for name in ("cells", "row_of_pos"):
        np.testing.assert_array_equal(getattr(card.plan, name),
                                      getattr(cpu.plan, name))
    hc = card.plan.hoods[DEFAULT_NEIGHBORHOOD_ID]
    hp = cpu.plan.hoods[DEFAULT_NEIGHBORHOOD_ID]
    for name in ("nbr_rows", "nbr_mask", "scale_rows", "hard_rows",
                 "hard_nbr_rows", "hard_offs", "hard_mask"):
        np.testing.assert_array_equal(getattr(hc, name), getattr(hp, name))
    for g in (card, cpu):
        g.run_steps(amr_diffuse, ["density"], ["density"], 5)
        assert g.last_step_path == "table"
    torch.testing.assert_close(card.data["density"].cpu(), cpu.data["density"],
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_restart_on_the_card(device, tmp_path, dtype):
    """GridAdvection(16) on the card: 4 steps, an atomic checkpoint with
    its sidecar, a verified load from the file alone, 4 more steps on
    kernel A == 8 uninterrupted steps bit for bit; the file's bytes equal
    a CPU save of the same state."""
    from dccrg_tpu_torch import checkpoint, resilience

    a = GridAdvection(n=16, device=device, dtype=dtype)
    straight = GridAdvection(n=16, device=device, dtype=dtype)
    straight.grid.data = {n: t.clone() for n, t in a.grid.data.items()}
    dt = straight.run(8)
    a.run(4, dt)
    fn = str(tmp_path / "adv.dc")
    resilience.save_checkpoint(a.grid, fn, chunk_bytes=4096)
    assert resilience.verify_checkpoint(fn) == []
    assert all(ok for ok, _g, _w in resilience.audit_checkpoint(fn).values())
    cpu, _ = checkpoint.load_grid(fn, a.grid.fields, device="cpu")
    cpu.save_grid_data(str(tmp_path / "cpu.dc"))
    assert open(fn, "rb").read() == open(tmp_path / "cpu.dc", "rb").read()
    a.grid, _h, report = resilience.load_checkpoint(fn, a.grid.fields,
                                                    device=device)
    assert report.clean and a.grid.device.type == "cuda"
    before = roll_executor.bulk_pass.launches
    a.run(4, dt)
    assert a.grid.last_step_path == "bulk"
    assert roll_executor.bulk_pass.launches == before + 4
    assert checkpoint.state_digest(a.grid) == \
        checkpoint.state_digest(straight.grid)


@pytest.mark.parametrize("n, nz", [(32, 8), (24, 1)])
def test_dense_advection_on_the_card(device, n, nz):
    """The dense AdvectionSolver on the card against its CPU run: the
    same float32 operations, so rho agrees to rtol 1e-6, atol 1e-7;
    the CFL step, mass and L2 error likewise."""
    card = AdvectionSolver(n=n, nz=nz, device=device)
    cpu = AdvectionSolver(n=n, nz=nz, device="cpu")
    assert card.grid.arrays["rho"].device.type == "cuda"
    dt = 0.4 * cpu.max_time_step()
    assert np.isclose(card.max_time_step(), cpu.max_time_step(), rtol=1e-6)
    m0 = card.total_mass()
    for _ in range(10):
        card.step(dt)
        cpu.step(dt)
    np.testing.assert_allclose(card.grid.to_host("rho"),
                               cpu.grid.to_host("rho"), rtol=1e-6, atol=1e-7)
    assert abs(card.total_mass() - m0) < 1e-6 * m0
    assert abs(card.l2_error() - cpu.l2_error()) < 1e-7


def _exchange_grid(device_list, partition):
    g = (port.Grid(cell_data={"v": torch.float32, "w": torch.bfloat16})
         .set_initial_length((12, 10, 16)).set_periodic(True, False, True)
         .set_neighborhood_length(1)
         .initialize(device_list, partition=partition))
    cells = g.plan.cells
    g.set("v", cells, (cells % 97).astype(np.float32))
    g.set("w", cells, (cells % 13).astype(np.float32))
    return g


@pytest.mark.parametrize("partition", ["block", "morton"])
def test_partitioned_exchange_on_the_card(device, partition):
    """The halo exchange of four partitions on the card, sync and split:
    every partition's ghost rows equal its CPU twin's and hold their
    owners' values; the zero row stays zero."""
    got = _exchange_grid([device] * 4, partition)
    want = _exchange_grid(["cpu"] * 4, partition)
    for g in (got, want):
        g.update_copies_of_remote_neighbors(fields=["v"])
        g.start_remote_neighbor_copy_updates(fields=["w"])
        g.wait_remote_neighbor_copy_updates()
    for f in ("v", "w"):
        assert torch.equal(got.data[f].cpu(), want.data[f])
        assert float(got.data[f][:, -1].float().abs().sum()) == 0.0
    host = got.data["v"].cpu().numpy()
    for d in range(4):
        ghosts = got.plan.ghost_ids[d]
        np.testing.assert_array_equal(
            host[d, got.plan.L:got.plan.L + len(ghosts)],
            (ghosts % 97).astype(np.float32))


@pytest.mark.parametrize("overlap", ["0", "1"])
def test_partitioned_advection_on_the_card(device, overlap, monkeypatch):
    """``GridAdvection`` on four partitions of the card (the plain roll
    path with its fixups, no kernel) against the same run on the CPU
    and against one partition on the card (kernel A), with the overlap
    (side-stream sends) off and on: bit for bit."""
    monkeypatch.setenv("DCCRG_OVERLAP", overlap)
    four = GridAdvection(n=24, nz=32, device=[device] * 4)
    cpu = GridAdvection(n=24, nz=32, device=["cpu"] * 4)
    one = GridAdvection(n=24, nz=32, device=device)
    start = one.density()
    for g in (four, cpu):
        g.grid.set("density", g.grid.plan.cells, start)
        g.grid.update_copies_of_remote_neighbors(fields=["density"])
    dt = 0.5 * one.max_time_step()
    roll_executor.bulk_pass.launches = 0
    four.run(6, dt)
    assert roll_executor.bulk_pass.launches == 0
    assert four.grid.last_step_path == "roll"
    assert four.grid.last_overlap["mode"] == ("full" if overlap == "1"
                                              else "off")
    cpu.run(6, dt)
    one.run(6, dt)
    assert roll_executor.bulk_pass.launches == 6
    np.testing.assert_array_equal(four.density(), cpu.density())
    np.testing.assert_array_equal(four.density(), one.density())


def _refined_parts(device_list, n=32):
    """profiling.amr_slab_grid's deployment at n^3 (two slab commits)
    on ``device_list``'s partitions, ``block``."""
    from dccrg_tpu_torch.profiling import amr_slab_grid

    return amr_slab_grid(n, device_list, partition="block")


@pytest.mark.parametrize("overlap", ["0", "1"])
def test_refined_partitions_on_the_card(device, overlap, monkeypatch):
    """A 32^3 refined grid on three partitions of the card: its plans
    equal its CPU build's (ghost ids, far/easy and hard tables, pair
    tables) and 4 table-path steps, with the overlap off and on, equal
    one partition's run of the same grid on the card, bit for bit."""
    from dccrg_tpu_torch.profiling import amr_diffuse

    monkeypatch.setenv("DCCRG_OVERLAP", overlap)
    three = _refined_parts([device] * 3)
    cpu = _refined_parts(["cpu"] * 3)
    one = _refined_parts(device)
    pc, pg = cpu.plan, three.plan
    np.testing.assert_array_equal(pg.owner, pc.owner)
    assert (pg.L, pg.R) == (pc.L, pc.R)
    for d in range(3):
        np.testing.assert_array_equal(pg.local_ids[d], pc.local_ids[d])
        np.testing.assert_array_equal(pg.ghost_ids[d], pc.ghost_ids[d])
    hg, hc = pg.hoods[DEFAULT_NEIGHBORHOOD_ID], pc.hoods[DEFAULT_NEIGHBORHOOD_ID]
    for name in ("nbr_rows", "nbr_mask", "scale_rows", "hard_rows",
                 "hard_nbr_rows", "hard_offs", "hard_mask", "send_rows",
                 "recv_rows", "n_inner"):
        np.testing.assert_array_equal(getattr(hg, name), getattr(hc, name),
                                      err_msg=name)
    for g in (three, one):
        g.update_copies_of_remote_neighbors()
        g.run_steps(amr_diffuse, ["density"], ["density"], 4)
        assert g.last_step_path == "table"
    assert three.last_overlap["mode"] == ("off" if overlap == "0" else "full")
    cells = pg.cells
    np.testing.assert_array_equal(three.get("density", cells),
                                  one.get("density", cells))


@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 2, 2)])
def test_dense_mesh_on_the_card(device, shape):
    """AdvectionSolver and DensePoissonSolver on a mesh of blocks of the
    card: bit for bit with one block, the z split masked at the global
    index."""
    from dccrg_tpu_torch.dense import dense_mesh

    mesh = dense_mesh([device] * 4, shape)
    one = AdvectionSolver(n=32, nz=8, device=device)
    blocks = AdvectionSolver(n=32, nz=8, mesh=mesh)
    for s in (one, blocks):
        for f, v in (("vz", 0.3),):
            s.grid.arrays[f] = s.grid.arrays[f] * 0 + v
        s._vel_padded = tuple(s.grid.pad_with_halo(s.grid.arrays[f], 1)
                              for f in ("vx", "vy", "vz"))
        for _ in range(4):
            s.step(0.004)
    assert torch.equal(blocks.grid.arrays["rho"], one.grid.arrays["rho"])
    rhs = torch.rand((16, 16, 16), device=device, dtype=torch.float64)
    rhs = (rhs - rhs.mean()).to(torch.float32)
    per = (True, True, False)
    x1, i1 = DensePoissonSolver((16,) * 3, periodic=per, device=device).solve(rhs)
    xm, im = DensePoissonSolver((16,) * 3, periodic=per, mesh=mesh).solve(rhs)
    assert i1 == im and torch.equal(x1, xm)


def test_scheduler_serves_on_kernel_a_prime(device, tmp_path):
    """FleetScheduler on the card: the diffuse and advect_x buckets take
    kernel A' (bulk_active), kernel A' launches once for every step of
    each quantum (the largest budget), a NaN trip rolls its victim back,
    and the states agree with a table-program scheduler's within the
    bulk rule (rtol 1e-5, atol 1e-6)."""
    from dccrg_tpu_torch import faults
    from dccrg_tpu_torch.scheduler import FleetScheduler

    def jobs():
        return ([fleet.FleetJob(f"d{i}", length=(16, 16, 16), n_steps=10,
                                params=(0.02 + 0.005 * i,), seed=i,
                                checkpoint_every=4) for i in range(5)]
                + [fleet.FleetJob(f"x{i}", length=(16, 16, 16),
                                  kernel="advect_x", n_steps=7,
                                  params=(0.3,), seed=10 + i,
                                  checkpoint_every=4) for i in range(3)])

    states = {}
    for bulk in (True, False):
        sched = FleetScheduler(tmp_path / str(bulk), jobs(), quantum=4,
                               devices=[device], bulk=bulk)
        steps, states[bulk] = [], {}
        step = fleet.GridBatch.step
        finish = sched._finish

        def counted(self, budget, step=step, steps=steps):
            q = step(self, budget)
            steps.append(q)
            return q

        def keep(batch, slot, job, status="done", finish=finish, bulk=bulk):
            states[bulk][job.name] = batch.state["rho"][slot].clone()
            finish(batch, slot, job, status)

        sched._finish = keep
        plan = faults.FaultPlan(seed=1)
        plan.nan_poison("rho", step=5, job="d2")
        before = roll_executor.fleet_bulk_pass.launches
        fleet.GridBatch.step = counted
        try:
            with plan:
                report = sched.run()
        finally:
            fleet.GridBatch.step = step
        launches = roll_executor.fleet_bulk_pass.launches - before
        assert all(r["status"] == "done" for r in report.values())
        assert report["d2"]["rollbacks"] == 1
        assert all(b.bulk_active() is bulk
                   for bs in sched.buckets.values() for b in bs)
        assert launches == (sum(steps) if bulk else 0)
    for name, want in states[False].items():
        got = states[True][name]
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-6), name


@pytest.mark.parametrize("bulk", [True, False])
def test_prewarmed_program_matches_a_cold_build(device, tmp_path, bulk):
    """The warm pool on the card: a prewarm (kernel A''s library loaded,
    the program tuple built)
    allocates nothing on the card and launches nothing there, the table
    program's neighbour tables upload at its first dispatch, and the
    prewarmed program's quantum equals a cold build's bit for bit."""
    from dccrg_tpu_torch import autopilot, warmstart
    from dccrg_tpu_torch.ops import _build

    build_dir = _build.BUILD_DIR
    try:
        job = fleet.FleetJob("p", length=(32, 32, 32), n_steps=8, seed=3,
                             params=(0.05,))
        c = str(tmp_path / "cache")
        pool = warmstart.WarmPool(c, device=device, start_pool=False)
        warmstart.write_entry(c, autopilot.key_id((job.bucket_key(), 4)), {
            "key": warmstart.bucket_payload(job.bucket_key()),
            "capacity": 4, "integrity": True, "bulk": bulk, "hits": 1,
            "last_hit": 1.0, "compile_s": 1.0})
        pool._load()
        torch.cuda.synchronize()

        def allocations():
            # the caching allocator's count of allocations ever made
            return torch.cuda.memory_stats().get("allocation.all.allocated", 0)

        n0 = allocations()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            pool.prewarm(block=True)
            torch.cuda.synchronize()
        on_card = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert on_card == [] and allocations() == n0
        assert pool.errors == [] and len(pool._ready) == 1
        if bulk:
            # loaded (built into the cache's build/ unless this process
            # had loaded it already, as an earlier case may have)
            assert "fleet_bulk_pass" in _build._libs
        batch = fleet.GridBatch(job, 4, device, bulk=bulk)
        key = batch._program_key()
        warm = pool.take(key, device=device)
        assert warm is not None and warm[3] is bulk
        cold = batch._build_programs(key)
        gen = torch.Generator(device=device).manual_seed(5)
        state = {"rho": torch.rand((4, batch.R), generator=gen,
                                   device=device)}
        extras = torch.full((4, 1), 0.05, device=device)
        budget = torch.tensor([8, 3, 0, 5], dtype=torch.int32, device=device)
        before = roll_executor.fleet_bulk_pass.launches
        outs = [fn(dict(state), extras, budget, 8)
                for fn in (warm[0], cold[0])]
        launched = roll_executor.fleet_bulk_pass.launches - before
        assert launched == (16 if bulk else 0)
        assert torch.equal(outs[0][0]["rho"], outs[1][0]["rho"])
        for a, b in zip(outs[0][1], outs[1][1]):
            assert torch.equal(a, b)
        pool.close()
    finally:
        _build.set_build_dir(build_dir)
        warmstart.deactivate()
