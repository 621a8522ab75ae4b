"""The port's bulk executor (kernel A's plain version, no fixup
epilogue) against the reference's Pallas bulk executor.

The reference runs ``GridAdvection`` under ``DCCRG_BULK=pallas`` on a
one-device mesh (Pallas in interpret mode on the CPU). The port's grid
is seeded from the same numpy state through ``convert.py`` and runs the
same steps; on CPU tensors its bulk pass is the plain PyTorch version of
kernel A. Inside the port, the bulk path must equal the plain roll path
bit for bit on every row, the wrap rows the reference's epilogue
repairs included, and ``last_step_path`` says which path ran.
"""

import numpy as np
import pytest
import torch

import jax

from dccrg_tpu.grid import default_mesh
from dccrg_tpu.models.advection import GridAdvection as RefAdvection

import dccrg_tpu_torch as port
from dccrg_tpu_torch.convert import fields_from_numpy, fields_to_numpy
from dccrg_tpu_torch.models.advection import (GridAdvection,
                                              make_uniform_flux_kernel)
from dccrg_tpu_torch.ops import roll_executor

FIELDS = ("density", "vx", "vy")


def _seeded_reference(n, seed):
    """A reference GridAdvection whose density is seeded noise on the
    local rows (zero on pad rows and the zero row)."""
    ref = RefAdvection(n=n, mesh=default_mesh(jax.devices()[:1]))
    g = ref.grid
    rng = np.random.default_rng(seed)
    rho = np.zeros((1, g.plan.R), np.float32)
    rho[0, :n ** 3] = rng.random(n ** 3, dtype=np.float32)
    g.data["density"] = jax.device_put(rho, g.data["density"].sharding)
    return ref


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [16, 24])
def test_bulk_matches_reference_bulk_executor(n, k, monkeypatch):
    """The reference's k-deep Pallas passes (``DCCRG_BULK_SPP``) and its
    epilogue against the port's k-deep passes under the same variable
    (their plain version on the CPU), one k-deep pass and one remainder
    pass each."""
    monkeypatch.setenv("DCCRG_BULK", "pallas")
    monkeypatch.setenv("DCCRG_BULK_SPP", str(k))
    ref = _seeded_reference(n, seed=n + k)
    p = GridAdvection(n=n, device="cpu")
    fields_from_numpy(p.grid, {f: np.asarray(ref.grid.data[f]) for f in FIELDS},
                      L=ref.grid.plan.L)
    dt = 0.5 * ref.max_time_step()
    n_steps = k + 1  # one k-deep pass and one remainder pass
    ref.run(n_steps, dt)
    p.run(n_steps, dt)
    assert p.grid.last_step_path == "bulk"
    assert roll_executor.bulk_steps_per_pass() == k
    want = np.asarray(ref.grid.data["density"])
    got = fields_to_numpy(p.grid)["density"]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # pad rows keep their value, the zero row stays zero
    assert np.all(got[0, n ** 3:] == 0)


def _port_pair(n, periodic, dtype, seed):
    grids = []
    rng = np.random.default_rng(seed)
    rho = rng.random(n ** 3, dtype=np.float32)
    for _ in range(2):
        a = GridAdvection(n=n, device="cpu", periodic=periodic, dtype=dtype)
        a.grid.data["density"][0, :n ** 3] = torch.from_numpy(rho).to(dtype)
        grids.append(a)
    return grids


def _fixup_rows(adv, k):
    """The rows the reference's epilogue repairs after k steps."""
    g = adv.grid
    hood = g.plan.hoods[port.DEFAULT_NEIGHBORHOOD_ID]
    spec = roll_executor._grid_spec_for(g, hood)
    return roll_executor.build_epilogue_sets(
        spec, hood.roll_plan(g.plan.L)[1], k)[-1][0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("periodic", [(True, True, False), (True, True, True),
                                      (False, False, False)])
def test_bulk_fixup_rows_match_roll_path(periodic, k, dtype):
    """The epilogue-free bulk executor against the plain roll path: k
    steps, then k + 1 more, bit for bit on every row, the wrap rows the
    reference's epilogue repairs after k steps included."""
    bulk, roll = _port_pair(16, periodic, dtype, seed=k)
    dt = 0.5 * bulk.max_time_step()
    before = roll_executor.bulk_pass.launches
    bulk.run(k, dt)
    roll.run(k, dt, bulk=False)
    assert bulk.grid.last_step_path == "bulk"
    assert roll.grid.last_step_path == "roll"
    # CPU tensors take the plain version: no kernel launch is counted
    assert roll_executor.bulk_pass.launches == before
    a, b = bulk.grid.data["density"][0], roll.grid.data["density"][0]
    rows = torch.as_tensor(_fixup_rows(bulk, k).astype(np.int64))
    # wrap rows come from periodic wraps only: non-periodic edges are masked
    assert (len(rows) > 0) == any(periodic)
    assert torch.equal(a[rows], b[rows])
    assert torch.equal(a, b)
    bulk.run(k + 1, dt)
    roll.run(k + 1, dt, bulk=False)
    assert torch.equal(bulk.grid.data["density"], roll.grid.data["density"])
    assert bulk.grid.data["density"].dtype == dtype


def _hood_grid(dims, periodic, hood_len, dtype, seed):
    """A grid with the advection fields, seeded density and velocities
    of both signs, and the upwind flux kernel for it."""
    g = (port.Grid(cell_data={f: torch.float32 for f in FIELDS}, dtype=dtype)
         .set_initial_length(dims).set_periodic(*periodic)
         .set_maximum_refinement_level(0).set_neighborhood_length(hood_len)
         .initialize("cpu"))
    n0 = int(np.prod(dims))
    rng = np.random.default_rng(seed)
    for f, shift in (("density", 0.0), ("vx", 0.5), ("vy", 0.5)):
        v = rng.random(n0, dtype=np.float32) - np.float32(shift)
        g.data[f][0, :n0] = torch.from_numpy(v).to(dtype)
    return g, make_uniform_flux_kernel(tuple(1.0 / d for d in dims))


# a user neighbourhood with reach 2 in y and z: kernel A's direct route
REACH2_HOOD = [(1, 2, 0), (-1, -2, 0), (1, 0, 2), (-1, 0, -2), (0, 1, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hood", ["cube", "reach2"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("periodic", [(True, True, True), (False, True, False)])
def test_bulk_matches_roll_path_with_z_reach(periodic, k, hood, dtype):
    """Neighbourhoods with z reach through the bulk executor (kernel A's
    direct route) against the roll path, bit for bit after k + 1 steps:
    the 26-cube and a user neighbourhood of reach 2."""
    dims = (12, 10, 6)
    hood_len, hood_id = (1, port.DEFAULT_NEIGHBORHOOD_ID) if hood == "cube" \
        else (2, 7)
    grids = [_hood_grid(dims, periodic, hood_len, dtype, seed=3)[0]
             for _ in range(2)]
    if hood == "reach2":
        for g in grids:
            assert g.add_neighborhood(hood_id, REACH2_HOOD)
    kern = make_uniform_flux_kernel(tuple(1.0 / d for d in dims))
    spec = roll_executor._grid_spec_for(grids[0], grids[0].plan.hoods[hood_id])
    assert not spec.face4 and spec.tile == (32, 8, 1)
    dt = torch.tensor(0.01, dtype=torch.float32)
    grids[0].run_steps(kern, FIELDS, ["density"], k + 1, extra_args=(dt,),
                       neighborhood_id=hood_id)
    grids[1].run_steps(kern, FIELDS, ["density"], k + 1, extra_args=(dt,),
                       neighborhood_id=hood_id, bulk=False)
    assert grids[0].last_step_path == "bulk"
    assert grids[1].last_step_path == "roll"
    assert torch.equal(grids[0].data["density"], grids[1].data["density"])
    assert grids[0].data["density"].dtype == dtype


def test_ineligible_kernel_takes_roll_path():
    """A SlotwiseKernel the flux generator declines (here its slot
    function sums over the cells) runs through the plain roll path. A
    SlotwiseKernel without a device flux, and the named flux over fields
    of mixed storage dtypes, are lowered from their slot functions and
    take the bulk path, bit for bit with the plain roll path."""
    a = GridAdvection(n=16, device="cpu")
    k = make_uniform_flux_kernel((1 / 16, 1 / 16, 1 / 16))
    dt = torch.tensor(0.5 * a.max_time_step(), dtype=torch.float32)

    def reducing(acc, cell, nbr, offs, mask, dt):
        return k.slot(acc, cell, nbr, offs, mask, dt) - nbr["density"].mean()

    declined = port.SlotwiseKernel(k.init, reducing, k.finish)
    a.grid.run_steps(declined, FIELDS, ["density"], 2, extra_args=(dt,))
    assert a.grid.last_step_path == "roll"
    plain = port.SlotwiseKernel(k.init, k.slot, k.finish)
    init = a.grid.data["density"].clone()
    a.grid.run_steps(plain, FIELDS, ["density"], 2, extra_args=(dt,))
    assert a.grid.last_step_path == "bulk"
    got = a.grid.data["density"].clone()
    a.grid.data["density"] = init.clone()
    a.grid.run_steps(a._kernel, FIELDS, ["density"], 2, extra_args=(dt,))
    assert a.grid.last_step_path == "bulk"
    assert torch.equal(got, a.grid.data["density"])
    g = (port.Grid(cell_data={"density": torch.float32, "vx": torch.bfloat16,
                              "vy": torch.float32})
         .set_initial_length((16, 16, 16)).set_periodic(True, True, False)
         .set_neighborhood_length(0).initialize("cpu"))
    g.data["vx"][0, :16 ** 3] = torch.linspace(-1, 1, 16 ** 3).to(
        torch.bfloat16)
    g.data["density"][0, :16 ** 3] = torch.linspace(0, 1, 16 ** 3)
    want = {f: t.clone() for f, t in g.data.items()}
    g.run_steps(a._kernel, FIELDS, ["density"], 2, extra_args=(dt,))
    assert g.last_step_path == "bulk"
    got = g.data["density"].clone()
    g.data.update(want)
    g.run_steps(a._kernel, FIELDS, ["density"], 2, extra_args=(dt,),
                bulk=False)
    assert g.last_step_path == "roll"
    assert torch.equal(got, g.data["density"])


def test_bulk_pass_rejects_other_devices():
    a = GridAdvection(n=16, device="cpu")
    g = a.grid
    spec = roll_executor._grid_spec_for(
        g, g.plan.hoods[port.DEFAULT_NEIGHBORHOOD_ID])
    fields = {f: g.data[f][0, :g.plan.L].to("meta") for f in FIELDS}
    with pytest.raises(ValueError):
        roll_executor.bulk_pass(spec, a._kernel, fields,
                                (torch.tensor(0.01),))
