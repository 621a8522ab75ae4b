"""The port's bulk executor (kernel A's plain version plus the fixup
epilogue) against the reference's Pallas bulk executor.

The reference runs ``GridAdvection`` under ``DCCRG_BULK=pallas`` on a
one-device mesh (Pallas in interpret mode on the CPU). The port's grid
is seeded from the same numpy state through ``convert.py`` and runs the
same steps; on CPU tensors its bulk pass is the plain PyTorch version of
kernel A. Inside the port, the bulk path's fixup rows must equal the
plain roll path's bit for bit, and ``last_step_path`` says which path
ran.
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


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("n", [16, 24])
def test_bulk_matches_reference_bulk_executor(n, k, monkeypatch):
    monkeypatch.setenv("DCCRG_BULK", "pallas")
    monkeypatch.setenv("DCCRG_BULK_SPP", str(k))
    ref = _seeded_reference(n, seed=n + k)
    p = GridAdvection(n=n, device="cpu")
    fields_from_numpy(p.grid, {f: np.asarray(ref.grid.data[f]) for f in FIELDS},
                      L=ref.grid.plan.L)
    dt = 0.5 * ref.max_time_step()
    n_steps = k + 1  # with k = 4: one 4-deep pass and one remainder pass
    ref.run(n_steps, dt)
    p.run(n_steps, dt)
    assert p.grid.last_step_path == "bulk"
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
    g = adv.grid
    hood = g.plan.hoods[port.DEFAULT_NEIGHBORHOOD_ID]
    spec = roll_executor._grid_spec_for(g, hood, k)
    return roll_executor.build_epilogue_sets(spec, hood.roll_plan(g.plan.L)[1])[-1][0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("periodic", [(True, True, False), (False, False, False)])
def test_bulk_fixup_rows_match_roll_path(periodic, k, dtype, monkeypatch):
    """One k-deep pass through the bulk executor against k steps of the
    plain roll path: the fixup rows bit for bit, every row to float32
    rounding."""
    monkeypatch.setenv("DCCRG_BULK_SPP", str(k))
    bulk, roll = _port_pair(16, periodic, dtype, seed=k)
    dt = 0.5 * bulk.max_time_step()
    before = roll_executor.bulk_pass.launches
    bulk.run(k, dt)
    roll.run(k, dt, bulk=False)
    assert bulk.grid.last_step_path == "bulk"
    assert roll.grid.last_step_path == "roll"
    # CPU tensors take the plain version: no kernel launch is counted
    assert roll_executor.bulk_pass.launches == before
    a = bulk.grid.data["density"][0].to(torch.float32).numpy()
    b = roll.grid.data["density"][0].to(torch.float32).numpy()
    rows = _fixup_rows(bulk, k)
    # fixups come from periodic wraps only: non-periodic edges are masked
    assert (len(rows) > 0) == any(periodic)
    np.testing.assert_array_equal(a[rows], b[rows])
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert bulk.grid.data["density"].dtype == dtype


def test_ineligible_kernel_takes_roll_path():
    """A SlotwiseKernel without a device flux, or fields of mixed
    storage dtypes, run through the plain roll path."""
    a = GridAdvection(n=16, device="cpu")
    k = make_uniform_flux_kernel((1 / 16, 1 / 16, 1 / 16))
    plain = port.SlotwiseKernel(k.init, k.slot, k.finish)
    dt = torch.tensor(0.5 * a.max_time_step(), dtype=torch.float32)
    a.grid.run_steps(plain, FIELDS, ["density"], 2, extra_args=(dt,))
    assert a.grid.last_step_path == "roll"
    a.grid.run_steps(a._kernel, FIELDS, ["density"], 2, extra_args=(dt,))
    assert a.grid.last_step_path == "bulk"
    g = (port.Grid(cell_data={"density": torch.float32, "vx": torch.bfloat16,
                              "vy": torch.float32})
         .set_initial_length((16, 16, 16)).set_periodic(True, True, False)
         .set_neighborhood_length(0).initialize("cpu"))
    g.run_steps(a._kernel, FIELDS, ["density"], 1, extra_args=(dt,))
    assert g.last_step_path == "roll"


def test_bulk_pass_rejects_other_devices():
    a = GridAdvection(n=16, device="cpu")
    g = a.grid
    spec = roll_executor._grid_spec_for(
        g, g.plan.hoods[port.DEFAULT_NEIGHBORHOOD_ID], 1)
    fields = {f: g.data[f][0, :g.plan.L].to("meta") for f in FIELDS}
    with pytest.raises(ValueError):
        roll_executor.bulk_pass(spec, a._kernel, fields,
                                (torch.tensor(0.01),))
