"""The slice end to end: the port's ``GridAdvection`` against the
reference's, seeded from the reference's state through ``convert.py``.

The reference steps through its default XLA roll path; the port, on CPU
tensors, through its bulk executor with the plain version of kernel A.
After 8 steps the density is bit for bit the reference's, in float32
and in bfloat16 storage alike (the same float32 arithmetic in the same
order, rounded to the storage type at the same points); ``checksum()``
and ``l2_error()`` agree to ``1e-5`` relative, since their sums may be
taken in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dccrg_tpu.grid import default_mesh
from dccrg_tpu.models.advection import GridAdvection as RefAdvection

from dccrg_tpu_torch.convert import fields_from_numpy, fields_to_numpy
from dccrg_tpu_torch.models.advection import GridAdvection

FIELDS = ("density", "vx", "vy")
N, STEPS = 24, 8


@pytest.fixture(params=["float32", "bfloat16"])
def pair(request, monkeypatch):
    monkeypatch.delenv("DCCRG_BULK", raising=False)
    monkeypatch.delenv("DCCRG_BULK_SPP", raising=False)
    name = request.param
    ref = RefAdvection(n=N, mesh=default_mesh(jax.devices()[:1]),
                       dtype=getattr(jnp, name))
    p = GridAdvection(n=N, device="cpu", dtype=getattr(torch, name))
    fields_from_numpy(p.grid, {f: np.asarray(ref.grid.data[f]) for f in FIELDS},
                      L=ref.grid.plan.L)
    return name, ref, p


def test_grid_advection_matches_reference(pair):
    name, ref, p = pair
    dt = 0.5 * ref.max_time_step()
    assert p.max_time_step() == ref.max_time_step()
    ref.run(STEPS, dt)
    p.run(STEPS, dt)
    assert p.grid.last_step_path == "bulk"
    assert p.time == ref.time
    want = np.asarray(ref.grid.data["density"]).astype(np.float32)
    got = fields_to_numpy(p.grid)["density"].astype(np.float32)
    assert got.shape == want.shape == (1, p.grid.plan.R)
    np.testing.assert_array_equal(got, want, err_msg=name)
    rel = 1e-5
    assert abs(p.checksum() - ref.checksum()) <= rel * abs(ref.checksum())
    assert abs(p.l2_error() - ref.l2_error()) <= rel * ref.l2_error()
    np.testing.assert_array_equal(p.density(), np.asarray(ref.density(),
                                                          dtype=np.float32))


def test_fields_round_trip(pair):
    _name, ref, p = pair
    back = fields_to_numpy(p.grid)
    for f in FIELDS:
        a = np.asarray(ref.grid.data[f])
        assert back[f].dtype == a.dtype
        np.testing.assert_array_equal(back[f].view(np.uint8), a.view(np.uint8))
    with pytest.raises(ValueError):
        fields_from_numpy(p.grid, {"density": back["density"]}, L=p.grid.plan.L + 1)
    with pytest.raises(ValueError):
        fields_from_numpy(p.grid, {"density": back["density"][:, :-1]})
    with pytest.raises(TypeError):
        fields_from_numpy(p.grid, {"density": back["density"].astype(np.float64)})


def test_mass_conservation():
    """Periodic in x and y, no flux through z: the upwind update moves
    mass between cells and loses none."""
    a = GridAdvection(n=16, device="cpu")
    m0 = a.checksum()
    a.run(12)
    m1 = a.checksum()
    assert abs(m1 - m0) <= 1e-5 * m0
    assert a.l2_error() < 0.05


def test_get_set_and_row_layout():
    a = GridAdvection(n=24, device="cpu")
    g = a.grid
    n0 = 24 ** 3
    assert (g.n_dev, g.plan.L, g.plan.R) == (1, 14336, 14337)
    assert g.data["density"].shape == (1, g.plan.R)
    ids = np.array([1, 2, 25, n0], dtype=np.uint64)
    g.set("density", ids, np.array([1.0, 2.0, 3.0, 4.0], np.float32))
    np.testing.assert_array_equal(g.get("density", ids), [1, 2, 3, 4])
    # rows are grid order, x fastest: cell id - 1 is the row
    assert float(g.data["density"][0, 24]) == 3.0
    rid = g.device_row_ids()[0]
    assert int(rid[n0 - 1]) == n0 - 1 and int(rid[n0]) == -1
    mask = g.local_row_mask()[0]
    assert float(mask.sum()) == n0


def test_device_selection():
    """Entry points run on the card unless the caller asks for the CPU;
    without a card that is an error, never a silent fallback. One device
    only in this slice."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError):
        GridAdvection(n=16)
    from dccrg_tpu_torch.models.advection import CudaRotationAdvection
    with pytest.raises(RuntimeError):
        CudaRotationAdvection(n=16, nz=16)


def test_single_device_only():
    """A list naming ``meta`` is refused; one naming distinct devices of
    this process places each partition on its own (item 5b.1b, the
    storage one group per device)."""
    from dccrg_tpu_torch import Grid

    g = Grid(cell_data={"rho": torch.float32}).set_initial_length((4, 4, 4))
    with pytest.raises(ValueError, match="meta"):
        g.initialize(["cpu", "meta"])
    g.initialize(["cpu:0", "cpu:1"])
    assert len(g._groups) == 2 and len(g.data["rho"].groups) == 2
