"""The port's scalability harness (models/scalability.py) and
utils/profiling.py against the reference, on the CPU:
tests/test_scalability.py's cases on both packages. The halo byte count
equals the reference's. The payload after a step holds to the
reference's at ``rtol 1e-5, atol 1e-6`` (the reference test's own
tolerance across device counts): the port runs each ``v * a + b`` of
the work chain as two rounded operations where XLA may contract it into
one fused multiply-add, and sums the gathered neighbours in another
order.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from dccrg_tpu.models.scalability import ScalabilityModel as RefModel
from dccrg_tpu.utils.profiling import halo_bytes_per_update as ref_halo_bytes

from dccrg_tpu_torch.models.scalability import ScalabilityModel, run_sweep
from dccrg_tpu_torch.utils.profiling import (PhaseTimer, device_sync,
                                             halo_bytes_per_update)

TOL = dict(rtol=1e-5, atol=1e-6)


def mesh_of(n):
    return Mesh(np.array(jax.devices()[:n]), ("dev",))


def test_model_runs_and_reports():
    model = ScalabilityModel((8, 8, 8), floats_per_cell=4, work_iters=8,
                             device=["cpu"] * 4)
    rep = model.run(steps=3, warmup=1)
    assert rep["n_devices"] == 4
    assert rep["n_cells"] == 512
    assert rep["solve_s_per_step"] > 0
    assert rep["halo_s_per_step"] > 0
    assert rep["cell_updates_per_sec"] > 0
    assert rep["halo_bytes_per_step"] == \
        16 * model.grid.get_number_of_update_receive_cells()


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_halo_bytes_equal_reference(n_dev):
    p = ScalabilityModel((8, 8, 8), floats_per_cell=4, work_iters=1,
                         device=["cpu"] * n_dev)
    r = RefModel((8, 8, 8), floats_per_cell=4, work_iters=1,
                 mesh=mesh_of(n_dev))
    assert halo_bytes_per_update(p.grid) == ref_halo_bytes(r.grid)
    assert halo_bytes_per_update(p.grid, fields=[]) == 0


@pytest.mark.parametrize("n_dev", [1, 4])
def test_step_matches_reference(n_dev):
    p = ScalabilityModel((4, 4, 4), floats_per_cell=2, work_iters=16,
                         device=["cpu"] * n_dev)
    r = RefModel((4, 4, 4), floats_per_cell=2, work_iters=16,
                 mesh=mesh_of(n_dev))
    cells = p.grid.get_cells()
    assert (np.asarray(r.grid.get("payload", cells)).tobytes()
            == p.grid.get("payload", cells).tobytes())
    for _ in range(2):
        p.step()
        r.step()
    np.testing.assert_allclose(p.grid.get("payload", cells),
                               np.asarray(r.grid.get("payload", cells)), **TOL)


def test_solve_preserves_determinism():
    """The same step on 1 and 8 partitions (the reference requires
    any-process-count equivalence, tests/README:5-6)."""
    out = []
    for n in (1, 8):
        m = ScalabilityModel((4, 4, 4), floats_per_cell=2, work_iters=4,
                             device=["cpu"] * n)
        m.step()
        out.append(m.grid.get("payload", m.grid.get_cells()))
    np.testing.assert_allclose(out[0], out[1], **TOL)


def test_sweep_driver():
    rows = run_sweep(device_counts=[1, 2], length=(4, 4, 4),
                     floats_per_cell=2, work_iters=2, steps=2, device="cpu")
    assert [r["n_devices"] for r in rows] == [1, 2]
    weak = run_sweep(device_counts=[1, 2], length=(4, 4, 4),
                     floats_per_cell=2, work_iters=2, steps=2, weak=True,
                     device="cpu")
    assert weak[1]["n_cells"] == 2 * weak[0]["n_cells"]


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("solve"):
        sum(range(1000))
    with t.phase("solve"):
        pass
    rep = t.report()
    assert rep["solve"]["count"] == 2
    assert rep["solve"]["total"] >= 0
    assert "solve" in repr(t)
    t.reset()
    assert t.report() == {}
    assert device_sync("cpu") is None
