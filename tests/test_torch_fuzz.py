"""The port's seeded fuzzers (dccrg_tpu_torch.fuzz) against the
reference's, on the CPU.

A port ``GridFuzzer`` draws the reference's op trail for a seed: the
same ``default_rng`` calls in the same order over the same cell lists,
so the logs (op, cell, detail, fault site) are equal, and so are the
final cell sets; the final ``rho`` agrees within the refined-plan
tolerance, ``rtol 1e-6, atol 1e-6`` of the peak (the port's step sums
the neighbour slots in its own order). Then tests/test_fuzz_mutations.py
on the port alone (seeded runs, fault injection, determinism, the
planted break and the planted corruption), the MHD-schema leg of
tests/test_models.py, the fleet-isolation scenario with a NaN and with
a silent flip, held to the port's own ``run_solo`` (bit for bit on the
table program, within ``fuzz.BULK_TOL`` of the peak on kernel A''s
plain version), and one distributed-AMR scenario. The reference's own
fleet fuzz tests fail on its ``advect_x`` batch-versus-solo gap, so the
fleet cases are held to the port's own oracle, not to the reference's
run.
"""

import numpy as np
import pytest

import jax

from dccrg_tpu import fuzz as r_fuzz
from dccrg_tpu_torch import fuzz as p_fuzz
from dccrg_tpu_torch.grid import DEFAULT_NEIGHBORHOOD_ID

pytestmark = pytest.mark.fuzz


def _rho(fz):
    cells = fz.grid.get_cells()
    return np.asarray(cells), np.asarray(fz.grid.get("rho", cells),
                                         dtype=np.float64)


@pytest.mark.parametrize("seed,ops,fault_rate,schema", [
    (0, 40, 0.0, "scalar"), (1, 40, 0.6, "scalar"), (11, 12, 0.3, "mhd")])
def test_op_trail_equals_the_reference(seed, ops, fault_rate, schema):
    ref = r_fuzz.GridFuzzer(seed, ops=ops, fault_rate=fault_rate,
                            schema=schema, devices=jax.devices()[:2]).run()
    port = p_fuzz.GridFuzzer(seed, ops=ops, fault_rate=fault_rate,
                             schema=schema, devices="cpu").run()
    assert port.log == ref.log
    assert port.faults_injected == ref.faults_injected
    assert port.ops_run == ref.ops_run == ops
    r_cells, r_rho = _rho(ref)
    p_cells, p_rho = _rho(port)
    assert np.array_equal(p_cells, r_cells)
    peak = float(np.abs(r_rho).max())
    np.testing.assert_allclose(p_rho, r_rho, rtol=1e-6, atol=1e-6 * peak)


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_seeded(seed):
    fz = p_fuzz.GridFuzzer(seed, ops=40, devices="cpu").run()
    assert fz.ops_run == 40


@pytest.mark.parametrize("seed", range(5))
def test_fuzz_fault_injecting(seed):
    """Mutations aborted mid-flight at random fault points roll back
    bit for bit and commit on retry (asserted inside the fuzzer)."""
    fz = p_fuzz.GridFuzzer(seed, ops=25, fault_rate=0.6, devices="cpu").run()
    assert fz.ops_run == 25


def test_fuzz_deeper_amr_and_devices():
    fz = p_fuzz.GridFuzzer(7, ops=30, length=(4, 4, 4), max_lvl=2, n_dev=4,
                           devices="cpu").run()
    assert fz.ops_run == 30 and len(fz.devices) == 4


def test_fuzz_is_deterministic():
    a = p_fuzz.GridFuzzer(11, ops=15, devices="cpu").run()
    b = p_fuzz.GridFuzzer(11, ops=15, devices="cpu").run()
    assert a.log == b.log


def test_planted_invariant_break_is_caught(monkeypatch):
    fz = p_fuzz.GridFuzzer(3, ops=5, devices="cpu").run()
    nl = fz.grid.plan.hoods[DEFAULT_NEIGHBORHOOD_ID].lists
    corrupted = nl.of_neighbor.copy()
    corrupted[0] = corrupted[1]
    monkeypatch.setattr(nl, "of_neighbor", corrupted)
    with pytest.raises(p_fuzz.FuzzFailure) as ei:
        fz._check(99)
    assert ei.value.cells, "failure must name cells"
    assert ei.value.seed == 3 and ei.value.op_index == 99
    assert "cells" in str(ei.value)


def test_planted_data_corruption_is_caught():
    fz = p_fuzz.GridFuzzer(4, ops=5, devices="cpu").run()
    victim = int(fz.grid.get_cells()[0])
    fz.grid.set("rho", [victim], np.asarray([123.0], dtype=np.float32))
    with pytest.raises(p_fuzz.FuzzFailure) as ei:
        fz._check(99)
    assert victim in ei.value.cells


def test_mhd_schema_fuzz_leg():
    fz = p_fuzz.GridFuzzer(11, ops=12, schema="mhd", fault_rate=0.3,
                           devices="cpu").run()
    assert fz.ops_run == 12 and fz.schema == "mhd"


@pytest.mark.parametrize("fault,seed", [("nan", 0), ("flip", 1)])
@pytest.mark.parametrize("bulk", [False, True])
def test_fleet_isolation_case(fault, seed, bulk):
    out = p_fuzz.fleet_isolation_case(seed, fault=fault, device="cpu",
                                      bulk=bulk)
    assert out["trips"] >= 1 and out["bulk"] is bulk
    if fault == "flip":
        assert out["report"][out["victim"]]["sdc_trips"] >= 1


def test_fleet_isolation_case_catches_a_wrong_oracle(monkeypatch):
    """The isolation oracle really compares: a solo run one step short
    fails the scenario."""
    from dccrg_tpu_torch import fleet

    real = fleet.run_solo

    def short(job, device=None):
        job.n_steps -= 1
        return real(job, device)

    monkeypatch.setattr(fleet, "run_solo", short)
    with pytest.raises(p_fuzz.FuzzFailure, match="differs from its solo"):
        p_fuzz.fleet_isolation_case(0, fault="nan", device="cpu", bulk=False)


def test_dist_amr_case():
    out = p_fuzz.dist_amr_case(0, device="cpu")
    assert out["commits"] >= 1 and out["aborts"] >= 1


def test_cli_runs_on_the_cpu(capsys):
    assert p_fuzz._main(["--seed", "2", "--ops", "6", "--device", "cpu"]) == 0
    assert "OK 1 seed(s) x 6 ops" in capsys.readouterr().out
    assert p_fuzz._main(["--fleet", "1", "--device", "cpu"]) == 0
    assert "OK 1 fleet seed(s)" in capsys.readouterr().out


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(8))
def test_fuzz_long_runs(seed):
    fz = p_fuzz.GridFuzzer(seed, ops=200, length=(4, 4, 4), max_lvl=2,
                           n_dev=4, fault_rate=0.25, devices="cpu").run()
    assert fz.ops_run == 200
