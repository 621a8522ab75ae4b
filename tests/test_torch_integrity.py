"""The port's integrity layer against the reference, on the CPU.

Fingerprints are exact integer sums, so the port's host and device
fingerprints equal the reference's on equal bytes bit for bit, and a
port batch's in-quantum fingerprints equal a reference batch's on the
same admitted state. The conservation registry and its tolerance are
the reference's.
"""

import ml_dtypes
import numpy as np
import pytest

import jax.numpy as jnp

from dccrg_tpu import fleet as ref_fleet
from dccrg_tpu import integrity as ref

import torch

from dccrg_tpu_torch import fleet as port_fleet
from dccrg_tpu_torch import integrity as port
from dccrg_tpu_torch import resilience


def _rows(kind, n=1000, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "f32":
        return (rng.random(n) * 100).astype(np.float32)
    if kind == "f32x3":
        return rng.standard_normal((n, 3)).astype(np.float32)
    if kind == "int32":
        return rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int32)
    if kind == "u8x3":
        return rng.integers(0, 255, (n, 3), dtype=np.uint8)
    return (rng.random(n) * 100).astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("kind", ["f32", "f32x3", "int32", "u8x3", "bf16"])
def test_fingerprint_rows_matches_reference(kind):
    a = _rows(kind)
    assert port.fingerprint_rows(a) == ref.fingerprint_rows(a)
    assert port.fingerprint_rows(a[::-1]) == port.fingerprint_rows(a)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int32"])
def test_device_fingerprint_matches_rows(kind):
    """device_fingerprint equals fingerprint_rows on the owned rows for
    32-bit types and scalar bfloat16, and the reference's
    device_fingerprint."""
    a = _rows(kind, n=4097, seed=5)
    t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
         if kind == "bf16" else torch.from_numpy(a))
    got = tuple(int(v) for v in port.device_fingerprint(t, 4000))
    assert got == port.fingerprint_rows(a[:4000])
    want = tuple(int(v) for v in np.asarray(ref.device_fingerprint(jnp.asarray(a), 4000)))
    assert got == want
    batched = port.slot_fingerprints(torch.stack([t, t.flip(0)]), 4000)
    assert tuple(int(v) for v in batched[0]) == got
    with pytest.raises(TypeError):
        port.device_fingerprint(torch.zeros(4, dtype=torch.float64), 4)


def test_conservation_registry_and_knobs(monkeypatch):
    for kernel, periodic in (("diffuse", (False, False, False)),
                             ("advect_x", (True, False, False)),
                             ("advect_x", (False, True, True)),
                             ("other", (True,) * 3), (len, (True,) * 3)):
        assert port.conserved_fields(kernel, periodic, ("rho",)) == \
            ref.conserved_fields(kernel, periodic, ("rho",))
    port.register_conserved("twofield", ("a", "b"), periodic_axes=(1,))
    assert port.conserved_fields("twofield", (False, True, False), ("b",)) == ("b",)
    assert port.sum_tolerance(1e4, 4096, 8) == ref.sum_tolerance(1e4, 4096, 8)
    for name, value in (("DCCRG_INTEGRITY_RTOL", "1e-3"), ("DCCRG_INTEGRITY", "off")):
        monkeypatch.setenv(name, value)
    assert port.integrity_rtol() == ref.integrity_rtol() == 1e-3
    assert port.integrity_enabled() is ref.integrity_enabled() is False
    err = port.IntegrityError("corrupt", {"fp": "s1 moved"})
    assert isinstance(err, resilience.ResilienceExhaustedError)
    assert isinstance(err, RuntimeError) and err.details == {"fp": "s1 moved"}


def _both_batches(dtype, monkeypatch, kernel="diffuse"):
    monkeypatch.delenv("DCCRG_BULK", raising=False)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    out = []
    for mod, dt, kw in ((ref_fleet, jdt, {}), (port_fleet, tdt, {"device": "cpu"})):
        jobs = [mod.FleetJob(f"j{i}", length=(8, 8, 8), kernel=kernel,
                             params=(0.03,), seed=60 + i, cell_data={"rho": dt})
                for i in range(3)]
        b = mod.GridBatch(jobs[0], 4, **kw)
        for j in jobs:
            j.apply_init(b.grid)
            b.admit(j)
        out.append(b)
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantum_invariants_match_reference(dtype, monkeypatch):
    """On equal admitted state the port's in-quantum input fingerprints
    equal the reference's; the output fingerprints equal
    fingerprint_slots; the conservation sums hold within
    sum_tolerance (diffuse conserves rho on a periodic grid)."""
    rb, pb = _both_batches(dtype, monkeypatch)
    budget = np.array([3, 3, 1, 0], np.int32)
    rb.step(budget)
    pb.step(budget)
    np.testing.assert_array_equal(pb.last_inv["fp_in"]["rho"],
                                  np.asarray(rb.last_inv["fp_in"]["rho"]))
    assert pb.last_inv["fp_out"]["rho"].dtype == np.uint32
    np.testing.assert_array_equal(pb.last_inv["fp_out"]["rho"],
                                  pb.fingerprint_slots()["rho"])
    np.testing.assert_allclose(pb.last_inv["cs_in"]["rho"],
                               np.asarray(rb.last_inv["cs_in"]["rho"]), rtol=1e-6)
    cs_in, cs_out = pb.last_inv["cs_in"]["rho"], pb.last_inv["cs_out"]["rho"]
    for s in range(3):
        assert abs(cs_out[s] - cs_in[s]) <= port.sum_tolerance(cs_in[s], pb.L, 3)
    assert pb.slot_fingerprint(3) == {"rho": (0, pb.L)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flip_changes_only_that_slots_fingerprint(dtype, monkeypatch):
    _rb, pb = _both_batches(dtype, monkeypatch)
    before = pb.fingerprint_slots()["rho"]
    pb.flip(1, "rho", [7], bit=3)
    after = pb.fingerprint_slots()["rho"]
    assert (after[1] != before[1]).any()
    np.testing.assert_array_equal(np.delete(after, 1, 0), np.delete(before, 1, 0))
    assert pb.finite_slots().all()
    # an exponent flip that would land inf takes a finite value instead
    pb.flip(0, "rho", [5], bit=14 if dtype == "bf16" else 30)
    assert pb.finite_slots().all()


def test_integrity_off_runs_no_invariants(monkeypatch):
    _rb, pb = _both_batches("f32", monkeypatch)
    monkeypatch.setenv("DCCRG_INTEGRITY", "0")
    pb.step(np.array([2, 2, 2, 0], np.int32))
    assert pb.last_inv is None
    with pytest.raises(RuntimeError, match="DCCRG_INTEGRITY"):
        pb.fingerprint_slots()
    monkeypatch.delenv("DCCRG_INTEGRITY")
    pb.step(np.array([1, 0, 0, 0], np.int32))
    assert set(pb.last_inv) == {"fp_in", "fp_out", "cs_in", "cs_out"}
