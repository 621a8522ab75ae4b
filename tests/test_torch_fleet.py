"""The port's fleet execution layer against the reference, on the CPU.

Both packages get the same jobs; the reference runs on one device (its
``template_grid`` builds a one-device mesh). Fresh seeded inits digest
equal in both. The port's ``run_solo`` and its table program hold to
the reference within a stated tolerance: values lie in [0, 100] and the
reference's own solo and batch runs of ``advect_x`` differ by up to
2.3e-5 (about 3 float32 ulps), so the tolerance is ``rtol 1e-6, atol
1e-4`` in float32. Inside the port the table program equals
``run_solo`` bit for bit (digests), in float32 and bfloat16. The bulk
program's plain kernel A' holds to the reference's Pallas bulk step in
interpret mode, and to the port's own table program by the rule of
tests/test_bulk_executor.py:273-278.
"""

import ml_dtypes
import numpy as np
import pytest

import jax.numpy as jnp

from dccrg_tpu import checkpoint as ref_ckpt
from dccrg_tpu import fleet as ref

import torch

from dccrg_tpu_torch import checkpoint as port_ckpt
from dccrg_tpu_torch import convert
from dccrg_tpu_torch import fleet as port
from dccrg_tpu_torch.ops import roll_executor

F32_TOL = dict(rtol=1e-6, atol=1e-4)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _jobs(module, tag, count=3, length=(8, 8, 8), kernel="diffuse", steps=5,
          periodic=(True, True, True), dtype="f32"):
    jdt, tdt = DTYPES[dtype]
    return [module.FleetJob(f"j{i}", length=length, kernel=kernel, n_steps=steps,
                            params=(0.02 + 0.01 * i,), seed=tag + i,
                            periodic=periodic,
                            cell_data={"rho": jdt if module is ref else tdt})
            for i in range(count)]


def _admit(batch, jobs):
    for j in jobs:
        j.apply_init(batch.grid)
        batch.admit(j)


def _as_f64(a):
    return np.asarray(a, dtype=np.float64)


def _ref_grid_state(job):
    g = ref.template_grid(job)
    job.apply_init(g)
    if job.n_steps:
        g.run_steps(job.resolved_kernel(), job.fields_in, job.fields_out,
                    job.n_steps, extra_args=tuple(jnp.float32(p) for p in job.params))
    return g


def _port_grid_state(job):
    g = port.template_grid(job, "cpu")
    job.apply_init(g)
    if job.n_steps:
        g.run_steps(job.resolved_kernel(), job.fields_in, job.fields_out,
                    job.n_steps,
                    extra_args=tuple(torch.tensor(p, dtype=torch.float32)
                                     for p in job.params))
    return g


# ---------------------------------------------------------------------
# initial bytes
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("length", [(8, 8, 8), (6, 5, 7)])
def test_seeded_init_digest_matches_reference(dtype, length):
    (rj,) = _jobs(ref, 7, count=1, length=length, dtype=dtype)
    (pj,) = _jobs(port, 7, count=1, length=length, dtype=dtype)
    rg = ref.template_grid(rj)
    rj.apply_init(rg)
    pg = port.template_grid(pj, "cpu")
    pj.apply_init(pg)
    assert port_ckpt.state_digest(pg) == ref_ckpt.state_digest(rg)


def test_float64_to_bfloat16_matches_ml_dtypes():
    """Ties, values one float32 rounding away from a bfloat16 tie
    (where ml_dtypes' cast, which rounds through float32, differs from
    one rounding of the float64), subnormals, overflow, signed zeros
    and NaN: the same bits as numpy's cast to ml_dtypes.bfloat16."""
    rng = np.random.default_rng(3)
    one = np.float64(1.0)
    specials = np.array([
        0.0, -0.0, 1.0 + 2 ** -8, 1.0 + 2 ** -8 + 2 ** -40, 1.0 + 2 ** -8 - 2 ** -40,
        1.0 + 3 * 2 ** -8, 2 ** -130, 2 ** -133 * 3, -(2 ** -140), 3.4e38, 3.39e38,
        1e39, -1e39, np.inf, -np.inf, np.nan, 1e-50, 65504.0, one + 2 ** -24])
    vals = np.concatenate([specials, rng.random(4096) * 100.0,
                           rng.standard_normal(4096) * 1e-38])
    got = port.float64_to_bfloat16(vals).view(torch.int16).numpy()
    with np.errstate(over="ignore"):
        want = vals.astype(ml_dtypes.bfloat16).view(np.int16)
    nan = np.isnan(vals)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert np.isnan(port.float64_to_bfloat16(vals[nan]).float().numpy()).all()
    # 1 + 2^-8 + 2^-40 rounds once to 1 + 2^-7, but through float32 to 1
    assert got[3] == want[3] == np.float32(1.0).view(np.int32) >> 16


# ---------------------------------------------------------------------
# the solo baseline
# ---------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [(True, True, True), (False, True, False)])
@pytest.mark.parametrize("kernel", ["diffuse", "advect_x"])
def test_run_solo_matches_reference(kernel, periodic):
    """The port's Grid.run_steps on the plain kernel against the
    reference's, 9 steps at 8^3 (observed: 7.6e-6 for diffuse, 3.1e-5
    for advect_x)."""
    (rj,) = _jobs(ref, 42, count=1, kernel=kernel, steps=9, periodic=periodic)
    (pj,) = _jobs(port, 42, count=1, kernel=kernel, steps=9, periodic=periodic)
    a = np.asarray(_ref_grid_state(rj).data["rho"])
    pg = _port_grid_state(pj)
    assert pg.last_step_path == "roll"
    np.testing.assert_allclose(pg.data["rho"].numpy(), a, **F32_TOL)
    digest = port.run_solo(pj, device="cpu")
    assert digest == port_ckpt.state_digest(pg)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["diffuse", "advect_x"])
def test_table_program_equals_run_solo(kernel, dtype):
    """The port's isolation pin: each slot of a table-program batch
    digests equal to the same job run alone, with budgets that stop
    slots at different steps; bfloat16 too, where the 0-dim solo
    extras and the [B, 1] batch extras must promote alike."""
    jobs = _jobs(port, 11, count=3, kernel=kernel, steps=6, dtype=dtype,
                 periodic=(True, False, True))
    budgets = [6, 3, 5]
    batch = port.GridBatch(jobs[0], 4, device="cpu", bulk=False)
    _admit(batch, jobs)
    batch.step(np.array(budgets + [0], np.int32))
    assert not batch.bulk_active()
    for slot, (job, n) in enumerate(zip(jobs, budgets)):
        job.n_steps = n
        assert batch.digest(slot) == port.run_solo(job, device="cpu")


# ---------------------------------------------------------------------
# GridBatch against the reference
# ---------------------------------------------------------------------

def _ref_batch(jobs, capacity, monkeypatch, bulk):
    if bulk:
        monkeypatch.setenv("DCCRG_BULK", "pallas")
    else:
        monkeypatch.delenv("DCCRG_BULK", raising=False)
    b = ref.GridBatch(jobs[0], capacity)
    _admit(b, jobs)
    return b


@pytest.mark.parametrize("periodic", [(True, True, True), (True, False, False)])
@pytest.mark.parametrize("kernel", ["diffuse", "advect_x"])
def test_table_batch_matches_reference(kernel, periodic, monkeypatch):
    """Budgets [4, 2, 0, 4]: the port's table batch against the
    reference's batch to the float32 tolerance; the budget-0 slot keeps
    its admitted bytes exactly."""
    budget = np.array([4, 2, 0, 4], np.int32)
    rjobs = _jobs(ref, 20, count=4, kernel=kernel, periodic=periodic)
    pjobs = _jobs(port, 20, count=4, kernel=kernel, periodic=periodic)
    rb = _ref_batch(rjobs, 4, monkeypatch, bulk=False)
    pb = port.GridBatch(pjobs[0], 4, device="cpu", bulk=False)
    _admit(pb, pjobs)
    admitted = pb.digest(2)
    assert admitted == rb.digest(2)
    rb.step(budget)
    pb.step(budget)
    np.testing.assert_allclose(pb.state["rho"].numpy(),
                               np.asarray(rb.state["rho"]), **F32_TOL)
    assert pb.digest(2) == admitted
    assert pb.finite_slots().tolist() == np.asarray(rb.finite_slots()).tolist()


@pytest.mark.parametrize("kernel,dtype", [("diffuse", "f32"), ("advect_x", "f32"),
                                          ("diffuse", "bf16")])
def test_bulk_batch_matches_reference_bulk(kernel, dtype, monkeypatch):
    """The port's bulk program (kernel A' through its plain version on
    the CPU) against the reference's Pallas bulk step in interpret mode
    at 16^3, and against the port's table program. float32: rtol 1e-6,
    atol 1e-5 to the reference (both add slot by slot), rtol 1e-5,
    atol 1e-6 to the table program (the neighbour sum re-associated).
    bfloat16: both bulk steps round every partial sum to bfloat16 and
    are held to one bfloat16 ulp at the values' peak (2^-8 * 128)."""
    length, budget = (16, 16, 16), np.array([3, 3, 1], np.int32)
    rjobs = _jobs(ref, 30, count=3, length=length, kernel=kernel, dtype=dtype)
    pjobs = _jobs(port, 30, count=3, length=length, kernel=kernel, dtype=dtype)
    rb = _ref_batch(rjobs, 3, monkeypatch, bulk=True)
    pb = port.GridBatch(pjobs[0], 3, device="cpu", bulk=True)
    _admit(pb, pjobs)
    rb.step(budget)
    pb.step(budget)
    assert rb.bulk_active() and pb.bulk_active()
    got = _as_f64(convert.batch_state_to_numpy(pb)["rho"])
    want = _as_f64(rb.state["rho"])
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -8 * 128)
    tb = port.GridBatch(pjobs[0], 3, device="cpu", bulk=False)
    _admit(tb, pjobs)
    tb.step(budget)
    table = _as_f64(convert.batch_state_to_numpy(tb)["rho"])
    if dtype == "f32":
        np.testing.assert_allclose(got, table, rtol=1e-5, atol=1e-6)
    else:
        # the table sums in float32 and rounds once: 2 ulps observed
        np.testing.assert_allclose(got, table, rtol=0, atol=4 * 2 ** -8 * 128)


def test_batch_state_round_trip(monkeypatch):
    """A reference batch's state loads into a port batch and comes
    back byte for byte; slots extracted from one insert into the
    other."""
    rjobs = _jobs(ref, 40, count=2, dtype="bf16")
    pjobs = _jobs(port, 40, count=2, dtype="bf16")
    rb = _ref_batch(rjobs, 2, monkeypatch, bulk=False)
    pb = port.GridBatch(pjobs[0], 2, device="cpu")
    convert.batch_state_from_numpy(pb, {n: np.asarray(a) for n, a in rb.state.items()})
    back = convert.batch_state_to_numpy(pb)["rho"]
    assert back.tobytes() == np.asarray(rb.state["rho"]).tobytes()
    assert [pb.digest(i) for i in range(2)] == [rb.digest(i) for i in range(2)]
    pb.insert(0, rb.extract(1))
    assert pb.digest(0) == rb.digest(1)
    with pytest.raises(ValueError):
        convert.batch_state_from_numpy(pb, {"rho": np.zeros((3, pb.R), ml_dtypes.bfloat16)})


# ---------------------------------------------------------------------
# the reference's own GridBatch pins, held to the port
# ---------------------------------------------------------------------

def test_same_shape_jobs_share_one_program():
    """Two batches with the same bucket key (a drained and recreated
    bucket) reuse one program; another shape is another program."""
    b1 = port.GridBatch(port.FleetJob("p", length=(8, 8, 8), params=(0.1,)), 16,
                        device="cpu")
    b1._programs()
    n_before = len(port._FLEET_PROGRAMS)
    b2 = port.GridBatch(port.FleetJob("q", length=(8, 8, 8), params=(0.2,)), 16,
                        device="cpu")
    b2._programs()
    assert len(port._FLEET_PROGRAMS) == n_before
    b3 = port.GridBatch(port.FleetJob("r", length=(4, 4, 4), params=(0.2,)), 16,
                        device="cpu")
    b3._programs()
    assert len(port._FLEET_PROGRAMS) == n_before + 1


def test_fleet_bucket_key_dtype():
    """dtype is part of the bucket key, by the reference's name."""
    a = port.FleetJob("a", length=(16, 16, 16), kernel="diffuse")
    b = port.FleetJob("b", length=(16, 16, 16), kernel="diffuse",
                      cell_data={"rho": torch.bfloat16})
    assert a.bucket_key() != b.bucket_key()
    c = port.FleetJob("c", length=(16, 16, 16), kernel="diffuse")
    assert a.bucket_key() == c.bucket_key()
    r = ref.FleetJob("b", length=(16, 16, 16), kernel="diffuse",
                     cell_data={"rho": jnp.bfloat16})
    assert b.bucket_key() == r.bucket_key()


def test_batch_digest_matches_state_digest():
    job = port.FleetJob("d", length=(6, 6, 6), seed=9)
    batch = port.GridBatch(job, 4, device="cpu")
    job.apply_init(batch.grid)
    g_digest = port_ckpt.state_digest(batch.grid)
    slot = batch.admit(job, from_grid=True)
    assert batch.digest(slot) == g_digest


@pytest.mark.parametrize("bulk", [False, True])
def test_nan_confined_mid_run_not_just_at_the_end(bulk):
    """With NaN resident in one slot while the batch steps, the other
    slots' bytes equal a batch that never saw it."""
    def mk_batch():
        b = port.GridBatch(port.FleetJob("p", length=(6, 6, 6), params=(0.05,)),
                           4, device="cpu", bulk=bulk)
        for slot, seed in enumerate((10, 11, 12)):
            j = port.FleetJob(f"s{slot}", length=(6, 6, 6), params=(0.05,),
                              seed=seed)
            j.apply_init(b.grid)
            b.admit(j, from_grid=True)
        return b

    poisoned, clean = mk_batch(), mk_batch()
    poisoned.poison(1, "rho", [5], float("nan"))
    budget = np.array([3, 3, 3, 0], np.int32)
    poisoned.step(budget)
    clean.step(budget)
    assert poisoned.bulk_active() is bulk
    assert list(poisoned.finite_slots()[:3]) == [True, False, True]
    assert poisoned.digest(0) == clean.digest(0)
    assert poisoned.digest(2) == clean.digest(2)
    assert poisoned.digest(1) != clean.digest(1)


# ---------------------------------------------------------------------
# the budget freeze inside the bulk step (kernel A' on the card)
# ---------------------------------------------------------------------

def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _bulk_spec(batch):
    return roll_executor.make_fleet_bulk_step(
        batch.grid, batch.bulk_kernel, ("rho",), ("rho",), 1).spec


@pytest.mark.parametrize("kernel", ["diffuse", "advect_x"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_freeze_equals_plain_pass_then_where(dtype, kernel):
    """The bulk step with budgets (``fleet_bulk_pass(..., budget, i)``,
    one kernel A' launch on the card) equals the plain pass followed by
    the ``torch.where`` freeze bit for bit: at step 1 of budgets
    [2, 0, 1, 3, 0] slots 1, 2 and 4 keep their input bytes, a NaN with
    a payload and a -0.0 in slot 1 included; a budget of another dtype
    is refused."""
    tdt = DTYPES[dtype][1]
    job = port.FleetJob("p", length=(6, 5, 7), kernel=kernel,
                        cell_data={"rho": tdt})
    batch = port.GridBatch(job, 5, device="cpu")
    twin, spec = batch.bulk_kernel, _bulk_spec(batch)
    rng = np.random.default_rng(7)
    state = torch.tensor(rng.random((5, spec.R), dtype=np.float32) * 100).to(tdt)
    state[:, -1] = 0
    _bits(state)[1, 3] = 0x7FC01234 if dtype == "f32" else 0x7FC5
    state[1, 4] = -0.0
    extras = torch.tensor((0.02 + 0.01 * np.arange(5, dtype=np.float32))[:, None])
    budget = torch.tensor([2, 0, 1, 3, 0], dtype=torch.int32)
    got = roll_executor.fleet_bulk_pass(spec, twin, state, extras, budget, 1)
    live = torch.tensor([True, False, False, True, False])[:, None]
    want = torch.where(live, roll_executor.fleet_bulk_pass_plain(
        spec, twin, state, extras), state)
    assert torch.equal(_bits(got), _bits(want))
    for slot in (1, 2, 4):
        assert torch.equal(_bits(got[slot]), _bits(state[slot]))
    assert not torch.equal(_bits(got[0]), _bits(state[0]))
    with pytest.raises(ValueError):
        roll_executor.fleet_bulk_pass(spec, twin, state, extras,
                                      budget.to(torch.int64), 1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cpu_quantum_freezes_spent_slots_bitwise(dtype):
    """A CPU bulk GridBatch quantum with budgets [4, 4, 2, 0] equals
    four plain passes, each followed by the ``torch.where`` freeze of
    the slots whose budget is spent, bit for bit; the budget-0 slot
    keeps its bytes."""
    jobs = _jobs(port, 60, count=3, length=(8, 6, 5), dtype=dtype)
    batch = port.GridBatch(jobs[0], 4, device="cpu", bulk=True)
    _admit(batch, jobs)
    spec = _bulk_spec(batch)
    extras = torch.as_tensor(batch._extras)
    budget = np.array([4, 4, 2, 0], np.int32)
    before = batch.state["rho"].clone()
    want = before
    for i in range(4):
        live = torch.as_tensor(budget > i)[:, None]
        want = torch.where(live, roll_executor.fleet_bulk_pass_plain(
            spec, batch.bulk_kernel, want, extras), want)
    assert batch.step(budget) == 4 and batch.bulk_active()
    assert torch.equal(_bits(batch.state["rho"]), _bits(want))
    assert torch.equal(_bits(batch.state["rho"][3]), _bits(before[3]))


# ---------------------------------------------------------------------
# slots, shadows, records
# ---------------------------------------------------------------------

def test_slot_management_and_shadows():
    jobs = _jobs(port, 50, count=2)
    b = port.GridBatch(jobs[0], 3, device="cpu")
    _admit(b, jobs)
    sh = b.admit_shadow(0)
    assert sh == 2 and b.shadows(0) == [2] and b.free_slot() is None
    assert [s for s, _ in b.jobs] == [0, 1]
    with pytest.raises(RuntimeError):
        b.admit(jobs[0])
    b.step(np.array([2, 2, 2], np.int32))
    assert b.digest(sh) == b.digest(0)
    g = b.write_grid(1)
    assert port_ckpt.state_digest(g) == b.digest(1)
    b.clear(0)
    assert b.slots == [None, jobs[1], None] and b.shadow_of == {}
    assert b.step(np.zeros(3, np.int32)) == 0


def test_job_records_and_unknown_kernel():
    jobs = port._jobs_from_spec({"jobs": [
        {"name": "a", "n": 8, "dt": 0.05, "kernel": "advect_x", "steps": 4},
        {"name": "b", "length": [4, 5, 6], "params": [0.1], "periodic": [1, 0, 1]}]})
    assert jobs[0].length == (8, 8, 8) and jobs[0].params == (0.05,)
    assert jobs[1].periodic == (True, False, True)
    r = ref.job_from_row({"name": "a", "n": 8, "dt": 0.05, "kernel": "advect_x"})
    assert port.job_from_row({"name": "a", "n": 8, "dt": 0.05,
                              "kernel": "advect_x"}).bucket_key() == r.bucket_key()
    with pytest.raises(port.JobSpecError):
        port.job_from_row({"n": 8})
    with pytest.raises(port.JobSpecError):
        port.job_from_row({"name": "x", "length": [4, 4]})
    with pytest.raises(port.UnknownKernelError):
        port.job_from_row({"name": "x", "kernel": "no_such_kernel"},
                          validate_kernel=True)
    # a zoo name resolves: the fleet imports the port's zoo on a miss
    assert port.job_from_row({"name": "x", "kernel": "mhd"},
                             validate_kernel=True).resolved_kernel()


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    job = port.FleetJob("x", length=(4, 4, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.GridBatch(job, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.run_solo(job)
