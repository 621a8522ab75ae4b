"""The port's model zoo (models/mhd.py, models/vlasov.py, the registry
in models/__init__.py and the fleet's zoo kernels) against the
reference, on the CPU.

Inits are host numpy in both packages, so seeded states are equal byte
for byte. Stepped states hold to the reference at ``rtol 1e-6, atol
1e-6`` in float32 (fields of magnitude up to ~1.5; measured: at most
1.8e-7 after 6 + 6 MHD passes at 8³ and 12³, 1.2e-7 after 6 Vlasov steps
at 8³): the port sums neighbour slots and ``[Nv]`` lanes one by one in
slot order where XLA picks its own order, and ``torch.exp`` is not
XLA's exponential. The CFL step is the reference's float64 reduction,
equal bit for bit. Inside the port, a model on four partitions equals
one partition bit for bit, and a fleet slot equals its ``run_solo`` by
digest.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dccrg_tpu import fleet as ref_fleet
from dccrg_tpu import models as ref_models
from dccrg_tpu.models import mhd as ref_mhd
from dccrg_tpu.models import vlasov as ref_vlasov

from dccrg_tpu_torch import checkpoint, integrity
from dccrg_tpu_torch import fleet as port_fleet
from dccrg_tpu_torch import grid as port_grid
from dccrg_tpu_torch import models
from dccrg_tpu_torch.fleet import (FLEET_KERNELS, FleetJob, GridBatch,
                                   job_from_row, run_solo)
from dccrg_tpu_torch.models import GridMHD, GridVlasov, available_models
from dccrg_tpu_torch.models.mhd import (MHD_ALL, MHD_BFIELD, MHD_HYDRO,
                                        make_mhd_pass_kernels,
                                        mhd_default_init)
from dccrg_tpu_torch.models.vlasov import (VLASOV_FIELDS, _v_grid_np,
                                           vlasov_cell_data,
                                           vlasov_default_init)

pytestmark = pytest.mark.models

TOL = dict(rtol=1e-6, atol=1e-6)


def mesh_of(n):
    return Mesh(np.array(jax.devices()[:n]), ("dev",))


def _fields(grid, names):
    return {n: np.asarray(grid.get(n, grid.plan.cells)) for n in names}


def _assert_close(ref, port, names, **tol):
    a, b = _fields(ref, names), _fields(port, names)
    for n in names:
        np.testing.assert_allclose(b[n], a[n], err_msg=n, **(tol or TOL))


# -- the registry -------------------------------------------------------

def test_available_models_equal_reference():
    assert available_models() == ref_models.available_models()
    assert models.MODEL_ZOO == ref_models.MODEL_ZOO


def test_zoo_registered_on_import():
    assert "mhd" in FLEET_KERNELS and "vlasov" in FLEET_KERNELS
    assert integrity.conserved_fields(
        "mhd", (True, True, True), MHD_ALL) == MHD_ALL
    assert integrity.conserved_fields(
        "vlasov", (True, True, True), VLASOV_FIELDS) == ("rho",)
    assert integrity.conserved_fields(
        "mhd", (True, False, True), MHD_ALL) == ()
    models.ensure_registered()  # idempotent
    assert models.GridMHD is GridMHD and models.GridVlasov is GridVlasov


def _schema(cell_data):
    """``{name: (shape, dtype name)}`` of either package's job."""
    out = {}
    for n, (shape, dt) in cell_data.items():
        name = (checkpoint.dtype_name(dt) if isinstance(dt, torch.dtype)
                else np.dtype(dt).name)
        out[n] = (tuple(shape), name)
    return out


@pytest.mark.parametrize("kernel", ["mhd", "vlasov", "diffuse"])
def test_fleet_job_zoo_defaults(kernel):
    """A bare FleetJob naming a zoo kernel takes its spec's schema,
    field lists and params, as the reference's does."""
    p = FleetJob("z", kernel=kernel, length=(6, 6, 6), n_steps=4)
    r = ref_fleet.FleetJob("z", kernel=kernel, length=(6, 6, 6), n_steps=4)
    assert _schema(p.cell_data) == _schema(r.cell_data)
    assert p.fields_in == r.fields_in and p.fields_out == r.fields_out
    assert p.params == r.params
    if kernel == "vlasov":
        assert p.cell_data["f"][0] == (16,)


def test_job_from_row_names_zoo_kernels():
    rows = [{"name": "jm", "kernel": "mhd", "n": 6, "steps": 4},
            {"name": "jv", "kernel": "vlasov", "n": 6, "steps": 4},
            {"name": "jd", "kernel": "diffuse", "n": 6, "steps": 4}]
    jobs = [job_from_row(r, validate_kernel=True) for r in rows]
    assert set(jobs[0].cell_data) == set(MHD_ALL)
    assert "f" in jobs[1].cell_data
    assert jobs[2].params == (0.1,)
    with pytest.raises(port_fleet.UnknownKernelError):
        job_from_row({"name": "x", "kernel": "nope"}, validate_kernel=True)


# -- inits and the velocity grid ---------------------------------------

@pytest.mark.parametrize("model", ["mhd", "vlasov"])
def test_default_init_bytes_equal(model):
    job = FleetJob("a", kernel=model, length=(6, 5, 4), seed=11)
    rjob = ref_fleet.FleetJob("a", kernel=model, length=(6, 5, 4), seed=11)
    p = port_fleet.template_grid(job, "cpu")
    r = ref_fleet.template_grid(rjob)
    (mhd_default_init if model == "mhd" else vlasov_default_init)(p, 11)
    (ref_mhd.mhd_default_init if model == "mhd"
     else ref_vlasov.vlasov_default_init)(r, 11)
    for n in p.fields:
        assert (np.asarray(r.get(n, r.plan.cells)).tobytes()
                == p.get(n, p.plan.cells).tobytes()), n


@pytest.mark.parametrize("nv", [2, 3, 8, 10, 12, 16, 32, 64])
def test_v_grid_bitwise(nv):
    want = np.asarray(ref_vlasov._v_grid(nv)[0])
    assert _v_grid_np(nv).tobytes() == want.tobytes()


# -- the models against the reference's virtual mesh -------------------

@pytest.mark.parametrize("n_dev", [1, 4])
@pytest.mark.parametrize("kw", [dict(n=12), dict(n=8, profile="random",
                                                  seed=3)],
                         ids=["blast12", "random8"])
def test_grid_mhd_matches_reference(n_dev, kw):
    r = ref_mhd.GridMHD(mesh=mesh_of(n_dev), **kw)
    p = GridMHD(device=["cpu"] * n_dev, **kw)
    for n in MHD_ALL:  # same host init
        assert (np.asarray(r.grid.get(n, r.grid.plan.cells)).tobytes()
                == p.grid.get(n, p.grid.plan.cells).tobytes())
    # the CFL step of one state is the reference's bit for bit; after
    # the first steps the states differ in the last bits, so both runs
    # take the reference's step
    assert p.max_time_step() == r.max_time_step()
    for _ in range(3):
        dt = 0.4 * r.max_time_step()
        assert p.max_time_step() == pytest.approx(dt / 0.4, rel=1e-6)
        r.run(2, dt=dt)
        p.run(2, dt=dt)
    _assert_close(r.grid, p.grid, MHD_ALL)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_grid_vlasov_matches_reference(n_dev):
    r = ref_vlasov.GridVlasov(n=8, nv=16, mesh=mesh_of(n_dev))
    p = GridVlasov(n=8, nv=16, device=["cpu"] * n_dev)
    for n in VLASOV_FIELDS:
        assert (np.asarray(r.grid.get(n, r.grid.plan.cells)).tobytes()
                == p.grid.get(n, p.grid.plan.cells).tobytes())
    r.run(6, dt=0.04)
    p.run(6, dt=0.04)
    _assert_close(r.grid, p.grid, VLASOV_FIELDS)


@pytest.mark.parametrize("model", ["mhd", "vlasov"])
def test_partitions_bitwise_one_partition(model):
    """Four partitions step bit for bit with one."""
    digests = []
    for n_dev in (1, 4):
        if model == "mhd":
            m = GridMHD(n=8, profile="random", seed=5,
                        device=["cpu"] * n_dev)
            m.run(3)
        else:
            m = GridVlasov(n=8, nv=8, device=["cpu"] * n_dev)
            m.run(4, dt=0.04)
        digests.append(checkpoint.state_digest(m.grid))
    assert digests[0] == digests[1]


# -- conservation -------------------------------------------------------

def test_mhd_conservation():
    m = GridMHD(n=12, device="cpu")
    before = m.conserved_sums()
    m.run(6, dt=0.01)
    after = m.conserved_sums()
    for name in MHD_ALL:
        tol = integrity.sum_tolerance(before[name], 12 ** 3, steps=6)
        assert abs(after[name] - before[name]) <= tol, name
    assert after != before


def test_vlasov_mass_conservation():
    v = GridVlasov(n=6, nv=12, device="cpu")
    m0 = v.total_mass()
    v.run(8, dt=0.04)
    assert abs(v.total_mass() - m0) <= integrity.sum_tolerance(
        m0, 6 ** 3, steps=8)


# -- the ghost split ------------------------------------------------------

def test_ghost_split_bitwise_and_strictly_fewer_rows(monkeypatch):
    """Split against full outer re-pass on the MHD model (8 x 8 x 40 on
    eight block partitions, tests/test_models.py's geometry): bit for
    bit equal, and each pass recomputes strictly fewer row slots."""
    digests, counts = {}, {}
    for split in (False, True):
        monkeypatch.setenv("DCCRG_OVERLAP", "1")
        monkeypatch.setenv("DCCRG_GHOST_SPLIT", "1" if split else "0")
        m = GridMHD(n=8, nz=40, device=["cpu"] * 8)
        hydro, bpass = make_mhd_pass_kernels()
        lam = torch.tensor(0.01 * m.n, dtype=torch.float32)
        per_pass = []
        for kern, exch in ((hydro, MHD_HYDRO), (bpass, MHD_BFIELD)):
            m.grid.run_steps(kern, MHD_ALL, MHD_ALL, 5,
                             exchange_fields=exch, extra_args=(lam,))
            per_pass.append(dict(m.grid.last_overlap))
        digests[split] = checkpoint.state_digest(m.grid)
        counts[split] = per_pass
    assert digests[False] == digests[True]
    for ov in counts[False]:
        assert ov["mode"] == "full"
        assert ov["rows_split"] == ov["rows_full"] > 0
    hydro_ov, b_ov = counts[True]
    assert hydro_ov["mode"] == "split" and b_ov["mode"] == "split"
    assert set(hydro_ov["repass_fields"]) == set(MHD_HYDRO)
    assert set(b_ov["repass_fields"]) == set(MHD_BFIELD)
    assert 0 < hydro_ov["rows_split"] < hydro_ov["rows_full"]
    assert 0 < b_ov["rows_split"] < b_ov["rows_full"]


def test_ghost_split_vlasov_falls_back_to_full(monkeypatch):
    """Vlasov's deps cover every exchanged field at every outer row: the
    split saves nothing and runs the full re-pass, bit for bit."""
    digests = {}
    for split in (False, True):
        monkeypatch.setenv("DCCRG_OVERLAP", "1")
        monkeypatch.setenv("DCCRG_GHOST_SPLIT", "1" if split else "0")
        v = GridVlasov(n=8, nz=40, nv=8, device=["cpu"] * 8)
        v.run(4, dt=0.04)
        assert v.grid.last_overlap["mode"] == "full"
        digests[split] = checkpoint.state_digest(v.grid)
    assert digests[False] == digests[True]


# -- the wide payload never moves -----------------------------------------

NV_WIDE = 7  # a payload width no other tensor of these runs ends in

_GATHER_OPS = ("index_select", "index", "gather", "roll")


class WideGathers(TorchDispatchMode):
    """Records every gather (index_select, advanced indexing, gather,
    roll) whose result has a slot axis and ends in the wide payload's
    width: a gathered ``[..., S, Nv]`` neighbour stack of ``f``, whether
    made eagerly or lazily (a cell's own ``[k, Nv]`` rows are not)."""

    def __init__(self, nv):
        super().__init__()
        self.nv, self.hits = nv, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func.overloadpacket.__name__ in _GATHER_OPS
                and isinstance(out, torch.Tensor) and out.dim() >= 3
                and out.shape[-1] == self.nv):
            self.hits.append((str(func), tuple(out.shape)))
        return out


def test_vlasov_wide_payload_never_exchanges():
    v = GridVlasov(n=8, nz=40, nv=8, device=["cpu"] * 8)
    g = v.grid
    L = g.plan.L

    def ghost_bytes(name):
        return b"".join(
            g.data[name][d, L:L + len(g.plan.ghost_ids[d])].numpy().tobytes()
            for d in range(g.n_dev))

    f_before, rho_before = ghost_bytes("f"), ghost_bytes("rho")
    v.run(4, dt=0.04)
    assert ghost_bytes("f") == f_before
    assert ghost_bytes("rho") != rho_before
    g.update_copies_of_remote_neighbors(fields=("f",))
    assert ghost_bytes("f") != f_before


def test_gather_recorder_sees_a_wide_gather():
    """The recorder's positive control: an explicit neighbour gather of
    ``f`` is seen."""
    g = GridVlasov(n=4, nv=NV_WIDE, device="cpu").grid
    rows = torch.as_tensor(np.asarray(
        g.plan.hoods[port_grid.DEFAULT_NEIGHBORHOOD_ID].nbr_rows[0]),
        dtype=torch.int64)
    with WideGathers(NV_WIDE) as rec:
        g.data["f"][0][rows]
    assert rec.hits


@pytest.mark.parametrize("overlap", ["0", "1"])
def test_vlasov_f_never_gathered_on_partitions(monkeypatch, overlap):
    """The bulk pass and the overlapped step's outer re-pass gather only
    the moments."""
    monkeypatch.setenv("DCCRG_OVERLAP", overlap)
    v = GridVlasov(n=8, nz=40, nv=NV_WIDE, device=["cpu"] * 8)
    with WideGathers(NV_WIDE) as rec:
        v.run(2, dt=0.04)
    assert rec.hits == []
    if overlap == "1":
        assert v.grid.last_overlap["mode"] == "full"


@pytest.fixture
def table_gathers(monkeypatch):
    """The trailing shape of every field the table gathers (the dense
    pass's and the hard-row pass's ``_table_gather_all``) gather."""
    seen = []
    orig = port_grid._table_gather_all

    def recording(nrows):
        gather = orig(nrows)

        def g(fl):
            seen.append(tuple(fl.shape[1:]))
            return gather(fl)

        return g

    monkeypatch.setattr(port_grid, "_table_gather_all", recording)
    return seen


def test_vlasov_f_never_gathered_on_hard_rows(table_gathers):
    """On a refined grid the dense pass and the hard-row pass gather
    only the moments."""
    g = (port_grid.Grid(cell_data=vlasov_cell_data(NV_WIDE))
         .set_initial_length((4, 4, 4)).set_periodic(True, True, True)
         .set_maximum_refinement_level(1).set_neighborhood_length(0)
         .initialize("cpu"))
    g.refine_completely(1)
    g.stop_refining()
    assert g.plan.hoods[port_grid.DEFAULT_NEIGHBORHOOD_ID].hard_nbr_rows \
        is not None
    vlasov_default_init(g, 2)
    g.update_copies_of_remote_neighbors()
    with WideGathers(NV_WIDE) as rec:
        g.run_steps(models.vlasov.make_vlasov_kernel(), VLASOV_FIELDS,
                    VLASOV_FIELDS, 2, extra_args=(0.04,))
    assert rec.hits == []
    assert table_gathers and set(table_gathers) == {()}
    assert np.isfinite(g.get("f", g.plan.cells)).all()


def test_vlasov_f_never_gathered_in_fleet():
    job = FleetJob("v", kernel="vlasov", length=(6, 6, 6), n_steps=3,
                   seed=2, cell_data=vlasov_cell_data(NV_WIDE))
    batch = GridBatch(job, 2, device="cpu")
    job.apply_init(batch.grid)
    batch.admit(job)
    with WideGathers(NV_WIDE) as rec:
        batch.step(np.array([3, 0], dtype=np.int32))
    assert rec.hits == []


# -- the fleet ------------------------------------------------------------

def _ref_state(job):
    g = ref_fleet.template_grid(job)
    job.apply_init(g)
    g.run_steps(job.resolved_kernel(), job.fields_in, job.fields_out,
                job.n_steps,
                extra_args=tuple(jnp.float32(p) for p in job.params))
    return g


@pytest.mark.parametrize("kernel", ["mhd", "vlasov"])
def test_fleet_bucket_equals_run_solo(kernel):
    """Three jobs of one bucket, budgets 5/3/0 in two quanta: every slot
    digests equal to its port ``run_solo`` and holds to the reference's
    solo run; the spent slot keeps its bytes; the invariants hold."""
    steps = (5, 3, 0)
    jobs = [FleetJob(f"{kernel}{i}", kernel=kernel, length=(6, 6, 6),
                     n_steps=s, seed=17 * i + 3)
            for i, s in enumerate(steps)]
    batch = GridBatch(jobs[0], 3, device="cpu")
    for j in jobs:
        j.apply_init(batch.grid)
        batch.admit(j)
    init2 = batch.digest(2)
    left = np.array(steps, dtype=np.int32)
    while left.max() > 0:
        b = np.minimum(left, 3)
        batch.step(b)
        left -= b
        inv = batch.last_inv
        for slot, j in enumerate(jobs):
            assert (inv["fp_in"]["rho"][slot] != inv["fp_out"]["rho"][slot]
                    ).any() == bool(b[slot])
        for n, cs in inv["cs_out"].items():
            for slot in range(3):
                tol = integrity.sum_tolerance(inv["cs_in"][n][slot],
                                              6 ** 3, steps=3)
                assert abs(cs[slot] - inv["cs_in"][n][slot]) <= tol
    assert batch.digest(2) == init2
    for slot, j in enumerate(jobs):
        assert batch.digest(slot) == run_solo(j, "cpu"), j.name
        if j.n_steps:
            r = _ref_state(ref_fleet.FleetJob(
                j.name, kernel=kernel, length=j.length, n_steps=j.n_steps,
                seed=j.seed))
            host = batch.extract(slot)
            for n in batch.schema:
                rows = batch.grid.plan.row_of_pos
                np.testing.assert_allclose(
                    host[n][rows], np.asarray(r.get(n, r.plan.cells)),
                    err_msg=n, **TOL)


def test_fleet_fingerprints_cover_wide_field():
    """The integrity layer fingerprints the wide [Nv] float32 field: a
    finite bit flip in one slot's f changes that slot's f fingerprint
    and no other."""
    job = FleetJob("v", kernel="vlasov", length=(6, 6, 6), seed=4)
    batch = GridBatch(job, 2, device="cpu")
    for _ in range(2):
        job.apply_init(batch.grid)
        batch.admit(job)
    assert "f" in batch.fp_fields
    assert batch.conserved == ("rho",)
    before = batch.fingerprint_slots()
    batch.flip(1, "f", batch.grid.plan.cells[:1], bit=3)
    after = batch.fingerprint_slots()
    assert (after["f"][0] == before["f"][0]).all()
    assert (after["f"][1] != before["f"][1]).any()
    assert (after["rho"] == before["rho"]).all()
