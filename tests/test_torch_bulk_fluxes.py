"""Kernel A for the fleet's slot-wise twins (``diffuse``, ``advect_x``)
through ``Grid.run_steps``, one-step and k-deep, and kernel A' on
buckets of neighbourhood length 0 and 2, on the CPU.

The reference runs under ``DCCRG_BULK=pallas`` on a one-device mesh
(Pallas in interpret mode), as tests/test_bulk_executor.py runs it, at
16^3 from ``seeded_random_init``'s bytes; each of its runs is made once
for the module. The port's bulk path (kernel A's plain version on CPU
tensors) is held to it at that test's tolerances, rtol 1e-6 / atol 1e-6
after one pass and 1e-5 / 1e-6 after two more steps, and to the port's
own plain roll path bit for bit. The kernels themselves run only on the
card (tests/test_torch_cuda.py); here their slot tables, routes and
rules are checked, and the build's library name against header edits.
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dccrg_tpu import fleet as ref_fleet
from dccrg_tpu.grid import Grid as RefGrid
from dccrg_tpu.grid import default_mesh

import dccrg_tpu_torch as port
from dccrg_tpu_torch import DEFAULT_NEIGHBORHOOD_ID, convert, fleet
from dccrg_tpu_torch.ops import _build
from dccrg_tpu_torch.ops import roll_executor as rx

# the twins' extras: diffuse's dt, advect_x's cfl
EXTRA = {"diffuse": 0.05, "advect_x": 0.4}
N = 16
PERIODIC = [(True, True, True), (False, False, False)]
_REF = {}


def _reference(flux, periodic, spp):
    """The reference's ``DCCRG_BULK=pallas`` run of ``flux`` on the
    face neighbourhood at 16^3 (tests/test_bulk_executor.py's grid):
    the density after ``spp`` steps (one pass) and after 2 more; run
    once for the module."""
    key = (flux, periodic, spp)
    if key not in _REF:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DCCRG_BULK", "pallas")
            mp.setenv("DCCRG_BULK_SPP", str(spp))
            g = (RefGrid(cell_data={"rho": jnp.float32})
                 .set_initial_length((N, N, N)).set_periodic(*periodic)
                 .set_maximum_refinement_level(0).set_neighborhood_length(0)
                 .initialize(default_mesh(jax.devices()[:1])))
            ref_fleet.seeded_random_init(g, 7)
            g.update_copies_of_remote_neighbors()
            kern = ref_fleet.FLEET_BULK_KERNELS[flux]
            extra = (jnp.float32(EXTRA[flux]),)
            g.run_steps(kern, ["rho"], ["rho"], spp, extra_args=extra)
            assert any(k[0] == "bulksteploop" for k in g._program_cache)
            one = np.asarray(g.data["rho"][0][:N ** 3])
            g.run_steps(kern, ["rho"], ["rho"], 2, extra_args=extra)
            _REF[key] = one, np.asarray(g.data["rho"][0][:N ** 3])
    return _REF[key]


def _port_grid(periodic, hood_len=0, dtype=torch.float32, length=(N, N, N),
               seed=7):
    g = (port.Grid(cell_data={"rho": torch.float32}, dtype=dtype)
         .set_initial_length(length).set_periodic(*periodic)
         .set_maximum_refinement_level(0).set_neighborhood_length(hood_len)
         .initialize("cpu"))
    fleet.seeded_random_init(g, seed)
    return g


@pytest.mark.parametrize("spp", [1, 4])
@pytest.mark.parametrize("periodic", PERIODIC)
@pytest.mark.parametrize("flux", ["diffuse", "advect_x"])
def test_twin_matches_reference_bulk_executor(flux, periodic, spp,
                                              monkeypatch):
    """The port's bulk path for a twin under ``DCCRG_BULK_SPP=spp``
    (one pass, then a remainder of two steps) against the reference's
    Pallas bulk executor on the same seeded bytes."""
    want1, want2 = _reference(flux, periodic, spp)
    monkeypatch.setenv("DCCRG_BULK_SPP", str(spp))
    g = _port_grid(periodic)
    kern = fleet.FLEET_BULK_KERNELS[flux]
    extra = (torch.tensor(EXTRA[flux], dtype=torch.float32),)
    g.run_steps(kern, ["rho"], ["rho"], spp, extra_args=extra)
    assert g.last_step_path == "bulk"
    got1 = convert.fields_to_numpy(g)["rho"][0, :N ** 3]
    np.testing.assert_allclose(got1, want1, rtol=1e-6, atol=1e-6)
    g.run_steps(kern, ["rho"], ["rho"], 2, extra_args=extra)
    got2 = convert.fields_to_numpy(g)["rho"][0, :N ** 3]
    np.testing.assert_allclose(got2, want2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("periodic", [(True, True, True), (True, False, True),
                                      (False, False, False)])
@pytest.mark.parametrize("hood_len", [0, 1, 2])
@pytest.mark.parametrize("flux", ["diffuse", "advect_x"])
def test_twin_bulk_equals_roll_path(flux, hood_len, periodic, dtype, k,
                                    monkeypatch):
    """``Grid.run_steps`` with a twin takes the bulk path on every
    neighbourhood length and equals the plain roll path bit for bit:
    2k + 1 steps, the k-deep branch taken (the rule set to take the
    bricks, which it declines at these sizes) for n // k passes and a
    remainder of one-step passes. The grid (9, 7, 5) is smaller than
    the reach of length 2 in z."""
    monkeypatch.setenv("DCCRG_BULK_SPP", str(k))
    monkeypatch.setitem(rx._BRICK_PAYS, flux, ((k,), 0, 0))
    passes = []
    plain_k = rx.bulk_pass_k_plain

    def counted(spec, kernel, fields, extras, kk):
        passes.append(kk)
        return plain_k(spec, kernel, fields, extras, kk)

    monkeypatch.setattr(rx, "bulk_pass_k_plain", counted)
    a, b = (_port_grid(periodic, hood_len, dtype, (9, 7, 5), seed=k)
            for _ in range(2))
    kern = fleet.FLEET_BULK_KERNELS[flux]
    extra = (torch.tensor(EXTRA[flux], dtype=torch.float32),)
    n = 2 * k + 1
    a.run_steps(kern, ["rho"], ["rho"], n, extra_args=extra)
    b.run_steps(kern, ["rho"], ["rho"], n, extra_args=extra, bulk=False)
    assert a.last_step_path == "bulk" and b.last_step_path == "roll"
    assert passes == ([k, k] if k > 1 else [])
    assert a.data["rho"].dtype == dtype
    assert torch.equal(a.data["rho"], b.data["rho"])


def _jobs(module, hood_len, kernel, dtype):
    """Three jobs; at length 2 diffuse's dt stays below 1 / 124, the
    explicit step's stability limit over 124 neighbours, so no mode
    grows and the float32 sums are compared, not amplified noise."""
    dt0, ddt = (0.003, 0.001) if hood_len == 2 else (0.03, 0.01)
    return [module.FleetJob(f"j{i}", length=(N, N, N), kernel=kernel,
                            n_steps=3, params=(dt0 + ddt * i,), seed=20 + i,
                            hood_len=hood_len, cell_data={"rho": dtype})
            for i in range(3)]


@pytest.mark.parametrize("hood_len,kernel", [(0, "diffuse"), (2, "diffuse"),
                                             (2, "advect_x")])
def test_bucket_matches_reference_bulk_bucket(hood_len, kernel, monkeypatch):
    """A ``GridBatch`` bucket of neighbourhood length 0 or 2 takes
    kernel A''s program (its slot-table route; the plain version on the
    CPU) and matches the reference's bulk bucket (Pallas, interpret
    mode) within rtol 1e-5 / atol 1e-6, as
    tests/test_bulk_executor.py:247-279 holds the reference's bulk
    bucket to its table program; one slot's budget runs out first."""
    budget = np.array([3, 3, 1], np.int32)
    monkeypatch.setenv("DCCRG_BULK", "pallas")
    rb = ref_fleet.GridBatch(_jobs(ref_fleet, hood_len, kernel,
                                   jnp.float32)[0], 3)
    pb = fleet.GridBatch(_jobs(fleet, hood_len, kernel, torch.float32)[0], 3,
                         device="cpu")
    for b, jobs in ((rb, _jobs(ref_fleet, hood_len, kernel, jnp.float32)),
                    (pb, _jobs(fleet, hood_len, kernel, torch.float32))):
        for j in jobs:
            j.apply_init(b.grid)
            b.admit(j)
    rb.step(budget)
    pb.step(budget)
    assert rb.bulk_active() and pb.bulk_active()
    spec = rx.make_fleet_bulk_step(pb.grid, pb.bulk_kernel, ("rho",),
                                   ("rho",), 1).spec
    assert not spec.cube and rx.fleet_route(spec, pb.state["rho"]) == "slots"
    got = np.asarray(convert.batch_state_to_numpy(pb)["rho"], np.float64)
    np.testing.assert_allclose(got, np.asarray(rb.state["rho"], np.float64),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hood_len,n_diffuse,n_advect,reach", [
    (0, 6, 1, (1, 1, 1)), (1, 26, 1, (1, 1, 1)), (2, 124, 2, (2, 2, 2))])
def test_twin_slot_tables_and_routes(hood_len, n_diffuse, n_advect, reach):
    """The slots each twin reads, in ``offs_const`` order (diffuse
    every slot; advect_x those with x < 0, y == 0, z == 0), the slot
    table's rows, the direct route (never the upwind flux's plane
    tiles), the bricks' geometry for one staged field, the step loop's
    rule, and kernel A''s route by neighbourhood."""
    g = _port_grid((True, True, False), hood_len, length=(64, 64, 64))
    hood = g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID]
    for flux, n_read in (("diffuse", n_diffuse), ("advect_x", n_advect)):
        spec = rx._grid_spec_for(g, hood, flux)
        assert spec.flux == flux and spec.n_fields == 1
        assert len(spec.slots) == spec.terms() == n_read
        assert not spec.face4 and spec.tile == (32, 8, 1)
        js = [s[0] for s in spec.slots]
        assert js == sorted(js)
        for j, ox, oy, oz, fx, fy in spec.slots:
            oc = hood.offs_const[j]
            assert (ox, oy, oz) == tuple(hood.closed_form["offsets"][j])
            assert fx == fy == 0
            if flux == "advect_x":
                assert oc[0] < 0 and oc[1] == 0 and oc[2] == 0
        assert spec.table.rows == [(s[1], s[2], s[3], 5) for s in spec.slots]
        assert spec.bytes_moved(4) == 2 * 64 ** 3 * 4
        per = 2 * n_read + 2 if flux == "diffuse" else n_read + 4
        assert spec.flops(3) == 3 * per * 64 ** 3
        if flux == "diffuse":
            assert spec.reach() == reach
        for k in (2, 4):
            route, (bx, by, bz) = spec.deep(k)
            assert route == "bricks"
            rx_, ry_, rz_ = spec.reach()
            w, h = bx + 2 * k * rx_, by + 2 * k * ry_
            smem = rx._brick_smem(w, h, k, rz_, n_read, 1)
            assert 2 * (smem + 1024) <= 228 * 1024
            assert w * h <= rx._BRICK_THREADS * rx._BRICK_ELEMS
            rule = rx._BRICK_PAYS[flux]
            blocks = -(-64 // bx) * -(-64 // by) * -(-64 // bz)
            assert spec.deep_pays(k) == (rule is not None and k in rule[0]
                                         and n_read >= rule[1]
                                         and blocks >= rule[2])
    upwind = rx._grid_spec_for(g, hood)
    assert upwind.flux == "upwind_xy" and upwind.face4 == (hood_len == 0)
    fspec = rx.FleetPassSpec(hood.closed_form["dims"],
                             hood.closed_form["periodic"],
                             hood.closed_form["offsets"], hood.offs_const,
                             hood.closed_form["n0"], g.plan.L)
    assert fspec.cube == (hood_len == 1)
    state = torch.zeros((2, fspec.R))
    assert (rx.fleet_route(fspec, state) == "slots") == (hood_len != 1)
    assert len(fspec.slot_table("diffuse").rows) == n_diffuse
    assert len(fspec.slot_table("advect_x").rows) == n_advect


def test_spec_of_another_flux_is_refused():
    """A spec built for one flux refuses a kernel of another."""
    g = _port_grid((True, True, True), 1, length=(8, 8, 8))
    spec = rx._grid_spec_for(g, g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID],
                             "diffuse")
    fields = {"rho": g.data["rho"][0, :g.plan.L]}
    with pytest.raises(ValueError):
        rx.bulk_pass(spec, fleet.FLEET_BULK_KERNELS["advect_x"], fields,
                     (torch.tensor(0.4),))


def test_library_name_hashes_included_headers(tmp_path, monkeypatch):
    """A kernel library's name covers the ``csrc`` headers its source
    includes: changing a byte of fluxes.cuh renames the libraries of
    the three sources that include it and no other."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("bulk_pass", "bulk_pass_k", "fleet_bulk_pass", "rotation_step",
             "laplacian_matvec")
    before = {n: _build.library_name(n) for n in names}
    assert [h.name for h in _build._headers(csrc / "bulk_pass.cu")] == [
        "fluxes.cuh"]
    head = csrc / "fluxes.cuh"
    data = bytearray(head.read_bytes())
    data[-2] ^= 1
    head.write_bytes(bytes(data))
    after = {n: _build.library_name(n) for n in names}
    for n in names:
        changed = n in ("bulk_pass", "bulk_pass_k", "fleet_bulk_pass")
        assert (after[n] != before[n]) == changed, n
    # an edit to the source itself renames it too
    src = csrc / "bulk_pass.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert _build.library_name("bulk_pass") != after["bulk_pass"]
