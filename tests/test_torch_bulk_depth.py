"""Kernel A's k-deep pass (``DCCRG_BULK_SPP``) on the CPU: the knob
against the reference's, the route rule and its cost from the geometry,
the step loop's k-deep passes and one-step remainder (their plain
versions on CPU tensors; one-step passes only where the loop declines
the route, and k-deep passes on the bricks' sets with the loop's rule
set to take them) against the plain roll path, bit for bit on every
row, and against the reference's k-deep Pallas executor (interpret
mode) on the 26-cube and in bfloat16.

The k-deep kernel itself runs only on the card; ``tests/test_torch_cuda.py``
holds it to ``bulk_pass_k_plain`` there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dccrg_tpu.grid import Grid as RefGrid
from dccrg_tpu.grid import default_mesh
from dccrg_tpu.models.advection import \
    make_uniform_flux_kernel as ref_flux_kernel
from dccrg_tpu.ops import roll_executor as ref_rx

import dccrg_tpu_torch as port
from dccrg_tpu_torch.convert import fields_to_numpy
from dccrg_tpu_torch.models.advection import (GridAdvection,
                                              make_uniform_flux_kernel)
from dccrg_tpu_torch.ops import roll_executor as rx

from torch_bulk_k_emulation import emulate_planes

FIELDS = ("density", "vx", "vy")
# a user neighbourhood with reach 2 in y and z: the brick route
REACH2_HOOD = [(1, 2, 0), (-1, -2, 0), (1, 0, 2), (-1, 0, -2), (0, 1, 0)]
HOODS = {"face": (0, port.DEFAULT_NEIGHBORHOOD_ID),
         "cube": (1, port.DEFAULT_NEIGHBORHOOD_ID), "reach2": (2, 7)}


@pytest.mark.parametrize("value", [None, "1", "4", "8", "0", "-3", "9", "12",
                                   "x", " 3 "])
def test_bulk_steps_per_pass_matches_reference(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("DCCRG_BULK_SPP", raising=False)
    else:
        monkeypatch.setenv("DCCRG_BULK_SPP", value)
    assert rx.bulk_steps_per_pass() == ref_rx.bulk_steps_per_pass()


def _hood_grid(dims, periodic, hood, dtype, seed):
    """A grid with the advection fields, seeded density and velocities
    of both signs, on neighbourhood ``hood``; returns ``(grid, hood
    id)``."""
    hood_len, hood_id = HOODS[hood]
    g = (port.Grid(cell_data={f: torch.float32 for f in FIELDS}, dtype=dtype)
         .set_initial_length(dims).set_periodic(*periodic)
         .set_maximum_refinement_level(0).set_neighborhood_length(hood_len)
         .initialize("cpu"))
    if hood == "reach2":
        assert g.add_neighborhood(hood_id, REACH2_HOOD)
    n0 = int(np.prod(dims))
    rng = np.random.default_rng(seed)
    for f, shift in (("density", 0.0), ("vx", 0.5), ("vy", 0.5)):
        v = rng.random(n0, dtype=np.float32) - np.float32(shift)
        g.data[f][0, :n0] = torch.from_numpy(v).to(dtype)
    return g, hood_id


@pytest.fixture
def spy(monkeypatch):
    """Counts the step loop's k-deep passes (with their k) and one-step
    passes, through to the real functions."""
    calls = {"deep": [], "one": 0}
    deep, one = rx.bulk_pass_k, rx.bulk_pass

    def bulk_pass_k(spec, kernel, fields, extras, k, out=None):
        calls["deep"].append(k)
        return deep(spec, kernel, fields, extras, k, out=out)

    def bulk_pass(spec, kernel, fields, extras, out=None):
        calls["one"] += 1
        return one(spec, kernel, fields, extras, out=out)

    monkeypatch.setattr(rx, "bulk_pass_k", bulk_pass_k)
    monkeypatch.setattr(rx, "bulk_pass", bulk_pass)
    return calls


@pytest.mark.parametrize("dims", [(17, 9, 5), (24, 20, 36)])
@pytest.mark.parametrize("hood", ["face", "cube", "reach2"])
@pytest.mark.parametrize("periodic", [(True, True, False), (True, True, True),
                                      (False, False, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 3, 8])
def test_deep_step_loop_matches_roll_path(k, dtype, periodic, hood, dims,
                                          spy, monkeypatch):
    """``run_steps`` under ``DCCRG_BULK_SPP=k``: 2k + 1 steps as two
    k-deep passes and one remainder step on the face set's plane route,
    one-step passes only on the other sets (at these sizes the step loop
    declines their bricks), bit for bit with the plain roll path on
    every row, pad rows and the zero row included."""
    monkeypatch.setenv("DCCRG_BULK_SPP", str(k))
    bulk, hood_id = _hood_grid(dims, periodic, hood, dtype, seed=k)
    roll, _ = _hood_grid(dims, periodic, hood, dtype, seed=k)
    kern = make_uniform_flux_kernel(tuple(1.0 / d for d in dims))
    dt = torch.tensor(0.4 / max(dims), dtype=torch.float32)
    n = 2 * k + 1
    bulk.run_steps(kern, FIELDS, ["density"], n, extra_args=(dt,),
                   neighborhood_id=hood_id)
    roll.run_steps(kern, FIELDS, ["density"], n, extra_args=(dt,),
                   neighborhood_id=hood_id, bulk=False)
    assert bulk.last_step_path == "bulk"
    assert roll.last_step_path == "roll"
    spec = rx._grid_spec_for(bulk, bulk.plan.hoods[hood_id])
    if hood == "face":
        assert spec.deep_pays(k)
        assert spy == {"deep": [k, k], "one": 1}
    else:
        assert not spec.deep_pays(k)
        assert spy == {"deep": [], "one": n}
    a, b = bulk.data["density"], roll.data["density"]
    assert a.dtype == dtype
    assert torch.equal(a, b)


def take_deep(monkeypatch):
    """Sets the step loop's cost rule (``PassSpec.deep_pays``) to take
    every route the kernel offers."""
    monkeypatch.setattr(rx.PassSpec, "deep_pays",
                        lambda self, k: self.deep(k) is not None)


@pytest.mark.parametrize("dims", [(17, 9, 5), (24, 20, 36)])
@pytest.mark.parametrize("hood", ["cube", "reach2"])
@pytest.mark.parametrize("periodic", [(True, True, False), (True, True, True),
                                      (False, False, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 3, 8])
def test_deep_step_loop_bricks_taken(k, dtype, periodic, hood, dims, spy,
                                     monkeypatch):
    """The step loop's k-deep branch on the sets that take bricks, with
    its cost rule set to take them (at these sizes it declines them):
    2k + 1 steps as two k-deep passes and one remainder step, bit for
    bit with the plain roll path on every row; one-step passes where
    the kernel declines the set (reach 2 from k = 6)."""
    monkeypatch.setenv("DCCRG_BULK_SPP", str(k))
    take_deep(monkeypatch)
    bulk, hood_id = _hood_grid(dims, periodic, hood, dtype, seed=k)
    roll, _ = _hood_grid(dims, periodic, hood, dtype, seed=k)
    kern = make_uniform_flux_kernel(tuple(1.0 / d for d in dims))
    dt = torch.tensor(0.4 / max(dims), dtype=torch.float32)
    n = 2 * k + 1
    bulk.run_steps(kern, FIELDS, ["density"], n, extra_args=(dt,),
                   neighborhood_id=hood_id)
    roll.run_steps(kern, FIELDS, ["density"], n, extra_args=(dt,),
                   neighborhood_id=hood_id, bulk=False)
    assert bulk.last_step_path == "bulk"
    spec = rx._grid_spec_for(bulk, bulk.plan.hoods[hood_id])
    if spec.deep(k) is None:
        assert hood == "reach2" and k == 8
        assert spy == {"deep": [], "one": n}
    else:
        assert spec.deep(k)[0] == "bricks"
        assert spy == {"deep": [k, k], "one": 1}
    assert torch.equal(bulk.data["density"], roll.data["density"])


@pytest.mark.parametrize("hood,dtype,k,atol", [
    ("cube", torch.float32, 2, 1e-6), ("cube", torch.float32, 4, 1e-6),
    ("face", torch.bfloat16, 2, 1e-7), ("face", torch.bfloat16, 4, 1e-7),
    ("cube", torch.bfloat16, 2, 1e-7)],
    ids=["cube-f32-2", "cube-f32-4", "face-bf16-2", "face-bf16-4",
         "cube-bf16-2"])
def test_deep_step_loop_matches_reference_bulk_executor(hood, dtype, k, atol,
                                                        spy, monkeypatch):
    """``run_steps`` on the 26-cube and on bfloat16 storage through the
    reference's k-deep Pallas passes (``compile_bulk_step_loop``,
    interpret mode) and the port's step loop: one k-deep pass and one
    remainder pass, on the 26-cube with the step loop's cost rule set
    to take the bricks (it declines bricks of so few blocks; on CPU
    tensors either route runs ``bulk_pass_k_plain``). On the 26-cube
    in float32 the reference's XLA CPU programs round a few near-zero
    cells of its 26-slot sum one ulp apart from the port's, on its
    one-step Pallas pass and its XLA roll path alike, so those cases
    take atol 1e-6, the tolerance of the reference's own
    bulk-against-roll tests (tests/test_bulk_executor.py)."""
    monkeypatch.setenv("DCCRG_BULK", "pallas")
    monkeypatch.setenv("DCCRG_BULK_SPP", str(k))
    take_deep(monkeypatch)
    dims = (16, 16, 8)  # two (8, 128) row groups: halos cross a tile edge
    periodic = (True, True, False)
    g, hood_id = _hood_grid(dims, periodic, hood, dtype, seed=k)
    ref = (RefGrid(cell_data={f: jnp.float32 for f in FIELDS},
                   dtype=jnp.bfloat16 if dtype == torch.bfloat16
                   else jnp.float32)
           .set_initial_length(dims).set_periodic(*periodic)
           .set_maximum_refinement_level(0)
           .set_neighborhood_length(HOODS[hood][0])
           .initialize(default_mesh(jax.devices()[:1])))
    assert (ref.plan.L, ref.plan.R) == (g.plan.L, g.plan.R)
    start = fields_to_numpy(g)
    for f in FIELDS:
        ref.data[f] = jax.device_put(start[f], ref.data[f].sharding)
    cell = tuple(1.0 / d for d in dims)
    dt = np.float32(0.4 / max(dims))
    n = k + 1
    ref.run_steps(ref_flux_kernel(cell), FIELDS, ["density"], n,
                  extra_args=(jnp.float32(dt),))
    g.run_steps(make_uniform_flux_kernel(cell), FIELDS, ["density"], n,
                extra_args=(torch.tensor(dt),), neighborhood_id=hood_id)
    assert any(key[0] == "bulksteploop" for key in ref._program_cache)
    assert g.last_step_path == "bulk"
    assert spy == {"deep": [k], "one": 1}
    want = np.asarray(ref.data["density"]).astype(np.float32)
    got = fields_to_numpy(g)["density"].astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("dims", [(17, 9, 5), (24, 20, 36), (512, 512, 512)])
@pytest.mark.parametrize("hood", ["face", "cube", "reach2"])
def test_route_rule(hood, dims, k):
    """The face set takes the plane route at every k: x cut into equal
    bands of whole warps (at most 256 columns), y into segments of at
    most 256 rows, one z-plane a block, and at 512³ at most 1.3
    thread-cells a useful cell-step and 1.3 times the bound's bytes
    (the parent's plane tiles: 1.5 / 1.875 / 2.34 and 1.18 / 1.45 /
    1.94 at k = 2 / 4 / 8). The 26-cube and the reach-2 neighbourhood
    take bricks whose rings fit two blocks an SM and whose staged plane
    fits the threads' elements; the reach-2 set is declined from k = 6,
    where no tile fits. The step loop takes the bricks only at k = 2,
    for 20 face terms or more (the 26-cube's 36, not the reach-2 set's
    5) and 128 blocks or more: at 512³."""
    g, hood_id = _hood_grid((8, 8, 8), (True, True, False), hood,
                            torch.float32, seed=0)
    s = rx._grid_spec_for(g, g.plan.hoods[hood_id])
    n0 = int(np.prod(dims))
    spec = rx.PassSpec(s.shifts, dims, s.periodic, s.offs_cells, s.offs_const,
                       n0, n0)
    deep = spec.deep(k)
    if k == 1 or (hood == "reach2" and k >= 6):
        assert deep is None and not spec.deep_pays(k)
        assert spec.deep_cost(k) is None
        return
    work, moved = spec.deep_cost(k)
    assert work >= 1 and moved >= 1
    if hood == "face":
        assert spec.reach() == (1, 1, 0)
        route, (bx, by, bz) = deep
        assert route == "planes" and spec.deep_pays(k)
        nx, ny, _ = dims
        bands = -(-nx // 256)
        assert bx % 32 == 0 and bx <= 256 and 0 <= bands * bx - nx < 32 * bands
        assert 1 <= by <= min(ny, 256) and bz == 1
        if dims == (512, 512, 512):
            assert work <= 1.3 and moved <= 1.3
            # the geometry in closed form: 288 lanes a 256 band, 2k
            # extra iterations a 256-row segment, 272 staged columns
            assert (bx, by) == (256, 256)
            assert work == pytest.approx(288 / 256 * (1 + 2 * k / 256))
            assert moved == pytest.approx(
                (3 * 272 / 256 * (1 + 2 * k / 256) + 1) / 4)
        return
    route, (bx, by, bz) = deep
    assert route == "bricks"
    assert all(1 <= b <= d for b, d in zip((bx, by, bz), dims))
    rx_, ry_, rz_ = spec.reach()
    w, h = bx + 2 * k * rx_, by + 2 * k * ry_
    smem = rx._brick_smem(w, h, k, rz_, len(spec.slots))
    # two blocks an SM: 228 KB less 1 KB a block
    assert 2 * (smem + 1024) <= 228 * 1024 and smem <= rx._MAX_SMEM
    assert 3 * w * h <= rx._BRICK_THREADS * rx._BRICK_ELEMS
    pays = hood == "cube" and dims == (512, 512, 512) and k == 2
    assert spec.deep_pays(k) == pays
    if pays:
        assert work <= 1.3


@pytest.mark.parametrize("vec", [True, False], ids=["vec", "elements"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("periodic", [(True, True, False), (False, False, False)])
@pytest.mark.parametrize("dims", [(17, 9, 5), (300, 20, 1), (40, 130, 2)])
def test_plane_route_blocking_emulated(dims, periodic, k, dtype, vec):
    """The plane route's blocking as ``PassSpec.deep`` hands it to the
    kernel, emulated lane by lane (tests/torch_bulk_k_emulation.py: the
    kernel's bands, segments, rings, skew and order of operations),
    equals the plain k-deep pass bit for bit: two ragged 160-column
    bands for 300, y cut into segments to fill the card (130 rows in
    three), and a halo wider than the (17, 9, 5) grid."""
    g, hood_id = _hood_grid(dims, periodic, "face", dtype, seed=k)
    spec = rx._grid_spec_for(g, g.plan.hoods[hood_id])
    kern = make_uniform_flux_kernel(tuple(1.0 / d for d in dims))
    n0 = spec.n0
    fields = {f: g.data[f][0, :g.plan.L] for f in FIELDS}
    extras = (torch.tensor(0.02),)
    want = rx.bulk_pass_k_plain(spec, kern, fields, extras, k)["density"]
    nx, ny, nz = dims
    got = emulate_planes(*(fields[f][:n0].float().reshape(nz, ny, nx)
                           for f in FIELDS), spec, k,
                         *rx._flux_coeffs(kern, 0.02), dtype, vec)
    assert torch.equal(got.reshape(-1), want[:n0].float())


def test_program_key_follows_the_variable(spy, monkeypatch):
    """A change of ``DCCRG_BULK_SPP`` builds a new program: the same
    grid runs 5 steps as 2 + 2 + 1 under k = 2, then 4 + 1 under
    k = 4, then five one-step passes unset."""
    a = GridAdvection(n=16, device="cpu")
    dt = 0.5 * a.max_time_step()
    monkeypatch.setenv("DCCRG_BULK_SPP", "2")
    a.run(5, dt)
    assert spy == {"deep": [2, 2], "one": 1}
    monkeypatch.setenv("DCCRG_BULK_SPP", "4")
    a.run(5, dt)
    assert spy == {"deep": [2, 2, 4], "one": 2}
    monkeypatch.delenv("DCCRG_BULK_SPP")
    a.run(5, dt)
    assert spy == {"deep": [2, 2, 4], "one": 7}
    assert a.grid.last_step_path == "bulk"


@pytest.mark.parametrize("k", [2, 5])
def test_bulk_pass_k_plain_is_k_single_steps(k):
    """The plain k-deep pass is k one-step passes, each rounded to
    bfloat16; on CPU tensors ``bulk_pass_k`` runs it and counts no
    launch, and ``out`` takes the result with the pad rows kept."""
    g, hood_id = _hood_grid((12, 10, 6), (True, False, True), "face",
                            torch.bfloat16, seed=k)
    spec = rx._grid_spec_for(g, g.plan.hoods[hood_id])
    kern = make_uniform_flux_kernel((1 / 12, 1 / 10, 1 / 6))
    L = g.plan.L
    fields = {f: g.data[f][0, :L] for f in FIELDS}
    extras = (torch.tensor(0.03),)
    cur = dict(fields)
    for _ in range(k):
        cur.update(rx.bulk_pass_plain(spec, kern, cur, extras))
    before = rx.bulk_pass_k.launches
    out = torch.full((L,), 7.0, dtype=torch.bfloat16)
    got = rx.bulk_pass_k(spec, kern, fields, extras, k, out=out)["density"]
    assert rx.bulk_pass_k.launches == before
    assert got is out and got.dtype == torch.bfloat16
    assert torch.equal(got, cur["density"])
    assert torch.equal(rx.bulk_pass_k_plain(spec, kern, fields, extras,
                                            k)["density"], cur["density"])


def test_bulk_pass_k_rejects_other_devices():
    a = GridAdvection(n=16, device="cpu")
    g = a.grid
    spec = rx._grid_spec_for(g, g.plan.hoods[port.DEFAULT_NEIGHBORHOOD_ID])
    fields = {f: g.data[f][0, :g.plan.L].to("meta") for f in FIELDS}
    with pytest.raises(ValueError):
        rx.bulk_pass_k(spec, a._kernel, fields, (torch.tensor(0.01),), 4)
