"""The tiled routes of a generated flux (``csrc/gen_tiles.cuh``): kernels
A and A' over a user ``SlotwiseKernel`` with its slot table compiled in,
on the CPU.

- The routes, replayed block by block with the kernel's own index map
  (tests/torch_gen_tiles_emulation.py: the staged tiles with their
  wrapped halos, the masked faces, the ring of planes, the pad rows, a
  fleet slot's unaligned base, the freeze), against the plain versions
  ``bulk_pass_plain`` / ``fleet_bulk_pass_plain``: bit for bit, at
  extents 1, 2, 3, 17 and 40 on lengths 0-2 and all eight
  periodicities.
- The specialised functor text (the table's slot sequence unrolled,
  ``Flux.slots_text``), built by g++ with ``-ffp-contract=off``, against
  the runtime-table functor: bit for bit.
- The emulated route over two steps against the reference's
  ``Grid.run_steps`` under ``DCCRG_BULK=pallas``: bit for bit on
  integer-valued fields, else within rtol 1e-6 / atol 1e-6.
- A user neighbourhood reaching 3 on the tiled route, and the forms
  the tile rule times (a tile of 64 along x, the async staging),
  replayed likewise.
- The rules: the form (``flux_gen.gen_form``), the tile and its shared
  memory (``PassSpec.gen_tile``, 8 fields at a reach of 2 and 3 under
  227 KB), the route by the shared memory alone (``gen_route``), and
  one source a (flux, table, form).
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dccrg_tpu.grid import Grid as RefGrid
from dccrg_tpu.grid import SlotwiseKernel as RefSlotwise
from dccrg_tpu.grid import default_mesh

import dccrg_tpu_torch as port
from dccrg_tpu_torch import DEFAULT_NEIGHBORHOOD_ID, convert, fleet
from dccrg_tpu_torch.models.advection import make_uniform_flux_kernel
from dccrg_tpu_torch.ops import _build, flux_gen
from dccrg_tpu_torch.ops import roll_executor as rx

import torch_flux_emulator as emu
import torch_gen_tiles_emulation as tiles
import torch_user_fluxes as uf

F32, BF16 = torch.float32, torch.bfloat16
PERIODIC = [(x, y, z) for x in (True, False) for y in (True, False)
            for z in (True, False)]
# extents of 1, 2, 3, 17 and 40: one tile and several along x and y,
# several z chunks (17 planes), a reach of 2 over extents of 1 and 2
DIMS = [(17, 3, 2), (2, 17, 1), (1, 2, 17), (40, 35, 3)]


def _cases():
    """name -> (kernel, storage dtypes, fields out, extras)."""
    return {
        "weighted": (uf.weighted_kernel(), {"v": F32, "w": F32}, ("v",), ()),
        "mix": (uf.mix_kernel(), {"a": F32, "b": BF16}, ("a", "b"),
                (torch.tensor(0.05),)),
        "gauss": (uf.gauss_kernel(), {"u": BF16}, ("u",),
                  (torch.tensor(0.1),)),
        "upwind_mixed": (make_uniform_flux_kernel((1 / 6, 1 / 5, 1 / 4)),
                         {"density": F32, "vx": BF16, "vy": BF16},
                         ("density",), (torch.tensor(0.01),)),
        "wrap_i32": (uf.wrap_kernel(), {"u": F32}, ("u",),
                     (torch.tensor(0.1),)),
    }


def _grid(cell_data, dims, periodic, hood_len, seed, integer=False):
    g = (port.Grid(cell_data=cell_data).set_initial_length(dims)
         .set_periodic(*periodic).set_maximum_refinement_level(0)
         .set_neighborhood_length(hood_len).initialize("cpu"))
    n0 = int(np.prod(dims))
    rng = np.random.default_rng(seed)
    for f, dt in cell_data.items():
        v = (rng.integers(0, 64, n0) if integer
             else rng.random(n0) - 0.5).astype(np.float32)
        g.data[f][0, :n0] = torch.from_numpy(v).to(dt)
    return g


def _case(name, dims, periodic, hood_len, seed=3):
    kern, cd, fout, ex = _cases()[name]
    g = _grid(cd, dims, periodic, hood_len, seed)
    flux = flux_gen.lower(kern, tuple(cd), fout, cd, len(ex), target="cpu")
    assert isinstance(flux, flux_gen.Flux), flux
    spec = rx._grid_spec_for(g, g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID], flux)
    fields = {f: g.data[f][0, :g.plan.L] for f in cd}
    return kern, flux, spec, fields, ex


@pytest.mark.parametrize("k", range(len(PERIODIC)))
@pytest.mark.parametrize("hood_len", [0, 1, 2])
@pytest.mark.parametrize("name", list(_cases()))
def test_tiles_emulated_bit_for_bit(name, hood_len, k):
    """Kernel A's tiled route, replayed block by block, gives the plain
    pass's bits: every cell through the staged tiles (wrapped halos,
    +0.0 outside a non-periodic face, the literal mask where the tile
    lies inside), the pad rows with every slot masked."""
    periodic = PERIODIC[k]
    kern, flux, spec, fields, ex = _case(name, DIMS[k % len(DIMS)],
                                         periodic, hood_len, seed=k)
    assert spec.gen_route() == "tiles"
    want = rx.bulk_pass_plain(spec, kern, fields, ex)
    got = tiles.bulk_pass_tiles(spec, fields, ex)
    for f in flux.fields_out:
        assert got[f].dtype == want[f].dtype
        assert torch.equal(got[f], want[f]), f


@pytest.mark.parametrize("k", range(len(PERIODIC)))
@pytest.mark.parametrize("hood_len", [0, 1, 2])
def test_fleet_tiles_emulated_bit_for_bit(hood_len, k):
    """Kernel A''s tiled route over a bucket of three grids of the user
    twin ``weighted_diffuse``, replayed block by block with each slot's
    rows at ``b * R`` (not aligned: R is odd or even by the plan), the
    middle slot frozen: the plain pass and its freeze, bit for bit,
    the zero row copied."""
    dims, periodic = DIMS[k % len(DIMS)], PERIODIC[k]
    g = _grid({"rho": F32}, dims, periodic, hood_len, seed=k)
    hood = g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID]
    cf = hood.closed_form
    spec = rx.FleetPassSpec(cf["dims"], cf["periodic"], cf["offsets"],
                            hood.offs_const, cf["n0"], g.plan.L)
    kern = uf.weighted_diffuse()
    flux = flux_gen.lower(kern, ("rho",), ("rho",), {"rho": F32}, 1,
                          target="cpu", batched=True)
    assert spec.gen_route(flux, 3) == "tiles"
    rng = np.random.default_rng(k)
    state = {"rho": torch.from_numpy(
        rng.random((3, spec.R)).astype(np.float32) * 10)}
    extras = torch.tensor([[0.02], [0.05], [0.1]], dtype=F32)
    budget = torch.tensor([2, 0, 2], dtype=torch.int32)
    plain = rx.fleet_bulk_pass_plain(spec, kern, state, extras, flux=flux)
    want = rx.fleet_freeze(plain["rho"], state["rho"], budget, 1)
    got = tiles.fleet_bulk_pass_tiles(spec, flux, state, extras, budget, 1)
    assert torch.equal(got["rho"], want)


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
@pytest.mark.parametrize("hood_len", [0, 1, 2])
@pytest.mark.parametrize("name", list(_cases()))
def test_specialised_functor_gxx_bit_for_bit(name, hood_len):
    """The slot sequence the tiled routes compile (the table unrolled,
    its offs_const rows literals, the mask a value of its own), built by
    g++ as host code with no contraction, against the runtime-table
    functor built the same way: bit for bit (``gauss`` too: both call
    the same ``expf``), and the plain pass bit for bit but for
    ``gauss``, within one bfloat16 ulp there (glibc's ``expf`` is not
    ATen's)."""
    kern, flux, spec, fields, ex = _case(name, (6, 5, 4), (True, False, True),
                                         hood_len)
    runtime = emu.run_gxx(emu.gxx_library(flux), flux, spec, fields, ex)
    got = emu.run_gxx(emu.gxx_specialised(flux, spec.gen_table), flux, spec,
                      fields, ex)
    want = rx.bulk_pass_plain(spec, kern, fields, ex)
    for f in flux.fields_out:
        assert torch.equal(got[f], runtime[f]), f
        if name == "gauss":
            tol = 2.0 ** -8 * float(want[f].float().abs().max())
            assert float((got[f].float() - want[f].float()).abs().max()) \
                <= tol
        else:
            assert torch.equal(got[f], want[f]), f


def _ref_weighted():
    def init(cell, *extra):
        return jnp.zeros(cell["v"].shape, jnp.float32)

    def slot(acc, cell, nbr, offs, mask, *extra):
        wgt = jnp.where(mask & (offs[..., 0] == 1), 2.0,
                        jnp.where(mask, 1.0, 0.0))
        return acc + wgt * jnp.where(mask, nbr["v"], 0.0) + jnp.where(
            mask, nbr["w"], 0.0)

    def finish(acc, cell, *extra):
        return {"v": cell["v"] + acc}

    return RefSlotwise(init, slot, finish)


def _ref_mix():
    def init(cell, dt):
        return (jnp.zeros(cell["a"].shape, jnp.float32),
                {"m": jnp.full(cell["b"].shape, -1.0, jnp.float32)})

    def slot(carry, cell, nbr, offs, mask, dt):
        s, rest = carry
        up = (offs[..., 2] < 0) | (offs[..., 0] > 0)
        d = jnp.clip(nbr["a"] - cell["a"], -0.75, 0.75)
        s = s + jnp.where(mask & up, d * 0.3, 0.0) + jnp.where(
            mask, nbr["b"] / 3.0, 0.0)
        m = jnp.maximum(rest["m"], jnp.where(mask, nbr["b"], -1.0))
        return s, {"m": m}

    def finish(carry, cell, dt):
        s, rest = carry
        hot = cell["a"] > 0.3
        return {"a": jnp.where(hot, cell["a"] - dt * s, cell["a"] + s / 7),
                "b": jnp.sqrt(jnp.abs(rest["m"])) + 1.0 - dt}

    return RefSlotwise(init, slot, finish)


@pytest.mark.parametrize("case", ["weighted", "mix"])
def test_tiles_match_reference_bulk_executor(case, monkeypatch):
    """Two steps of kernel A's emulated tiled route against the
    reference's ``Grid.run_steps`` under ``DCCRG_BULK=pallas`` (Pallas
    in interpret mode, one device) on the same bytes: bit for bit on
    the integer-valued fields of test_slotwise's kernel, else within
    rtol 1e-6 / atol 1e-6."""
    dims, periodic = (16, 8, 8), (True, True, False)
    if case == "weighted":
        kern, ref_kern, cd, fout, ex = (uf.weighted_kernel(), _ref_weighted(),
                                        {"v": F32, "w": F32}, ("v",), ())
    else:
        kern, ref_kern, cd, fout, ex = (uf.mix_kernel(), _ref_mix(),
                                        {"a": F32, "b": F32}, ("a", "b"),
                                        (0.05,))
    integer = case == "weighted"
    g = _grid(cd, dims, periodic, 1, seed=11, integer=integer)
    init = convert.fields_to_numpy(g)
    flux = flux_gen.lower(kern, tuple(cd), fout, cd, len(ex), target="cpu")
    spec = rx._grid_spec_for(g, g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID], flux)
    fields = {f: g.data[f][0, :g.plan.L].clone() for f in cd}
    ext = tuple(torch.tensor(e, dtype=F32) for e in ex)
    for _ in range(2):
        fields.update(tiles.bulk_pass_tiles(spec, fields, ext))

    monkeypatch.setenv("DCCRG_BULK", "pallas")
    r = (RefGrid(cell_data={f: jnp.float32 for f in cd})
         .set_initial_length(dims).set_periodic(*periodic)
         .set_maximum_refinement_level(0).set_neighborhood_length(1)
         .initialize(default_mesh(jax.devices()[:1])))
    n0 = int(np.prod(dims))
    for f in cd:
        r.data[f] = r.data[f].at[0, :n0].set(jnp.asarray(init[f][0, :n0]))
    r.run_steps(ref_kern, list(cd), list(fout), 2,
                extra_args=tuple(jnp.float32(e) for e in ex))
    assert any(k[0] == "bulksteploop" for k in r._program_cache)
    for f in fout:
        got = fields[f][:n0].numpy()
        want = np.asarray(r.data[f][0][:n0])
        if integer:
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _eight():
    """A flux staging 8 float32 fields, a light slot (8 adds)."""
    eight = {f"f{i}": F32 for i in range(8)}

    def slot(acc, c, n, offs, mask):
        return acc + sum(torch.where(mask, n[f], 0.0) for f in eight)

    kern = port.SlotwiseKernel(lambda c: torch.zeros_like(c["f0"]), slot,
                               lambda acc, c: {"f0": c["f0"] + acc})
    return kern, eight, flux_gen.lower(kern, tuple(eight), ("f0",), eight, 0,
                                       target="cpu")


def test_tile_rule():
    """The tiled route's form and blocking (``flux_gen.gen_form``,
    ``PassSpec.gen_tile``): 256 threads, a tile of 32 x 8 * cells (64 x
    4 * cells on grids at least 64 wide); launch bounds of two blocks
    an SM; the async staging where float32 and bfloat16 fields are
    staged together; the cells a thread by the rule (4; 2 for more than two
    staged fields or from 512 float instructions a cell, exp at 8; 1
    from 1024: the smoke's ``weighted``, the mixed upwind flux,
    ``gauss``, and the tile rule's cases either side of the
    thresholds); the shared memory of 8 staged fields at a reach of 2
    and of 3 under a block's 227 KB (232,448 bytes), the cells halved
    where the ring would not fit; the z chunk cut until about 2048
    blocks; the route by the shared memory alone."""
    GF = flux_gen.GenForm
    _kern, eight, flux = _eight()
    assert flux.staged() == tuple(range(8))
    g = _grid(eight, (64, 64, 64), (True,) * 3, 2, seed=0)
    spec = rx._grid_spec_for(g, g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID], flux)
    tx, ty, zc, ring, smem = spec.gen_tile()
    assert spec.reach() == (2, 2, 2) and ring == 6
    # 9 adds a slot over 124 slots, 1116 a cell: a heavy cell, 1 a
    # thread, a 64-wide grid's tile of 64
    assert spec.gen_form() == GF(1, 2, 64, "regs")
    assert (tx, ty) == (64, 4)
    assert smem == 4 * 6 * 8 * 68 * 8 == 104448 <= 232448
    assert spec.gen_route() == "tiles"
    assert flux_gen.gen_form(flux, spec.gen_table) == GF(1, 2, 32)
    assert flux_gen.gen_form(flux, spec.gen_table, 63) == GF(1, 2, 32)
    # the most the rule stages at a reach of 2 and 3 fits: 8 fields at 2
    # cells a thread, 2 fields at 4, tiles of 32 or 64
    two, four = GF(2, 2), GF(4, 2)
    assert rx.gen_tile((64,) * 3, (2, 2, 2), 8, two)[4] == 138240 <= 232448
    assert rx.gen_tile((64,) * 3, (3, 3, 3), 8, two)[4] == 214016 <= 232448
    assert rx.gen_tile((64,) * 3, (3, 3, 3), 8, GF(2, 2, 64))[4] == \
        4 * 8 * 8 * 70 * 14 == 250880 > 232448
    assert rx.gen_tile((64,) * 3, (2, 2, 2), 2, four)[4] == 62208
    # the tile of 64 along x: 4 threads along y
    assert GF(2, 2, 64).tile() == (64, 8)
    assert rx.gen_tile((64,) * 3, (1, 1, 1), 1, GF(4, 2, 64))[:2] == (64, 16)
    # the cells a thread by the smoke's cases (a)-(c) on 512^3 / 128^3;
    # the mixed upwind flux (float32 and bfloat16 staged) by cp.async
    for name, hood_len, want, stage in (
            ("weighted", 1, 4, "regs"), ("upwind_mixed", 0, 2, "async"),
            ("gauss", 2, 1, "regs")):
        _k, f, s, _fields, _ex = _case(name, (8, 8, 8), (True,) * 3,
                                       hood_len)
        assert s.gen_form() == GF(want, 2, 32, stage), name
        assert flux_gen.gen_form(f, s.gen_table, 512) == \
            GF(want, 2, 64, stage)
    # the tile rule's cases: float instructions a cell and the cells
    from dccrg_tpu_torch import user_kernels as uk

    cube = _case("weighted", (8, 8, 8), (True,) * 3, 1)[2].gen_table
    cube2 = _case("weighted", (8, 8, 8), (True,) * 3, 2)[2].gen_table
    for kern, cd, table, work, cells in (
            (uk.polynomial(3), {"u": F32}, cube, 208, 4),
            (uk.polynomial(7), {"u": F32}, cube, 416, 4),
            (uk.polynomial(11), {"u": F32}, cube, 624, 2),
            (uk.weighted(), {"v": F32, "w": F32}, cube2, 372, 4),
            (uk.gauss(), {"u": BF16}, cube2, 1612, 1),
            (uk.field_sum(4), {f"f{i}": F32 for i in range(4)}, cube, 104,
             2)):
        fout = ("f0",) if "f0" in cd else (tuple(cd)[:1])
        f = flux_gen.lower(kern, tuple(cd), fout, cd, 0 if "v" in cd else 1,
                           target="cpu")
        assert f.slot.flops(flux_gen.INSTR_WEIGHTS) * len(table.cells) \
            == work
        assert flux_gen.gen_form(f, table, 256).cells == cells, work
    # 512^3, 2 fields, 4 cells a thread: 16 x 16 tiles, 8 z chunks
    assert rx.gen_tile((512,) * 3, (1, 1, 1), 2, four) == (
        32, 32, 64, 4, 4 * 4 * 2 * 34 * 34)
    assert rx.gen_tile((512,) * 3, (1, 1, 1), 2, GF(4, 2, 64)) == (
        64, 16, 64, 4, 4 * 4 * 2 * 66 * 18)
    # a bucket of 128 grids of 64^3: 2 x 2 tiles a grid, 4 z chunks; or
    # 4 bands of 64 x 16, 4 z chunks
    assert rx.gen_tile((64,) * 3, (1, 1, 1), 1, four, 128)[2] == 16
    assert rx.gen_tile((64,) * 3, (1, 1, 1), 1, GF(4, 2, 64), 128)[2] == 16
    assert rx.gen_route(232448) == "tiles"
    assert rx.gen_route(232449) == "table"
    # a reach of 5 over 8 light fields: 2 cells a thread would take
    # 4 * 12 * 8 * 42 * 26 = 419,328 bytes, 1 takes 4 * 12 * 8 * 42 *
    # 18 = 290,304: no tile fits, the runtime-table route
    far = flux_gen.SlotTable([(5, 0, 0), (0, 5, 0), (0, 0, 5)],
                             [(5, 0, 0), (0, 5, 0), (0, 0, 5)])
    form = flux_gen.gen_form(flux, far)
    assert form == GF(1, 2)
    assert rx.gen_route(rx.gen_tile((64,) * 3, far.reach, 8, form)[4]) \
        == "table"
    # a reach of 4: 2 cells would take 4 * 10 * 8 * 40 * 24 = 307,200
    # bytes, so 1 (4 * 10 * 8 * 40 * 16 = 204,800): the tiled route
    mid = flux_gen.SlotTable([(4, 0, 0), (0, 4, 0), (0, 0, 4)],
                             [(4, 0, 0), (0, 4, 0), (0, 0, 4)])
    form = flux_gen.gen_form(flux, mid)
    assert form.cells == 1 and form.smem(mid.reach, 8) == 204800
    # on a 64-wide grid a reach of 3 at 2 cells: the tile of 64 does
    # not fit (250,880 bytes), 1 cell does (4 * 8 * 8 * 70 * 10)
    three = flux_gen.SlotTable([(3, 0, 0), (0, 3, 0), (0, 0, 3)],
                               [(3, 0, 0), (0, 3, 0), (0, 0, 3)])
    form = flux_gen.gen_form(flux, three, 64)
    assert form == GF(1, 2, 64) and form.smem(three.reach, 8) == 179200
    # a user neighbourhood reaching 3 (a grid of length 3) takes the
    # tiled route
    g = (port.Grid(cell_data={"u": F32}).set_initial_length((12, 10, 9))
         .set_periodic(True, True, False).set_maximum_refinement_level(0)
         .set_neighborhood_length(3).initialize("cpu"))
    assert g.add_neighborhood(7, [(3, 0, 0), (-3, 1, 0), (0, 0, 2)])
    kern, cd, fout, ex = _cases()["wrap_i32"]
    f3 = flux_gen.lower(kern, tuple(cd), fout, cd, len(ex), target="cpu")
    s3 = rx._grid_spec_for(g, g.plan.hoods[7], f3)
    assert s3.reach() == (3, 1, 2) and s3.gen_route() == "tiles"


# a user neighbourhood reaching 3 along each axis in turn
HOOD3 = [(3, 0, 0), (-3, 1, 0), (0, 0, 2), (1, -3, 0), (0, 2, -3),
         (-1, -1, 1)]


def _reach3(name, dims, periodic, seed):
    kern, cd, fout, ex = _cases()[name]
    g = (port.Grid(cell_data=cd).set_initial_length(dims)
         .set_periodic(*periodic).set_maximum_refinement_level(0)
         .set_neighborhood_length(3).initialize("cpu"))
    assert g.add_neighborhood(7, HOOD3)
    n0 = int(np.prod(dims))
    rng = np.random.default_rng(seed)
    for f, dt in cd.items():
        v = (rng.random(n0) - 0.5).astype(np.float32)
        g.data[f][0, :n0] = torch.from_numpy(v).to(dt)
    flux = flux_gen.lower(kern, tuple(cd), fout, cd, len(ex), target="cpu")
    spec = rx._grid_spec_for(g, g.plan.hoods[7], flux)
    fields = {f: g.data[f][0, :g.plan.L] for f in cd}
    return kern, flux, spec, fields, ex


@pytest.mark.parametrize("k", range(len(PERIODIC)))
@pytest.mark.parametrize("name", ["weighted", "mix", "wrap_i32"])
def test_tiles_reach3_emulated_bit_for_bit(name, k):
    """A user neighbourhood reaching 3 takes the tiled route (its ring of
    8 planes, a halo of 3): replayed block by block it gives the plain
    pass's bits on every periodicity, over extents of 2 (a reach of 3
    wraps more than one period), 5 and 33 (two tiles along x)."""
    dims = [(33, 5, 4), (5, 2, 7), (2, 9, 5), (4, 3, 2)][k % 4]
    kern, flux, spec, fields, ex = _reach3(name, dims, PERIODIC[k], seed=k)
    assert spec.reach() == (3, 3, 3) and spec.gen_route() == "tiles"
    want = rx.bulk_pass_plain(spec, kern, fields, ex)
    got = tiles.bulk_pass_tiles(spec, fields, ex)
    for f in flux.fields_out:
        assert torch.equal(got[f], want[f]), f


FORMS = [flux_gen.GenForm(4, 1, 64), flux_gen.GenForm(2, 1, 64, "async"),
         flux_gen.GenForm(1, 2, 64), flux_gen.GenForm(4, 1, 32, "async")]


@pytest.mark.parametrize("form", FORMS, ids=lambda f: "x".join(map(str, f)))
@pytest.mark.parametrize("name", ["weighted", "upwind_mixed"])
def test_tiles_forms_emulated_bit_for_bit(name, form):
    """The tiled route in the other forms the tile rule times (a tile of
    64 along x, the async staging, 1, 2 or 4 cells a thread) replays
    to the plain pass's bits: tiles of 64 across extents of 70 and 40
    (a partial tile), a non-periodic face in x and z."""
    kern, flux, spec, fields, ex = _case(name, (70, 11, 5),
                                         (False, True, False), 1)
    want = rx.bulk_pass_plain(spec, kern, fields, ex)
    got = tiles.bulk_pass_tiles(spec, fields, ex, form)
    for f in flux.fields_out:
        assert torch.equal(got[f], want[f]), f


@pytest.mark.parametrize("form", FORMS, ids=lambda f: "x".join(map(str, f)))
def test_fleet_tiles_forms_emulated_bit_for_bit(form):
    """Kernel A''s tiled route in the tile rule's other forms over a
    bucket of three grids of ``weighted_diffuse`` (the band of a whole
    x extent: a tile of 64 over 64 cells of x), the middle slot
    frozen: the plain pass and its freeze, bit for bit."""
    g = _grid({"rho": F32}, (64, 6, 3), (True, True, True), 1, seed=5)
    hood = g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID]
    cf = hood.closed_form
    spec = rx.FleetPassSpec(cf["dims"], cf["periodic"], cf["offsets"],
                            hood.offs_const, cf["n0"], g.plan.L)
    kern = uf.weighted_diffuse()
    flux = flux_gen.lower(kern, ("rho",), ("rho",), {"rho": F32}, 1,
                          target="cpu", batched=True)
    rng = np.random.default_rng(5)
    state = {"rho": torch.from_numpy(
        rng.random((3, spec.R)).astype(np.float32) * 10)}
    extras = torch.tensor([[0.02], [0.05], [0.1]], dtype=F32)
    budget = torch.tensor([2, 0, 2], dtype=torch.int32)
    plain = rx.fleet_bulk_pass_plain(spec, kern, state, extras, flux=flux)
    want = rx.fleet_freeze(plain["rho"], state["rho"], budget, 1)
    got = tiles.fleet_bulk_pass_tiles(spec, flux, state, extras, budget, 1,
                                      form)
    assert torch.equal(got["rho"], want)


def test_one_source_a_flux_and_table(monkeypatch):
    """The library's key is the specialised text: the same functor over
    two tables gives two sources, over the same table one; the source
    of a table holds both routes' entry points (kernel A's or A''s);
    ``fleet_library_name`` names the bucket's specialised source."""
    kern = uf.mix_kernel()
    cd = {"a": F32, "b": BF16}
    flux = flux_gen.lower(kern, ("a", "b"), ("a", "b"), cd, 1, target="cpu")
    t = {}
    for hood_len in (0, 1):
        g = _grid(cd, (6, 5, 4), (True, True, True), hood_len, seed=1)
        t[hood_len] = rx._grid_spec_for(
            g, g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID], flux).gen_table
    g = _grid(cd, (9, 3, 7), (False, True, False), 1, seed=2)
    again = rx._grid_spec_for(g, g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID],
                              flux).gen_table
    assert again.key == t[1].key and again.key != t[0].key
    src = {h: flux_gen.source(flux, tab) for h, tab in t.items()}
    assert src[0] != src[1] and flux_gen.source(flux, again) == src[1]
    # a form of its own (the tile rule's timing) is a source of its own
    form = flux_gen.GenForm(2, 1, 64, "async")
    other = flux_gen.source(flux, t[1], form)
    assert other != src[1] and "kTX = 64;" in other and \
        "kAsync = true;" in other
    assert flux_gen.source(flux, t[1], flux_gen.gen_form(flux, t[1])) \
        == src[1]
    with pytest.raises(ValueError):
        flux_gen.source(flux, t[1], flux_gen.GenForm(2, 1, 48))
    names = {_build.generated_name(s) for s in src.values()}
    assert len(names) == 2
    assert _build.generated_name(flux_gen.source(flux, again)) in names
    for s in src.values():
        assert '#include "gen_tiles.cuh"' in s and flux.text in s
        assert "int dccrg_gen_direct(" in s and "int dccrg_gen_tiles(" in s
        assert "int dccrg_gen_fleet" not in s
    assert [s.count("nb.template get<") for s in (src[0], src[1])] == [6, 26]
    assert "nb.template get<25, 1, 1, 1>(y, n);" in src[1]
    twin = flux_gen.lower(uf.weighted_diffuse(), ("rho",), ("rho",),
                          {"rho": F32}, 1, target="cpu", batched=True)
    fsrc = flux_gen.source(twin, t[1])
    assert "int dccrg_gen_fleet(" in fsrc and \
        "int dccrg_gen_fleet_tiles(" in fsrc and "dccrg_gen_tiles(" not in fsrc

    uf.register_weighted_diffuse()
    job = fleet.FleetJob("w", length=(6, 5, 4), kernel="weighted_diffuse",
                         n_steps=2, params=(0.05,), seed=1,
                         cell_data={"rho": F32})
    b = fleet.GridBatch(job, 2, device="cpu")
    # the card's lowering needs the card: the CPU's functor stands in
    monkeypatch.setattr(rx, "lowered", lambda *a, **k: twin)
    name = rx.fleet_library_name(b.grid, b.bulk_kernel, ("rho",), ("rho",),
                                 1)
    hood = b.grid.plan.hoods[DEFAULT_NEIGHBORHOOD_ID]
    table = flux_gen.SlotTable(hood.closed_form["offsets"], hood.offs_const)
    src = flux_gen.source(twin, table)
    assert name == f"lib{_build.generated_name(src)}.so"
