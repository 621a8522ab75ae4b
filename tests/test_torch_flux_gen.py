"""The flux generator (``dccrg_tpu_torch/ops/flux_gen.py``): any user
``SlotwiseKernel`` through kernels A and A', on the CPU.

- The lowering, emulated (tests/torch_flux_emulator.py: every lowered
  instruction in NumPy, rounded per op) and the generated functor
  itself, built as host code by g++ with ``-ffp-contract=off``, against
  the plain slot loop (``bulk_pass_plain``): bit for bit; the functor's
  ``expf`` (glibc, not ATen's) within one bfloat16 ulp of the output's
  largest magnitude.
- ``Grid.run_steps`` with a user kernel takes the bulk path, equals the
  plain roll path bit for bit and the reference's ``Grid.run_steps``
  under ``DCCRG_BULK=pallas`` (Pallas in interpret mode, one device):
  bit for bit on integer-valued fields, else within rtol 1e-6 / atol
  1e-6.
- The declines (a branch on a value, a sum over the cells, an op
  outside the set) return their reason, count it and log it once; the
  plain path runs.
- A ``GridBatch`` bucket of a registered user twin takes kernel A''s
  program and matches the reference's bulk bucket within rtol 1e-6 /
  atol 1e-5.
"""

import logging
import shutil
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dccrg_tpu import fleet as ref_fleet
from dccrg_tpu.grid import Grid as RefGrid
from dccrg_tpu.grid import SlotwiseKernel as RefSlotwise
from dccrg_tpu.grid import default_mesh

import dccrg_tpu_torch as port
from dccrg_tpu_torch import DEFAULT_NEIGHBORHOOD_ID, convert, fleet
from dccrg_tpu_torch.models.advection import make_uniform_flux_kernel
from dccrg_tpu_torch.ops import flux_gen
from dccrg_tpu_torch.ops import roll_executor as rx

import torch_flux_emulator as emu
import torch_user_fluxes as uf

F32, BF16 = torch.float32, torch.bfloat16
DIMS = (6, 5, 4)
# the reference's bulk pass takes grids of whole (8, 128) tiles
REF_DIMS = (16, 8, 8)


def _grid(cell_data, dims, periodic, hood_len, seed, integer=False,
          shift=0.5):
    g = (port.Grid(cell_data=cell_data).set_initial_length(dims)
         .set_periodic(*periodic).set_maximum_refinement_level(0)
         .set_neighborhood_length(hood_len).initialize("cpu"))
    n0 = int(np.prod(dims))
    rng = np.random.default_rng(seed)
    for f, dt in cell_data.items():
        v = (rng.integers(0, 64, n0) if integer
             else rng.random(n0) - shift).astype(np.float32)
        g.data[f][0, :n0] = torch.from_numpy(v).to(dt)
    return g


def _cases():
    """name -> (kernel, storage dtypes, fields out, extras)."""
    dt = (torch.tensor(0.05),)
    return {
        "weighted": (uf.weighted_kernel(), {"v": F32, "w": F32}, ("v",), ()),
        "upwind": (make_uniform_flux_kernel((1 / 6, 1 / 5, 1 / 4)),
                   {"density": F32, "vx": F32, "vy": F32}, ("density",),
                   (torch.tensor(0.01),)),
        "upwind_mixed": (make_uniform_flux_kernel((1 / 6, 1 / 5, 1 / 4)),
                         {"density": F32, "vx": BF16, "vy": BF16},
                         ("density",), (torch.tensor(0.01),)),
        "diffuse": (fleet.FLEET_BULK_KERNELS["diffuse"], {"rho": F32},
                    ("rho",), dt),
        "diffuse_bf16": (fleet.FLEET_BULK_KERNELS["diffuse"], {"rho": BF16},
                         ("rho",), dt),
        "advect_x_bf16": (fleet.FLEET_BULK_KERNELS["advect_x"],
                          {"rho": BF16}, ("rho",), (torch.tensor(0.4),)),
        "mix_bf16": (uf.mix_kernel(), {"a": BF16, "b": BF16}, ("a", "b"), dt),
        "mix_mixed": (uf.mix_kernel(), {"a": F32, "b": BF16}, ("a", "b"),
                      dt),
        "gauss": (uf.gauss_kernel(), {"u": BF16}, ("u",),
                  (torch.tensor(0.1),)),
        "wrap_i32": (uf.wrap_kernel(), {"u": F32}, ("u",),
                     (torch.tensor(0.1),)),
    }


def _lowered_case(name, hood_len, periodic):
    kern, cd, fout, ex = _cases()[name]
    g = _grid(cd, DIMS, periodic, hood_len, seed=hood_len + 3)
    flux = flux_gen.lower(kern, tuple(cd), fout, cd, len(ex), target="cpu")
    assert isinstance(flux, flux_gen.Flux), flux
    spec = rx._grid_spec_for(g, g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID], flux)
    fields = {f: g.data[f][0, :g.plan.L] for f in cd}
    want = rx.bulk_pass_plain(spec, kern, fields, ex)
    return kern, flux, spec, fields, ex, want


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("periodic", [(True, True, False),
                                      (False, False, False)])
@pytest.mark.parametrize("hood_len", [0, 1, 2])
@pytest.mark.parametrize("name", list(_cases()))
def test_lowering_emulated_bit_for_bit(name, hood_len, periodic):
    """Every lowered instruction, run in NumPy with its rounding, gives
    the plain slot loop's bits: test_slotwise's kernel, the named
    fluxes' own slot functions (the upwind flux over mixed dtypes too),
    bfloat16 kernels, and the exp kernel of the smoke's case (c)."""
    _k, flux, spec, fields, ex, want = _lowered_case(name, hood_len,
                                                     periodic)
    got = emu.run_flux(flux, spec, fields, ex)
    for f, w in want.items():
        assert np.array_equal(_bits(got[f]), _bits(w.float().numpy())), f


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
@pytest.mark.parametrize("hood_len", [0, 2])
@pytest.mark.parametrize("name", list(_cases()))
def test_generated_functor_gxx_bit_for_bit(name, hood_len):
    """The generated functor's C++ text, built by g++ as host code with
    round-to-nearest-even bfloat16 and no contraction, against the plain
    slot loop: bit for bit; ``expf`` (glibc) within one bfloat16 ulp of
    the output's largest magnitude (it is not ATen's exp)."""
    _k, flux, spec, fields, ex, want = _lowered_case(
        name, hood_len, (True, False, True))
    got = emu.run_gxx(emu.gxx_library(flux), flux, spec, fields, ex)
    for f, w in want.items():
        assert got[f].dtype == w.dtype
        if name == "gauss":
            tol = 2.0 ** -8 * float(w.float().abs().max())
            assert float((got[f].float() - w.float()).abs().max()) <= tol
        else:
            assert torch.equal(got[f], w), f


def test_functor_text_and_cache():
    """The functor states its fields, carry and offs use; the lowering
    is cached in the grid's program cache per kernel, fields, dtypes and
    form, and the source (specialised to a slot table) holds the functor
    and the entry points of its form."""
    kern = uf.mix_kernel()
    cd = {"a": F32, "b": BF16}
    g = _grid(cd, DIMS, (True, True, True), 1, seed=1)
    a = rx.lowered(g, kern, ("a", "b"), ("a", "b"), 1)
    assert rx.lowered(g, kern, ("a", "b"), ("a", "b"), 1) is a
    assert rx.lowered(g, kern, ("a", "b"), ("a", "b"), 1, batched=True) \
        is not a
    for line in ("kIn = 2", "kOut = 2", "kCarry = 2", "kOffs = true",
                 "flux_rt::ld_f32(in[0], i)", "flux_rt::st_bf16(out[1], i"):
        assert line in a.text
    assert a.n_carry == 2 and a.offs_used and a.nbr_used == (0, 1)
    table = rx._grid_spec_for(g, g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID],
                              a).gen_table
    src = flux_gen.source(a, table)
    assert '#include "gen_tiles.cuh"' in src and a.text in src
    direct, fleet_ = 'int dccrg_gen_direct(', 'int dccrg_gen_fleet('
    assert direct in src and fleet_ not in src
    fsrc = flux_gen.source(rx.lowered(g, kern, ("a", "b"), ("a", "b"), 1,
                                      batched=True), table)
    assert fleet_ in fsrc and direct not in fsrc


def test_generated_source_build(tmp_path, monkeypatch):
    """A generated source is written into the build directory by the
    hash of its text, headers and flags, and built by one nvcc process
    per source started together (``_build.start`` / ``finish``; a
    stand-in compiler here): the library lands under its name, the
    compiler's output and its seconds (to the process's end, however
    late ``finish`` is called) come back, and a failed compile
    raises with the compiler's output."""
    from dccrg_tpu_torch.ops import _build

    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\n"
                    "for a; do prev=$cur; cur=$a; "
                    "[ \"$prev\" = -o ] && out=$a; done\n"
                    "grep -q FAIL \"$cur\" && echo 'error: no' && exit 1\n"
                    "echo 'ptxas info    : Used 8 registers'; : > \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    kern = uf.weighted_kernel()
    flux = flux_gen.lower(kern, ("v", "w"), ("v",), {"v": F32, "w": F32}, 0,
                          target="cpu")
    text = flux_gen.source(flux, flux_gen.SlotTable([(1, 0, 0)], [(1, 0, 0)]))
    name = _build.write_generated(text)
    assert name == _build.generated_name(text) == f"gen-{name[4:]}"
    assert (tmp_path / "build" / f"{name}.cu").read_text() == text
    procs = _build.start([name])
    time.sleep(1.5)
    secs = {}
    logs = _build.finish(procs, secs)
    # the seconds end where the process ended, not at the late finish
    assert "Used 8 registers" in logs[name] and 0 <= secs[name] < 1.0
    assert (tmp_path / "build" / f"lib{name}.so").exists()
    assert _build.start([name]) == {}  # built: nothing to start
    bad = _build.write_generated(text + "// FAIL\n")
    with pytest.raises(RuntimeError, match="error: no"):
        _build.build([bad])
    assert not (tmp_path / "build" / f"lib{bad}.so").exists()


def test_cpu_scalar_readings():
    """ATen's readings of a CPU scalar beside a tensor, as measured on
    this host: every probed op has one, and a bfloat16 add, multiply
    and divide by a 0-d float32 tensor give the bits the table's reading
    predicts."""
    sem = flux_gen.aten_semantics("cpu")
    assert all(v is not None for v in sem.values())
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(256, generator=g) + 0.1).to(BF16)
    s = torch.tensor(0.3)
    for op, fn in (("mul", torch.mul), ("add", torch.add),
                   ("div", torch.div)):
        mode, recip = sem[(op, 2, "bf16", "tensor")]
        read = s if mode == "opmath" else s.to(BF16).float()
        want = (x.float() * (1 / read) if recip else fn(x.float(), read))
        assert torch.equal(fn(x, s), want.to(BF16)), op


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
def test_run_steps_user_kernel(case, monkeypatch):
    """``Grid.run_steps`` with a user kernel on a closed-form plan: the
    bulk path, bit for bit with the plain roll path, and against the
    reference's ``DCCRG_BULK=pallas`` run on the same bytes: bit for bit
    on the integer-valued fields of test_slotwise, else within rtol 1e-6
    / atol 1e-6."""
    periodic = (True, True, False)
    if case == "weighted":
        kern, ref_kern, cd, fout, ex = (uf.weighted_kernel(), _ref_weighted(),
                                        {"v": F32, "w": F32}, ("v",), ())
    else:
        kern, ref_kern, cd, fout, ex = (uf.mix_kernel(), _ref_mix(),
                                        {"a": F32, "b": F32}, ("a", "b"),
                                        (0.05,))
    integer = case == "weighted"
    a, b = (_grid(cd, REF_DIMS, periodic, 1, seed=11, integer=integer)
            for _ in range(2))
    init = convert.fields_to_numpy(a)
    a.run_steps(kern, list(cd), list(fout), 2, extra_args=ex)
    b.run_steps(kern, list(cd), list(fout), 2, extra_args=ex, bulk=False)
    assert (a.last_step_path, b.last_step_path) == ("bulk", "roll")
    for f in fout:
        assert torch.equal(a.data[f], b.data[f])

    monkeypatch.setenv("DCCRG_BULK", "pallas")
    r = (RefGrid(cell_data={f: jnp.float32 for f in cd})
         .set_initial_length(REF_DIMS).set_periodic(*periodic)
         .set_maximum_refinement_level(0).set_neighborhood_length(1)
         .initialize(default_mesh(jax.devices()[:1])))
    n0 = int(np.prod(REF_DIMS))
    for f in cd:
        r.data[f] = r.data[f].at[0, :n0].set(jnp.asarray(init[f][0, :n0]))
    r.run_steps(ref_kern, list(cd), list(fout), 2,
                extra_args=tuple(jnp.float32(e) for e in ex))
    assert any(k[0] == "bulksteploop" for k in r._program_cache)
    got = convert.fields_to_numpy(a)
    for f in fout:
        want = np.asarray(r.data[f][0][:n0])
        if integer:
            assert np.array_equal(got[f][0, :n0], want)
        else:
            np.testing.assert_allclose(got[f][0, :n0], want, rtol=1e-6,
                                       atol=1e-6)


def test_generated_flux_takes_no_k_deep_pass(monkeypatch):
    """Under ``DCCRG_BULK_SPP=k`` a generated flux runs n one-step
    passes (its spec declines the k-deep pass), bit for bit with the
    plain roll path."""
    monkeypatch.setenv("DCCRG_BULK_SPP", "2")
    cd = {"v": F32, "w": F32}
    a, b = (_grid(cd, DIMS, (True, True, False), 1, seed=4) for _ in range(2))
    kern = uf.weighted_kernel()
    flux = rx.lowered(a, kern, ("v", "w"), ("v",), 0)
    spec = rx._grid_spec_for(a, a.plan.hoods[DEFAULT_NEIGHBORHOOD_ID], flux)
    assert spec.gen and spec.deep(2) is None and not spec.deep_pays(2)
    passes = []
    plain = rx.bulk_pass_plain
    monkeypatch.setattr(rx, "bulk_pass_k", lambda *a, **k: 1 / 0)
    monkeypatch.setattr(rx, "bulk_pass_plain",
                        lambda *a, **k: passes.append(1) or plain(*a, **k))
    a.run_steps(kern, ["v", "w"], ["v"], 5)
    b.run_steps(kern, ["v", "w"], ["v"], 5, bulk=False)
    assert a.last_step_path == "bulk" and len(passes) == 5
    assert torch.equal(a.data["v"], b.data["v"])


@pytest.mark.parametrize("make,reason", [
    (uf.branch_kernel, "data-dependent Python"),
    (uf.reduce_kernel, "reduces over or indexes across the cell axis"),
    (uf.outside_kernel, "op outside the set (aten.sin"),
    (uf.narrow_int_kernel, "a value of dtype torch.uint8"),
])
def test_declines_are_counted_and_logged(make, reason, caplog):
    """A branch on a value, a mean over the cells, ``sin`` and a uint8
    value each decline with their reason, counted in
    ``flux_gen.declined`` and logged once for the kernel at WARNING;
    ``Grid.run_steps`` then runs the plain roll path."""
    kern = make()
    cd = {"u": F32}
    g = _grid(cd, DIMS, (True, True, True), 0, seed=2)
    before = sum(n for r, n in flux_gen.declined.items() if reason in r)
    with caplog.at_level(logging.INFO, logger=flux_gen.__name__):
        got = flux_gen.lower(kern, ("u",), ("u",), cd, 1, target="cpu")
        again = flux_gen.lower(kern, ("u",), ("u",), cd, 1, target="cpu")
    assert isinstance(got, str) and reason in got and again == got
    assert sum(n for r, n in flux_gen.declined.items()
               if reason in r) == before + 2
    assert sum(reason in rec.getMessage() and rec.levelno == logging.WARNING
               for rec in caplog.records) == 1
    g.run_steps(kern, ["u"], ["u"], 1, extra_args=(0.1,))
    assert g.last_step_path == "roll"


@pytest.mark.parametrize("make,error", [
    (uf.buggy_kernel, ValueError),
    (lambda: port.SlotwiseKernel(
        lambda c, dt: torch.zeros_like(c["u"]),
        lambda a, c, n, o, m, dt: a + torch.ones(a.shape),
        lambda a, c, dt: {"u": c["u"] + a}), RuntimeError),
])
def test_other_trace_errors_raise(make, error):
    """An error of the kernel's own (a bug in its slot function; a
    tensor made on the default device beside the cells, a device
    mismatch in the trace) is no decline: ``lower`` raises it, and on the CPU ``Grid.run_steps``
    raises it too; nothing is counted."""
    kern = make()
    before = sum(flux_gen.declined.values())
    with pytest.raises(error):
        flux_gen.lower(kern, ("u",), ("u",), {"u": F32}, 1, target="cpu")
    g = _grid({"u": F32}, DIMS, (True, True, True), 0, seed=2)
    with pytest.raises(error):
        g.run_steps(kern, ["u"], ["u"], 1, extra_args=(0.1,))
    assert sum(flux_gen.declined.values()) == before


def test_out_of_memory_propagates():
    """An out-of-memory error the kernel itself raises is not a
    decline: it reaches the caller."""
    def init(cell, dt):
        raise torch.OutOfMemoryError("the kernel's own allocation")

    kern = port.SlotwiseKernel(init, lambda a, *r: a,
                               lambda a, c, dt: {"u": a})
    with pytest.raises(torch.OutOfMemoryError):
        flux_gen.lower(kern, ("u",), ("u",), {"u": F32}, 1, target="cpu")


def _ref_weighted_diffuse():
    def init(c, dt):
        return jnp.zeros(c["rho"].shape, c["rho"].dtype)

    def slot(acc, c, nbr, offs, mask, dt):
        wgt = jnp.where(mask & (offs[..., 0] == 1), 2.0,
                        jnp.where(mask, 1.0, 0.0))
        return acc + wgt * jnp.where(mask, nbr["rho"] - c["rho"], 0.0)

    def finish(acc, c, dt):
        return {"rho": c["rho"] + dt * acc}

    return RefSlotwise(init, slot, finish)


def _ref_weighted_diffuse_table(c, nbr, offs, mask, dt):
    wgt = jnp.where(mask & (offs[..., 0] == 1), 2.0,
                    jnp.where(mask, 1.0, 0.0))
    acc = jnp.sum(wgt * jnp.where(mask, nbr["rho"] - c["rho"][..., None],
                                  0.0), axis=-1)
    return {"rho": c["rho"] + dt * acc}


def test_user_twin_bucket_matches_reference(monkeypatch):
    """A bucket of jobs naming the registered user twin
    ``weighted_diffuse`` takes kernel A''s program (its plain version on
    the CPU, every slot of the 26-cube) and matches the reference's bulk
    bucket (Pallas, interpret mode) within rtol 1e-6 / atol 1e-5; one
    slot's budget runs out first."""
    uf.register_weighted_diffuse()
    monkeypatch.setitem(ref_fleet.FLEET_KERNELS, "weighted_diffuse",
                        _ref_weighted_diffuse_table)
    monkeypatch.setitem(ref_fleet.FLEET_BULK_KERNELS, "weighted_diffuse",
                        _ref_weighted_diffuse())
    monkeypatch.setenv("DCCRG_BULK", "pallas")

    def jobs(module, dtype):
        return [module.FleetJob(f"w{i}", length=REF_DIMS,
                                kernel="weighted_diffuse", n_steps=3,
                                params=(0.02 + 0.01 * i,), seed=40 + i,
                                cell_data={"rho": dtype})
                for i in range(3)]

    budget = np.array([3, 3, 1], np.int32)
    rb = ref_fleet.GridBatch(jobs(ref_fleet, jnp.float32)[0], 3)
    pb = fleet.GridBatch(jobs(fleet, F32)[0], 3, device="cpu")
    for b, js in ((rb, jobs(ref_fleet, jnp.float32)), (pb, jobs(fleet, F32))):
        for j in js:
            j.apply_init(b.grid)
            b.admit(j)
    rb.step(budget)
    pb.step(budget)
    assert rb.bulk_active() and pb.bulk_active()
    step = rx.make_fleet_bulk_step(pb.grid, pb.bulk_kernel, ("rho",),
                                   ("rho",), 1)
    assert isinstance(step.flux, flux_gen.Flux) and step.spec.cube
    got = np.asarray(convert.batch_state_to_numpy(pb)["rho"], np.float64)
    np.testing.assert_allclose(got, np.asarray(rb.state["rho"], np.float64),
                               rtol=1e-6, atol=1e-5)
