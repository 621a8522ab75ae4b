"""The port's checkpoint integrity, fault plans, integrity fingerprints
and numerics watchdog against the reference, on the CPU.

The counterparts of ``tests/test_checkpoint_integrity.py`` on the port's
copy of the golden grid (sidecar chunks of 128 bytes): the sidecar JSON
equals the reference's, every corruption class is detected and salvaged
as the reference salvages it, a seeded plan corrupts the same byte.
Then delta chains the reference writes, fingerprints, conservation
sums, poison and flip sites, the watchdog's details and the fault sites
fired before any change of state.
"""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

from dccrg_tpu import faults as ref_faults
from dccrg_tpu import integrity as ref_integrity
from dccrg_tpu import resilience as ref_res
from dccrg_tpu.grid import Grid as RefGrid
from golden_fixture import GOLDEN_SCHEMA as REF_GOLDEN_SCHEMA
from golden_fixture import build_golden_grid as ref_build_golden_grid
from test_torch_checkpoint import PORT_SCHEMA, grid_pair
from torch_amr_fixture import mesh1
from torch_golden import GOLDEN_SCHEMA, GOLDEN_VARIABLE, build_golden_grid

import torch

from dccrg_tpu_torch import Grid, faults, integrity, resilience
from dccrg_tpu_torch.checkpoint import state_digest
from dccrg_tpu_torch.models.advection import GridAdvection
from dccrg_tpu_torch.resilience import (CheckpointCorruptionError,
                                        DeltaChainError, NumericsError)

HEADER = b"integrity-v1\n"
# small chunks so single corruptions map onto a few cells
CHUNK = 128


@pytest.fixture
def saved(tmp_path):
    g = build_golden_grid()
    fn = str(tmp_path / "ck.dc")
    resilience.save_checkpoint(g, fn, header=HEADER,
                               variable=GOLDEN_VARIABLE, chunk_bytes=CHUNK)
    return g, fn


def _load(fn, strict=True):
    return resilience.load_checkpoint(
        fn, GOLDEN_SCHEMA, device="cpu", header_size=len(HEADER),
        variable=GOLDEN_VARIABLE, strict=strict)


def _ref_load(fn, strict=True):
    return ref_res.load_checkpoint(
        fn, REF_GOLDEN_SCHEMA, mesh=mesh1(), header_size=len(HEADER),
        variable=GOLDEN_VARIABLE, strict=strict)


def _assert_equal_on(g_ref, g_got, cells):
    if not len(cells):
        return
    counts = g_ref.get("count", cells)
    for name in GOLDEN_SCHEMA:
        want = g_ref.get(name, cells)
        got = g_got.get(name, cells)
        if name in GOLDEN_VARIABLE:
            keep = np.arange(want.shape[1])[None, :] < counts[:, None]
            want = np.where(keep[..., None], want, 0)
            got = np.where(keep[..., None], got, 0)
        np.testing.assert_array_equal(got, want, err_msg=f"field {name!r}")


def test_clean_roundtrip_and_sidecar_equal_to_reference(saved, tmp_path):
    """The .dc bytes and the sidecar record (CRCs and the integrity
    fingerprint) equal the reference's for the same grid."""
    g, fn = saved
    assert resilience.verify_checkpoint(fn) == []
    g2, header, report = _load(fn)
    assert header == HEADER and report.clean
    _assert_equal_on(g, g2, g.plan.cells)
    rfn = str(tmp_path / "ref.dc")
    ref_res.save_checkpoint(ref_build_golden_grid(mesh1()), rfn,
                            header=HEADER, variable=GOLDEN_VARIABLE,
                            chunk_bytes=CHUNK)
    assert open(fn, "rb").read() == open(rfn, "rb").read()
    assert json.load(open(fn + ".crc")) == json.load(open(rfn + ".crc"))
    assert resilience.audit_checkpoint(fn) == ref_res.audit_checkpoint(rfn)
    assert all(ok for ok, _g, _w in resilience.audit_checkpoint(fn).values())


@pytest.mark.parametrize("kind", ["uniform", "refined"])
def test_sidecar_equal_to_reference_every_dtype(tmp_path, kind):
    r, p = grid_pair(kind, seed=7)
    fp, fr = str(tmp_path / "p.dc"), str(tmp_path / "r.dc")
    resilience.save_checkpoint(p, fp, variable={"v": "n"}, chunk_bytes=4096)
    ref_res.save_checkpoint(r, fr, variable={"v": "n"}, chunk_bytes=4096)
    assert open(fp, "rb").read() == open(fr, "rb").read()
    assert json.load(open(fp + ".crc")) == json.load(open(fr + ".crc"))
    got, _h, rep = resilience.load_checkpoint(fr, PORT_SCHEMA, device="cpu",
                                              variable={"v": "n"})
    assert rep.clean
    assert state_digest(got) == state_digest(p)


def test_sidecar_does_not_change_dc_bytes(saved, tmp_path):
    g, fn = saved
    plain = tmp_path / "plain.dc"
    g.save_grid_data(str(plain), header=HEADER, variable=GOLDEN_VARIABLE)
    assert plain.read_bytes() == open(fn, "rb").read()


def test_flipped_payload_bit_detected_and_salvaged(saved):
    g, fn = saved
    rec = json.load(open(fn + ".crc"))
    faults.flip_bit(fn, (rec["payload_start"] + rec["file_bytes"]) // 2, bit=5)
    with pytest.raises(CheckpointCorruptionError, match=r"payload chunk \d+"):
        _load(fn)
    g2, _, report = _load(fn, strict=False)
    assert len(report.bad_chunks) == 1 and len(report.corrupt_cells)
    ok = np.setdiff1d(g.plan.cells, report.corrupt_cells)
    assert len(ok) > len(report.corrupt_cells)
    _assert_equal_on(g, g2, ok)
    np.testing.assert_array_equal(
        g2.get("density", report.corrupt_cells),
        np.zeros(len(report.corrupt_cells), np.float32))
    _r, _h, ref_report = _ref_load(fn, strict=False)
    np.testing.assert_array_equal(report.corrupt_cells,
                                  ref_report.corrupt_cells)
    assert report.bad_chunks == ref_report.bad_chunks


def test_every_single_byte_flip_is_detected(saved):
    _, fn = saved
    size = os.path.getsize(fn)
    good = open(fn, "rb").read()
    probe = sorted({0, size - 1, CHUNK, CHUNK + 1, size // 2}
                   | set(range(7, size, max(1, size // 19))))
    for byte in probe:
        faults.flip_bit(fn, byte, bit=1)
        assert resilience.verify_checkpoint(fn), f"flip at {byte} missed"
        with open(fn, "wb") as f:
            f.write(good)
    assert resilience.verify_checkpoint(fn) == []


def test_truncated_file(saved):
    g, fn = saved
    faults.truncate_file(fn, 2 * CHUNK + 7)
    with pytest.raises(CheckpointCorruptionError):
        _load(fn)
    g2, _, report = _load(fn, strict=False)
    ok = np.setdiff1d(g.plan.cells, report.corrupt_cells)
    _assert_equal_on(g, g2, ok)
    _r, _h, ref_report = _ref_load(fn, strict=False)
    np.testing.assert_array_equal(report.corrupt_cells,
                                  ref_report.corrupt_cells)


def test_wrong_endianness_magic(saved):
    _, fn = saved
    faults.flip_bit(fn, len(HEADER) + 2, bit=0)
    with pytest.raises(CheckpointCorruptionError, match="metadata block"):
        _load(fn)
    with pytest.raises(CheckpointCorruptionError, match="metadata"):
        _load(fn, strict=False)
    os.unlink(fn + ".crc")
    with pytest.raises(ValueError, match="bad endianness magic"):
        _load(fn, strict=False)


def test_missing_sidecar(saved):
    g, fn = saved
    os.unlink(fn + ".crc")
    with pytest.raises(CheckpointCorruptionError, match="sidecar"):
        _load(fn)
    with pytest.raises(CheckpointCorruptionError, match="sidecar"):
        resilience.verify_checkpoint(fn)
    assert resilience.verify_checkpoint(fn, require_sidecar=False) == []
    g2, _, report = _load(fn, strict=False)
    assert report.sidecar_missing and not report.clean
    _assert_equal_on(g, g2, g.plan.cells)


def test_ragged_payload_corruption(saved):
    g, fn = saved
    rec = json.load(open(fn + ".crc"))
    faults.flip_bit(fn, rec["file_bytes"] - 3, bit=7)
    with pytest.raises(CheckpointCorruptionError, match="payload chunk"):
        _load(fn)
    g2, _, report = _load(fn, strict=False)
    assert len(report.corrupt_cells)
    ok = np.setdiff1d(g.plan.cells, report.corrupt_cells)
    _assert_equal_on(g, g2, ok)
    pos = g2.get("pos", report.corrupt_cells)
    counts = g2.get("count", report.corrupt_cells)
    for i, c in enumerate(counts):
        np.testing.assert_array_equal(pos[i, :c], 0.0)
    r2, _h, ref_report = _ref_load(fn, strict=False)
    np.testing.assert_array_equal(report.corrupt_cells,
                                  ref_report.corrupt_cells)
    _assert_equal_on(r2, g2, g.plan.cells)


def test_trailing_garbage_detected_but_salvage_keeps_all_cells(saved):
    g, fn = saved
    with open(fn, "ab") as f:
        f.write(b"\xde\xad" * 5)
    assert resilience.verify_checkpoint(fn) == ref_res.verify_checkpoint(fn)
    with pytest.raises(CheckpointCorruptionError, match="trailing"):
        _load(fn)
    g2, _, report = _load(fn, strict=False)
    assert not len(report.corrupt_cells)
    _assert_equal_on(g, g2, g.plan.cells)


@pytest.mark.parametrize("damage", ["zero_chunk", "not_int", "short_list",
                                    "bad_format", "not_json"])
def test_corrupt_sidecar_rejected(saved, damage):
    _, fn = saved
    rec = json.load(open(fn + ".crc"))
    if damage == "zero_chunk":
        rec["chunk_bytes"] = 0
    elif damage == "not_int":
        rec["chunk_bytes"] = "lots"
    elif damage == "short_list":
        rec["crc32"] = rec["crc32"][:-1]
    elif damage == "bad_format":
        rec["format"] = "other"
    text = "{not json" if damage == "not_json" else json.dumps(rec)
    with open(fn + ".crc", "w") as f:
        f.write(text)
    with pytest.raises(CheckpointCorruptionError, match="sidecar"):
        resilience.verify_checkpoint(fn)
    with pytest.raises(CheckpointCorruptionError, match="sidecar"):
        _load(fn, strict=False)
    with pytest.raises(ref_res.CheckpointCorruptionError):
        ref_res.verify_checkpoint(fn)


def test_failed_rename_keeps_old_checkpoint_verifiable(saved, monkeypatch):
    g, fn = saved
    real_replace = os.replace

    def bad_replace(src, dst):
        if dst == fn:
            raise OSError("injected rename failure")
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", bad_replace)
    with pytest.raises(OSError, match="rename"):
        resilience.save_checkpoint(g, fn, header=HEADER,
                                   variable=GOLDEN_VARIABLE,
                                   chunk_bytes=CHUNK, retries=1,
                                   backoff=0.0)
    monkeypatch.undo()
    assert resilience.verify_checkpoint(fn) == []


def test_transient_io_error_retries(saved, tmp_path):
    g, _fn = saved
    out = str(tmp_path / "retry.dc")
    plan = faults.FaultPlan()
    plan.io_error(times=1)
    with plan:
        resilience.save_checkpoint(g, out, header=HEADER,
                                   variable=GOLDEN_VARIABLE, backoff=0.0)
    assert plan.fired("checkpoint.write") == 1
    assert resilience.verify_checkpoint(out) == []


def test_failed_save_preserves_previous_checkpoint(saved):
    g, fn = saved
    before = open(fn, "rb").read()
    plan = faults.FaultPlan()
    plan.chunk_io_error(times=faults.EVERY)
    with plan, pytest.raises(OSError):
        resilience.save_checkpoint(g, fn, header=HEADER,
                                   variable=GOLDEN_VARIABLE,
                                   retries=1, backoff=0.0)
    assert plan.fired("checkpoint.chunk") == 2
    assert open(fn, "rb").read() == before
    assert resilience.verify_checkpoint(fn) == []
    assert not [p for p in os.listdir(os.path.dirname(fn)) if ".tmp." in p]


@pytest.mark.parametrize("kind", ["bitflip", "truncate"])
def test_seeded_plan_corrupts_like_the_reference(saved, tmp_path, kind):
    """A seeded plan's file corruption lands on the same byte and bit
    (or drops the same tail) as the reference plan with the same seed."""
    g, _ = saved
    outs = []
    for pkg, mod, grid in ((resilience, faults, g),
                           (ref_res, ref_faults,
                            ref_build_golden_grid(mesh1()))):
        out = str(tmp_path / f"{mod.__name__}.dc")
        plan = mod.FaultPlan(seed=11)
        plan.bit_flip(times=1) if kind == "bitflip" else plan.truncate(times=1)
        with plan:
            pkg.save_checkpoint(grid, out, header=HEADER,
                                variable=GOLDEN_VARIABLE, chunk_bytes=CHUNK)
        assert plan.fired("checkpoint.file") == 1
        assert pkg.verify_checkpoint(out)
        outs.append((out, [(s, k, {x: v for x, v in d.items() if x != "path"})
                           for s, k, d in plan.log]))
    assert outs[0][1] == outs[1][1]
    assert open(outs[0][0], "rb").read() == open(outs[1][0], "rb").read()


def test_stream_crcs_match_reference(saved):
    _, fn = saved
    rec = json.load(open(fn + ".crc"))
    ranges = resilience._rec_ranges(rec)
    spans = [(40, 200), (300, 301), (500, rec["file_bytes"])]
    got = resilience._stream_crcs(fn, ranges, spans, block=64)
    assert got == ref_res._stream_crcs(fn, ranges, spans, block=64)
    assert got[0] == rec["crc32"]


# ---------------------------------------------------------------------
# delta chains the reference writes
# ---------------------------------------------------------------------

DELTA_PORT_SCHEMA = {"rho": torch.float32, "mat": ((16,), torch.float32),
                     "tag": torch.int32}


def _ref_chain(tmp_path):
    from test_delta_checkpoint import SCHEMA, _plant_chain

    g, _store, paths, _states = _plant_chain(tmp_path)
    return SCHEMA, g, paths


def test_delta_chain_loads_like_reference(tmp_path):
    schema, g, paths = _ref_chain(tmp_path)
    assert resilience.is_delta_checkpoint(paths[-1])
    assert not resilience.is_delta_checkpoint(paths[0])
    assert resilience.verify_chain(paths[-1]) == ref_res.verify_chain(paths[-1])
    for i, p in enumerate(paths):
        mine, theirs = p + ".port", p + ".ref"
        assert resilience.materialize_chain(p, mine, DELTA_PORT_SCHEMA) == \
            ref_res.materialize_chain(p, theirs, schema)
        assert open(mine, "rb").read() == open(theirs, "rb").read()
        os.unlink(mine)
        os.unlink(theirs)
    got, _h, report = resilience.load_checkpoint(paths[-1], DELTA_PORT_SCHEMA,
                                                 device="cpu")
    assert len(report.chain) == len(paths)
    cells = g.plan.cells
    for name in DELTA_PORT_SCHEMA:
        np.testing.assert_array_equal(got.get(name, cells),
                                      np.asarray(g.get(name, cells)))
    into = Grid(cell_data=DELTA_PORT_SCHEMA).set_initial_length(
        (4, 4, 2)).set_periodic(True, True, True).set_maximum_refinement_level(
        1).set_neighborhood_length(1).initialize("cpu")
    resilience.load_checkpoint_into(into, paths[-1])
    assert state_digest(into) == state_digest(got)
    assert not [n for n in os.listdir(tmp_path) if ".chain." in n]


@pytest.mark.parametrize("broken", [0, 1, 2, 3])
@pytest.mark.parametrize("damage", ["flip", "truncate", "delete"])
def test_delta_chain_error_names_reference_link(tmp_path, broken, damage):
    schema, _g, paths = _ref_chain(tmp_path)
    victim = paths[broken]
    if damage == "flip":
        faults.flip_bit(victim, os.path.getsize(victim) - 3, bit=2)
    elif damage == "truncate":
        faults.truncate_file(victim, os.path.getsize(victim) // 2)
    else:
        os.unlink(victim)
        os.unlink(resilience.sidecar_path(victim))
    with pytest.raises(DeltaChainError) as mine:
        resilience.load_checkpoint(paths[-1], DELTA_PORT_SCHEMA, device="cpu")
    with pytest.raises(ref_res.DeltaChainError) as theirs:
        ref_res.load_checkpoint(paths[-1], schema,
                                load_balancing_method="block")
    assert os.path.basename(victim) in str(mine.value)
    assert mine.value.link == theirs.value.link
    assert mine.value.chain == theirs.value.chain


def test_delta_parent_replaced_is_named(tmp_path):
    schema, g, paths = _ref_chain(tmp_path)
    ref_res.save_checkpoint(g, paths[0])  # a different save, same name
    with pytest.raises(DeltaChainError, match="parent digest") as mine:
        resilience.verify_chain(paths[1])
    with pytest.raises(ref_res.DeltaChainError) as theirs:
        ref_res.verify_chain(paths[1])
    assert mine.value.link == theirs.value.link
    for p in paths:
        rec = resilience.read_sidecar(p)
        assert resilience.record_digest(rec) == ref_res.record_digest(rec)


# ---------------------------------------------------------------------
# fingerprints and conservation sums
# ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["uniform", "refined"])
def test_grid_and_file_fingerprints_equal_reference(tmp_path, kind):
    r, p = grid_pair(kind, seed=9)
    got = integrity.grid_fingerprint(p)
    assert got == ref_integrity.grid_fingerprint(r)
    fn = str(tmp_path / "f.dc")
    p.save_grid_data(fn, variable={"v": "n"})
    ffp = integrity.file_fingerprint(fn, PORT_SCHEMA, variable={"v": "n"})
    assert ffp == ref_integrity.file_fingerprint(
        fn, {n: s for n, s in ref_res._cell_data_fields(
            r.fields).items()}, variable={"v": "n"})
    assert all(ffp[n] == got[n] for n in ffp)
    assert "v" not in ffp


def test_conservation_sums_within_tolerance():
    r, p = grid_pair("refined", seed=1)
    names = ("a", "b", "c", "d")
    got = integrity.conservation_sums(p, names)
    want = ref_integrity.conservation_sums(r, names)
    assert got.dtype == np.float64 and got.shape == (4,)
    n = len(p.plan.cells)
    for name, x, y in zip(names, got, want):
        elems = n * (12 if name == "d" else 1)
        assert abs(x - y) <= integrity.sum_tolerance(y, elems), name
    assert integrity.conservation_sums(p, ()).shape == (0,)


# ---------------------------------------------------------------------
# poison and flip sites, the watchdog
# ---------------------------------------------------------------------

def _golden_pair():
    return ref_build_golden_grid(mesh1()), build_golden_grid()


@pytest.mark.parametrize("seed", [0, 5])
def test_poison_step_picks_reference_cells(seed):
    r, p = _golden_pair()
    logs = []
    for mod, g in ((ref_faults, r), (faults, p)):
        plan = mod.FaultPlan(seed=seed)
        plan.nan_poison("density", step=3)
        plan.nan_poison("flag", step=3, cells=[5, 6], value=-7)
        with plan:
            assert mod.poison_step(g, 2) == []
            applied = mod.poison_step(g, 3)
        logs.append((plan.log, [(n, c.tolist()) for n, c in applied]))
    assert logs[0] == logs[1]
    cells = p.plan.cells
    for name in ("density", "flag"):
        np.testing.assert_array_equal(p.get(name, cells),
                                      np.asarray(r.get(name, cells)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bit", [23, 30, 3])
def test_flip_step_picks_reference_cells_and_bits(dtype, bit):
    ref_schema = {"v": getattr(jnp, dtype), "w": jnp.int32}
    port_schema = {"v": getattr(torch, dtype), "w": torch.int32}
    r = RefGrid(cell_data=ref_schema).set_initial_length((4, 4, 4)) \
        .initialize(mesh1())
    p = Grid(cell_data=port_schema).set_initial_length((4, 4, 4)) \
        .initialize("cpu")
    cells = p.plan.cells
    # magnitudes on both sides of 2 and large ones whose exponent flip
    # would overflow, so the finite fallback is taken too
    vals = np.where(cells % 3 == 0, 3.0e38, (cells % 7) - 3.5).astype(
        np.float32)
    if dtype == "bfloat16":
        vals = vals.astype(jnp.bfloat16).astype(np.float32)
    for g in (r, p):
        g.set_many(cells, {"v": vals, "w": cells.astype(np.int32)})
    logs = []
    for mod, g in ((ref_faults, r), (faults, p)):
        plan = mod.FaultPlan(seed=3)
        plan.silent_flip("v", step=1, bit=bit)
        plan.silent_flip("v", step=1, cells=np.arange(1, 65), bit=bit)
        plan.silent_flip("w", step=1, cells=[9], bit=bit)
        with plan:
            applied = mod.flip_step(g, 1)
        logs.append((plan.log, [(n, c.tolist()) for n, c in applied]))
    assert logs[0] == logs[1]
    got = p.get("v", cells)
    np.testing.assert_array_equal(got.view(np.uint32), np.asarray(
        r.get("v", cells)).astype(np.float32).view(np.uint32))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(p.get("w", cells), np.asarray(
        r.get("w", cells)))


def test_watchdog_details_equal_reference():
    r, p = _golden_pair()
    bad = p.plan.cells[[2, 30]]
    for g in (r, p):
        g.set("density", bad, np.array([np.nan, np.inf], np.float32))
        g.set("pos", bad[:1], np.full((1, 4, 3), np.nan, np.float32))
    assert not resilience.check_finite(p)
    assert resilience.check_finite(p, ["flag", "count"])
    with pytest.raises(NumericsError) as mine:
        resilience.assert_finite(p, step=7)
    with pytest.raises(ref_res.NumericsError) as theirs:
        ref_res.assert_finite(r, step=7)
    assert str(mine.value) == str(theirs.value)
    assert mine.value.details.keys() == theirs.value.details.keys()
    for name in mine.value.details:
        np.testing.assert_array_equal(mine.value.details[name],
                                      theirs.value.details[name])


def test_watchdog_interval_in_run_steps(monkeypatch):
    """DCCRG_WATCHDOG=2: run_steps checks every 2 steps, accumulated
    across calls, and names the poisoned cell; off by default."""
    assert resilience.watchdog_interval() == 0
    monkeypatch.setenv("DCCRG_WATCHDOG", "2")
    assert resilience.watchdog_interval() == 2
    cell = np.uint64(77)
    adv = GridAdvection(n=8, nz=2, device="cpu")
    adv.grid.set("density", [cell], np.array([np.nan], np.float32))
    adv.run(1)  # one step since the last check: no check yet
    with pytest.raises(NumericsError) as ei:
        adv.run(1)
    assert list(ei.value.details) == ["density"]
    assert cell in ei.value.details["density"]
    monkeypatch.setenv("DCCRG_WATCHDOG", "junk")
    assert resilience.watchdog_interval() == 0


# ---------------------------------------------------------------------
# fault sites fired before any change of state
# ---------------------------------------------------------------------

@pytest.mark.parametrize("site,phase,op", [
    ("adapt.commit", "resolve", "adapt"),
    ("adapt.resolve", "pins", "adapt"),
    ("balance.commit", "partition", "balance"),
    ("balance.commit", "stage", "balance"),
])
def test_fault_before_any_change_leaves_grid_unchanged(site, phase, op):
    r, p = _golden_pair()
    for g in (r, p):
        g.refine_completely(np.uint64(2))
    before = (p.plan.cells.copy(), state_digest(p), p.plan.epoch)
    errors = []
    for mod, g in ((ref_faults, r), (faults, p)):
        plan = mod.FaultPlan()
        plan.mutation_error(site=site, phase=phase)
        with plan, pytest.raises(Exception) as ei:
            g.stop_refining() if op == "adapt" else g.balance_load()
        assert plan.fired(site) == 1
        errors.append(ei.value)
    ref_err, port_err = errors
    # both packages' transactions wrap the injected error
    assert type(port_err).__name__ == type(ref_err).__name__
    assert type(port_err.__cause__).__name__ == type(ref_err.__cause__).__name__
    assert isinstance(port_err.__cause__, faults.InjectedMutationError)
    assert np.array_equal(p.plan.cells, before[0])
    assert state_digest(p) == before[1] and p.plan.epoch == before[2]
    # the pending request survived: the retry commits what the
    # reference's retry commits
    for g in (r, p):
        g.stop_refining()
    np.testing.assert_array_equal(p.plan.cells, r.plan.cells)
