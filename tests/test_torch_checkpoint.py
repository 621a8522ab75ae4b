"""The port's ``.dc`` checkpoints against the reference, on the CPU.

Port and reference write byte-identical files for the same grid and
each loads the other's (uniform and refined grids; float32, bfloat16,
int32, a ``(4, 3)`` field and a variable field); the port reproduces
``tests/data/golden.dc`` byte for byte; a save, load and continue equals
an uninterrupted run bit for bit. The reference runs on a one-device
mesh.
"""

import struct

import ml_dtypes
import numpy as np
import pytest

import jax.numpy as jnp

from dccrg_tpu import checkpoint as ref_ckpt
from dccrg_tpu.grid import Grid as RefGrid
from dccrg_tpu.mapping import Mapping as RefMapping
from dccrg_tpu.neighbors import StructureError as RefStructureError
from dccrg_tpu.neighbors import verify_tiling as ref_verify_tiling
from golden_fixture import GOLDEN_SCHEMA as REF_GOLDEN_SCHEMA
from golden_fixture import build_golden_grid as ref_build_golden_grid
from torch_amr_fixture import assert_plans_equal, mesh1
from torch_golden import (GOLDEN, GOLDEN_SCHEMA, GOLDEN_VARIABLE, HEADER,
                          build_golden_grid, check_golden_values)

import torch

from dccrg_tpu_torch import checkpoint as ckpt
from dccrg_tpu_torch import Grid
from dccrg_tpu_torch.checkpoint import state_digest
from dccrg_tpu_torch.mapping import Mapping
from dccrg_tpu_torch.models.advection import GridAdvection
from dccrg_tpu_torch.neighbors import StructureError, verify_tiling

# every field kind a .dc payload carries: f32, bf16, int32, a (4, 3)
# block, and a ragged field stored truncated to its count
PORT_SCHEMA = {"a": torch.float32, "b": torch.bfloat16, "c": torch.int32,
               "d": ((4, 3), torch.float32), "n": torch.int32,
               "v": ((3, 2), torch.float32)}
REF_SCHEMA = {"a": jnp.float32, "b": jnp.bfloat16, "c": jnp.int32,
              "d": ((4, 3), jnp.float32), "n": jnp.int32,
              "v": ((3, 2), jnp.float32)}
VARIABLE = {"v": "n"}
HDR = b"parity-v1\n"


def _structure(g, kind):
    """Set up and initialize ``g`` (either package) as a uniform 16^3
    grid or a refined (4, 4, 4) one, then refine like each other."""
    if kind == "uniform":
        g = (g.set_initial_length((16, 16, 16)).set_periodic(True, False, True)
             .set_maximum_refinement_level(0).set_neighborhood_length(1)
             .set_geometry("cartesian", start=(0.5, -1.0, 2.0),
                           level_0_cell_length=(0.25, 0.5, 1.0)))
        return g
    return (g.set_initial_length((4, 4, 4)).set_periodic(False, True, False)
            .set_maximum_refinement_level(2).set_neighborhood_length(1))


def _refine(g):
    g.refine_completely(np.uint64(1))
    g.refine_completely(np.uint64(30))
    g.stop_refining()
    lvl1 = g.plan.cells[g.mapping.get_refinement_level(g.plan.cells) == 1]
    g.refine_completely(np.uint64(lvl1[3]))
    g.stop_refining()


def _values(cells, seed=0):
    """Seeded values of PORT_SCHEMA's fields; bfloat16 values exactly
    representable, ragged rows past each count zero."""
    rng = np.random.default_rng(seed)
    n = len(cells)
    counts = rng.integers(0, 4, n).astype(np.int32)
    v = rng.standard_normal((n, 3, 2)).astype(np.float32)
    v[np.arange(3)[None, :] >= counts[:, None]] = 0.0
    return {
        "a": rng.standard_normal(n).astype(np.float32),
        "b": rng.standard_normal(n).astype(ml_dtypes.bfloat16)
        .astype(np.float32),
        "c": rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int32),
        "d": rng.standard_normal((n, 4, 3)).astype(np.float32),
        "n": counts,
        "v": v,
    }


def grid_pair(kind, seed=0):
    """(reference grid, port grid) of the same structure and values."""
    r = _structure(RefGrid(cell_data=REF_SCHEMA), kind).initialize(mesh1())
    p = _structure(Grid(cell_data=PORT_SCHEMA), kind).initialize("cpu")
    if kind == "refined":
        _refine(r)
        _refine(p)
    vals = _values(p.plan.cells, seed)
    r.set_many(r.plan.cells, vals)
    p.set_many(p.plan.cells, vals)
    return r, p


def _get(g, name, cells):
    return np.asarray(g.get(name, cells)).astype(
        np.float32 if name == "b" else np.asarray(g.get(name, cells)).dtype)


def assert_same_values(a, b, cells, schema=PORT_SCHEMA, variable=VARIABLE):
    """Every field of grids ``a`` and ``b`` (either package) equal on
    ``cells`` bit for bit (ragged fields below each cell's count)."""
    for name in schema:
        x, y = _get(a, name, cells), _get(b, name, cells)
        if name in variable:
            keep = np.arange(x.shape[1])[None, :] < \
                _get(a, variable[name], cells)[:, None]
            x, y = x[keep], y[keep]
        np.testing.assert_array_equal(y.view(np.uint8), x.view(np.uint8),
                                      err_msg=name)


# ---------------------------------------------------------------------
# the golden file
# ---------------------------------------------------------------------

def _load_golden():
    return Grid.from_file(GOLDEN, GOLDEN_SCHEMA, device="cpu",
                          header_size=len(HEADER), variable=GOLDEN_VARIABLE)


def test_golden_file_contents():
    g, header = _load_golden()
    assert header == HEADER
    check_golden_values(g)
    ref = ref_build_golden_grid(mesh1())
    assert_same_values(ref, g, ref.plan.cells, schema=GOLDEN_SCHEMA,
                       variable=GOLDEN_VARIABLE)


def test_golden_file_roundtrip_bytes(tmp_path):
    g, _ = _load_golden()
    out = tmp_path / "resave.dc"
    g.save_grid_data(str(out), header=HEADER, variable=GOLDEN_VARIABLE)
    assert out.read_bytes() == open(GOLDEN, "rb").read()


def test_golden_matches_fresh_build(tmp_path):
    """The port's copy of the fixture builder reproduces the file."""
    out = tmp_path / "fresh.dc"
    build_golden_grid().save_grid_data(str(out), header=HEADER,
                                       variable=GOLDEN_VARIABLE)
    assert out.read_bytes() == open(GOLDEN, "rb").read()


def test_golden_schema_matches_reference():
    assert set(GOLDEN_SCHEMA) == set(REF_GOLDEN_SCHEMA)
    for name, spec in GOLDEN_SCHEMA.items():
        shape, dtype = spec if isinstance(spec, tuple) else ((), spec)
        rspec = REF_GOLDEN_SCHEMA[name]
        rshape, rdtype = rspec if isinstance(rspec, tuple) else ((), rspec)
        assert tuple(shape) == tuple(rshape)
        assert ckpt.storage_dtype(dtype) == np.dtype(rdtype)


def test_reference_write_sequence_loads(tmp_path):
    """A file assembled by replaying the reference's write sequence with
    plain struct.pack loads through the port's from_file and re-saves
    to the same bytes (tests/test_golden.py:72)."""
    header = b"ref-conformance\n"
    nx, ny, nz = 4, 2, 2
    start, cell_len = (0.5, 0.0, -1.0), (0.25, 0.5, 0.5)
    cells = np.arange(1, nx * ny * nz + 1, dtype=np.uint64)
    payload = (3.0 * cells).astype(np.float32)
    buf = bytearray(header)
    buf += struct.pack("<Q", 0x1234567890ABCDEF)
    buf += struct.pack("<3Qi", nx, ny, nz, 1)
    buf += struct.pack("<I", 1)
    buf += struct.pack("<3B", 1, 0, 0)
    buf += struct.pack("<i", 1)
    buf += struct.pack("<3d", *start)
    buf += struct.pack("<3d", *cell_len)
    buf += struct.pack("<Q", len(cells))
    data_start = len(buf) + 16 * len(cells)
    for i, c in enumerate(cells):
        buf += struct.pack("<QQ", int(c), data_start + 4 * i)
    buf += payload.tobytes()
    path = tmp_path / "ref_conformance.dc"
    path.write_bytes(bytes(buf))

    g, hdr = Grid.from_file(str(path), {"rho": torch.float32}, device="cpu",
                            header_size=len(header))
    assert hdr == header
    assert g.mapping.length.get().tolist() == [nx, ny, nz]
    assert g.mapping.max_refinement_level == 1 and g._hood_len == 1
    assert [g.topology.is_periodic(d) for d in range(3)] == [True, False, False]
    np.testing.assert_allclose(g.geometry.start, start)
    np.testing.assert_allclose(g.geometry.level_0_cell_length, cell_len)
    np.testing.assert_array_equal(g.get("rho", g.plan.cells), payload)
    out = tmp_path / "again.dc"
    g.save_grid_data(str(out), header=header)
    assert out.read_bytes() == bytes(buf)


@pytest.mark.parametrize("geom", ["cartesian", "stretched"])
def test_legacy_length_prefixed_files_still_load(tmp_path, geom):
    """Legacy files with a u32 geometry-record-length prefix (stretched
    records without coordinate counts) load (tests/test_golden.py:134)."""
    cells = np.arange(1, 5, dtype=np.uint64)
    payload = (1.5 * cells).astype(np.float32)
    coords = [np.array([0., 1., 2.]), np.array([0., .5, 1.]),
              np.array([0., 2.])]
    if geom == "cartesian":
        rec = struct.pack("<i", 1) + struct.pack("<6d", 0, 0, 0, .5, .5, 1)
    else:
        rec = struct.pack("<i", 2) + b"".join(c.tobytes() for c in coords)
    buf = bytearray(struct.pack("<Q", 0x1234567890ABCDEF))
    buf += struct.pack("<3Qi", 2, 2, 1, 0) + struct.pack("<I", 1)
    buf += struct.pack("<3B", 0, 0, 0)
    buf += struct.pack("<I", len(rec)) + rec
    buf += struct.pack("<Q", len(cells))
    ds = len(buf) + 16 * len(cells)
    for i, c in enumerate(cells):
        buf += struct.pack("<QQ", int(c), ds + 4 * i)
    buf += payload.tobytes()
    p = tmp_path / "legacy.dc"
    p.write_bytes(bytes(buf))
    g, _ = Grid.from_file(str(p), {"rho": torch.float32}, device="cpu")
    rg, _ = RefGrid.from_file(str(p), {"rho": jnp.float32}, mesh=mesh1())
    assert g.geometry.geometry_id == rg.geometry.geometry_id
    assert g.geometry.to_bytes() == rg.geometry.to_bytes()
    np.testing.assert_array_equal(g.get("rho", g.plan.cells), payload)


# ---------------------------------------------------------------------
# cross-package files
# ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["uniform", "refined"])
def test_port_loads_reference_file(tmp_path, kind):
    r, _p = grid_pair(kind)
    fn = str(tmp_path / "ref.dc")
    r.save_grid_data(fn, header=HDR, variable=VARIABLE)
    got, header = Grid.from_file(fn, PORT_SCHEMA, device="cpu",
                                 header_size=len(HDR), variable=VARIABLE)
    want, _ = RefGrid.from_file(fn, REF_SCHEMA, mesh=mesh1(),
                                header_size=len(HDR), variable=VARIABLE)
    assert header == HDR
    assert_plans_equal(want, got, lists=False)
    assert got.last_step_path is None
    assert_same_values(r, got, r.plan.cells)


@pytest.mark.parametrize("kind", ["uniform", "refined"])
def test_reference_loads_port_file(tmp_path, kind):
    r, p = grid_pair(kind)
    fp, fr = str(tmp_path / "port.dc"), str(tmp_path / "ref.dc")
    p.save_grid_data(fp, header=HDR, variable=VARIABLE)
    r.save_grid_data(fr, header=HDR, variable=VARIABLE)
    assert open(fp, "rb").read() == open(fr, "rb").read()
    got, _ = RefGrid.from_file(fp, REF_SCHEMA, mesh=mesh1(),
                               header_size=len(HDR), variable=VARIABLE)
    np.testing.assert_array_equal(got.plan.cells, p.plan.cells)
    assert_same_values(p, got, p.plan.cells)


def test_load_grid_data_into_matching_grid(tmp_path):
    """The legacy load-into-a-prepared-grid API, and its refusals of a
    mismatched grid (tests/test_balance_and_restart.py:167)."""
    r, p = grid_pair("uniform", seed=3)
    fn = str(tmp_path / "u.dc")
    r.save_grid_data(fn)
    target = _structure(Grid(cell_data=PORT_SCHEMA), "uniform").initialize("cpu")
    assert target.load_grid_data(fn) == b""
    assert_same_values(r, target, r.plan.cells, variable={})
    other = (Grid(cell_data=PORT_SCHEMA).set_initial_length((16, 16, 8))
             .initialize("cpu"))
    with pytest.raises(ValueError, match="does not match"):
        other.load_grid_data(fn)
    with pytest.raises(ValueError, match="endianness"):
        target.load_grid_data(fn, header_size=5)
    flat = (Grid(cell_data=PORT_SCHEMA).set_initial_length((16, 16, 16))
            .set_periodic(True, False, True).set_neighborhood_length(1)
            .initialize("cpu"))
    with pytest.raises(ValueError, match="geometry"):
        flat.load_grid_data(fn)


def test_variable_field_errors():
    with pytest.raises(ValueError, match="row axis"):
        ckpt._payload_spec_of({"v": ((), torch.float32)}, {"v": "n"})
    with pytest.raises(ValueError, match="scalar field"):
        ckpt._payload_spec_of({"v": ((3,), torch.float32),
                               "n": ((2,), torch.int32)}, {"v": "n"})
    _r, p = grid_pair("uniform")
    p.set("n", p.plan.cells[:1], np.array([7], np.int32))
    with pytest.raises(ValueError, match="out of range"):
        p.save_grid_data("/nonexistent/never.dc", variable=VARIABLE)


def test_variable_payload_roundtrip(tmp_path):
    """Ragged payloads (tests/test_balance_and_restart.py:302): the file
    holds only ``count`` rows a cell, equal to the reference's file, and
    the rows past each count load as zeros."""
    r, p = grid_pair("refined", seed=5)
    full = p.get("v", p.plan.cells)
    fn = str(tmp_path / "var.dc")
    p.save_grid_data(fn, variable=VARIABLE)
    r.save_grid_data(str(tmp_path / "ref.dc"), variable=VARIABLE)
    assert open(fn, "rb").read() == open(tmp_path / "ref.dc", "rb").read()
    g, _ = Grid.from_file(fn, PORT_SCHEMA, device="cpu", variable=VARIABLE)
    counts = g.get("n", g.plan.cells)
    got = g.get("v", g.plan.cells)
    for i, c in enumerate(counts):
        np.testing.assert_array_equal(got[i, :c], full[i, :c])
        assert not got[i, c:].any()


@pytest.mark.parametrize("chunk", [7, 1000])
def test_streamed_chunks(tmp_path, monkeypatch, chunk):
    """The chunked writer and loader iterate (CHUNK shrunk, as
    tests/test_balance_and_restart.py:241 does) and give the reference's
    bytes and values."""
    r, p = grid_pair("uniform", seed=2)
    fr = str(tmp_path / "ref.dc")
    r.save_grid_data(fr, variable=VARIABLE)
    monkeypatch.setattr(ckpt, "CHUNK", chunk)
    fp = str(tmp_path / "port.dc")
    p.save_grid_data(fp, variable=VARIABLE)
    assert open(fp, "rb").read() == open(fr, "rb").read()
    g, _ = Grid.from_file(fp, PORT_SCHEMA, device="cpu", variable=VARIABLE)
    assert_same_values(p, g, p.plan.cells)


def test_restart_from_file_alone_refined(tmp_path):
    """Mapping, geometry, the AMR structure and the data from nothing but
    the file (tests/test_balance_and_restart.py:176); the restarted grid
    still refines like the reference's."""
    r, p = grid_pair("refined", seed=4)
    fn = str(tmp_path / "restart.dc")
    p.save_grid_data(fn, header=b"HDR!", variable=VARIABLE)
    g, header = Grid.from_file(fn, PORT_SCHEMA, device="cpu", header_size=4,
                               variable=VARIABLE)
    assert header == b"HDR!"
    assert g.mapping == p.mapping and g.topology == p.topology
    assert g._hood_len == p._hood_len
    assert g.geometry.to_bytes() == p.geometry.to_bytes()
    assert_same_values(p, g, p.plan.cells)
    rg, _ = RefGrid.from_file(fn, REF_SCHEMA, mesh=mesh1(), header_size=4,
                              variable=VARIABLE)
    for grid in (g, rg):
        grid.refine_completely(np.uint64(grid.plan.cells[-1]))
        grid.stop_refining()
    assert_plans_equal(rg, g, lists=False)


def test_restart_from_file_stretched_geometry(tmp_path):
    coords = [np.array([0.0, 1.0, 2.5, 4.5]), np.array([0.0, 2.0, 3.0]),
              np.array([-1.0, 1.0])]
    g = (Grid(cell_data={"v": torch.float32}).set_initial_length((3, 2, 1))
         .set_geometry("stretched", coordinates=coords).initialize("cpu"))
    g.set("v", g.get_cells(), np.arange(6, dtype=np.float32))
    r = (RefGrid(cell_data={"v": jnp.float32}).set_initial_length((3, 2, 1))
         .set_geometry("stretched", coordinates=coords).initialize(mesh1()))
    r.set("v", r.get_cells(), np.arange(6, dtype=np.float32))
    fn, fr = str(tmp_path / "s.dc"), str(tmp_path / "r.dc")
    g.save_grid_data(fn)
    r.save_grid_data(fr)
    assert open(fn, "rb").read() == open(fr, "rb").read()
    g2, _ = Grid.from_file(fn, {"v": torch.float32}, device="cpu")
    assert g2.geometry.to_bytes() == g.geometry.to_bytes()
    np.testing.assert_array_equal(g2.get("v", g2.get_cells()),
                                  np.arange(6, dtype=np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_restart_equivalence(tmp_path, dtype):
    """GridAdvection(16): 4 steps, save, load_grid from the file alone,
    4 more steps == 8 uninterrupted steps, bit for bit."""
    a = GridAdvection(n=16, device="cpu", dtype=dtype)
    straight = GridAdvection(n=16, device="cpu", dtype=dtype)
    # the same start (two CPU inits can differ: ROADMAP queue 3)
    straight.grid.data = {n: t.clone() for n, t in a.grid.data.items()}
    dt = straight.run(8)
    a.run(4, dt)
    fn = str(tmp_path / "adv.dc")
    a.grid.save_grid_data(fn)
    a.grid, _ = ckpt.load_grid(fn, a.grid.fields, device="cpu")
    assert all(a.grid.data[n].dtype == dtype for n in a.grid.fields)
    a.run(4, dt)
    assert a.grid.last_step_path == straight.grid.last_step_path
    assert state_digest(a.grid) == state_digest(straight.grid)
    assert torch.equal(a.grid.data["density"], straight.grid.data["density"])


# ---------------------------------------------------------------------
# verify_tiling (rewritten: per-level counts, no object arrays)
# ---------------------------------------------------------------------

def _tiling_cases():
    m = Mapping((4, 4, 2))
    m.set_maximum_refinement_level(2)
    base = np.arange(1, 33, dtype=np.uint64)
    kids = m.get_all_children(np.array([5], np.uint64))[0]
    refined = np.sort(np.concatenate([np.delete(base, 4), kids]))
    grand = m.get_all_children(np.array([kids[2]], np.uint64))[0]
    deeper = np.sort(np.concatenate([refined[refined != kids[2]], grand]))
    return {
        "uniform": base,
        "refined": refined,
        "deeper": deeper,
        "unsorted": deeper[::-1].copy(),
        "duplicate": np.sort(np.concatenate([base, base[3:4]])),
        "gap": np.delete(base, 7),
        "overlap": np.sort(np.concatenate([base, kids])),
        "overlap_deep": np.sort(np.concatenate([refined, grand])),
        "invalid": np.concatenate([base[:-1], [np.uint64(1 << 40)]]),
    }


@pytest.mark.parametrize("case", sorted(_tiling_cases()))
def test_verify_tiling_matches_reference(case):
    cells = _tiling_cases()[case]
    rm = RefMapping((4, 4, 2))
    rm.set_maximum_refinement_level(2)
    pm = Mapping((4, 4, 2))
    pm.set_maximum_refinement_level(2)
    try:
        ref_verify_tiling(rm, cells)
        want = None
    except RefStructureError as e:
        want = str(e)
    if want is None:
        verify_tiling(pm, cells)
    else:
        with pytest.raises(StructureError) as ei:
            verify_tiling(pm, cells)
        assert str(ei.value) == want
    assert (want is None) == (case in ("uniform", "refined", "deeper",
                                       "unsorted"))


def test_stale_temp_files(tmp_path):
    live = tmp_path / f"a.dc.tmp.{__import__('os').getpid()}"
    dead = tmp_path / "b.dc.tmp.999999999"
    salvage = tmp_path / "c.dc.salvage.999999999"
    mp = tmp_path / "d.dc.mp-tmp"
    for p in (live, dead, salvage, mp, tmp_path / "e.dc",
              tmp_path / "e.dc.crc"):
        p.write_bytes(b"x")
    want = ref_ckpt.stale_temp_files(str(tmp_path))
    assert ckpt.stale_temp_files(str(tmp_path)) == want
    assert sorted(want) == sorted(str(p) for p in (dead, salvage, mp))
