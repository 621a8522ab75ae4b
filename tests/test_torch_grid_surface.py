"""The rest of the port's ``Grid`` surface against the reference, on the
CPU: ``clone``, the cached cell and neighbour data items,
``get_maximum_refinement_level_difference``, ``write_vtk_file`` and
``utils/vtk.py`` (bytes equal to the reference's), and
``AmrAdvection.from_grid`` after a ``.dc`` restart.

tests/test_api_completeness.py:149-196 and tests/test_utils.py's cases
run on both packages. The port's tensors are mutable, so a clone must
share no storage with its source: no field tensor, no plan table, no
arena buffer.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from test_recommit import plan_fingerprint
from torch_amr_fixture import assert_plans_equal

from dccrg_tpu.grid import Grid as RefGrid
from dccrg_tpu.utils import dc_to_vtk as ref_dc_to_vtk

from dccrg_tpu_torch import Grid
from dccrg_tpu_torch.models import AmrAdvection
from dccrg_tpu_torch.utils import dc_to_vtk
from dccrg_tpu_torch.utils import vtk as port_vtk


def mesh_of(n):
    return Mesh(np.array(jax.devices()[:n]), ("dev",))


def make_pair(n_dev=8, length=(4, 4, 4), max_lvl=0, hood=1):
    """tests/test_api_completeness.py's grid in both packages."""
    r = (RefGrid(cell_data={"rho": np.float32})
         .set_initial_length(length).set_maximum_refinement_level(max_lvl)
         .set_periodic(True, True, True).set_neighborhood_length(hood)
         .initialize(mesh_of(n_dev)))
    p = (Grid(cell_data={"rho": torch.float32})
         .set_initial_length(length).set_maximum_refinement_level(max_lvl)
         .set_periodic(True, True, True).set_neighborhood_length(hood)
         .initialize(["cpu"] * n_dev))
    return r, p


def _refine_first(g):
    g.refine_completely(int(g.get_cells()[0]))
    g.stop_refining()


# -- clone --------------------------------------------------------------

def test_clone_same_structure_new_schema():
    r, p = make_pair(max_lvl=1)
    clones = []
    for g in (r, p):
        _refine_first(g)
        ids = g.get_cells()
        g.set("rho", ids, np.arange(len(ids), dtype=np.float32))
        spec = ({"a": np.float64, "b": ((3,), np.int32)} if g is r else
                {"a": torch.float64, "b": ((3,), torch.int32)})
        other = g.clone(cell_data=spec)
        np.testing.assert_array_equal(other.plan.cells, g.plan.cells)
        np.testing.assert_array_equal(other.plan.owner, g.plan.owner)
        assert set(other.fields) == {"a", "b"}
        assert np.all(other.get("a", ids) == 0.0)
        other.set("a", ids[:4], np.ones(4))
        assert np.all(g.get("rho", ids) == np.arange(len(ids),
                                                     dtype=np.float32))
        clones.append(other)
    # the clone's plan is built afresh, capacities included, as the
    # reference's clone builds it
    assert_plans_equal(clones[0], clones[1])


def _arrays(obj):
    """Every numpy array reachable through a plan's attributes."""
    out = []
    if isinstance(obj, np.ndarray):
        return [obj]
    if isinstance(obj, (list, tuple)):
        for v in obj:
            out += _arrays(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            out += _arrays(v)
    return out


def _plan_arrays(g):
    plan = g.plan
    arrs = _arrays([plan.cells, plan.owner, plan.row_of_pos, plan.n_local,
                    plan.local_ids, plan.ghost_ids])
    for hood in plan.hoods.values():
        arrs += _arrays([hood.nbr_rows, hood.nbr_mask, hood.nbr_offs,
                         hood.hard_rows, hood.hard_nbr_rows, hood.hard_offs,
                         hood.hard_mask, hood.scale_rows,
                         list(hood._to_tables()), hood.pair_compact])
    return arrs


@pytest.mark.parametrize("n_dev", [1, 4])
def test_clone_shares_no_storage(n_dev):
    """A clone of a refined grid: plan equal bit for bit, no table, arena
    buffer or tensor shared, and writes to either side leave the other
    unchanged."""
    g = (Grid(cell_data={"v": torch.float32, "w": ((2,), torch.float32)})
         .set_initial_length((6, 5, 4)).set_maximum_refinement_level(2)
         .set_neighborhood_length(1).initialize(["cpu"] * n_dev))
    for c in (1, 2, 3):
        g.refine_completely(c)
    g.stop_refining()
    cells = g.plan.cells
    g.set("v", cells, np.arange(len(cells), dtype=np.float32))
    c = g.clone()
    # a fresh build: the same cells, partitions and tables at the
    # capacities of a first build (a level-0 grid's plan is its
    # source's bit for bit, test_clone_of_level0_grid_equal_plan)
    np.testing.assert_array_equal(c.plan.cells, g.plan.cells)
    np.testing.assert_array_equal(c.plan.owner, g.plan.owner)
    assert plan_fingerprint(g.clone()) == plan_fingerprint(c)
    assert c._plan_arena is not g._plan_arena
    for a in _plan_arrays(c):
        for b in _plan_arrays(g):
            assert not np.shares_memory(a, b)
    for n in g.data:
        assert c.data[n].untyped_storage().data_ptr() != \
            g.data[n].untyped_storage().data_ptr()
    # writes in place on either side stay on that side
    c.set("v", cells, np.full(len(cells), 5.0, dtype=np.float32))
    np.testing.assert_array_equal(g.get("v", cells),
                                  np.arange(len(cells), dtype=np.float32))
    g.set("w", cells[:3], np.ones((3, 2), dtype=np.float32))
    assert np.all(c.get("w", cells) == 0.0)
    # an AMR commit of the source does not touch the clone's plan
    fp = plan_fingerprint(c)
    g.refine_completely(int(cells[-1]))
    g.stop_refining()
    assert plan_fingerprint(c) == fp


@pytest.mark.parametrize("n_dev", [1, 4])
def test_clone_of_level0_grid_equal_plan(n_dev):
    g = (Grid(cell_data={"v": torch.float32})
         .set_initial_length((8, 6, 4)).set_periodic(True, True, False)
         .initialize(["cpu"] * n_dev))
    assert plan_fingerprint(g.clone()) == plan_fingerprint(g)


def test_clone_requires_initialized_grid():
    with pytest.raises(RuntimeError):
        Grid(cell_data={"v": torch.float32}).clone()


# -- cached data items --------------------------------------------------

def _add_items(g):
    g.add_cell_data_item(
        "on_dev0",
        lambda g, ids: g.plan.owner[np.searchsorted(g.plan.cells, ids)] == 0)
    g.add_neighbor_data_item(
        "dist", lambda g, src, nbr, off: np.abs(off).sum(axis=1))


def test_cell_and_neighbor_items_recomputed():
    """tests/test_api_completeness.py's scenario on both packages; the
    item values are equal at every epoch."""
    r, p = make_pair(max_lvl=1)
    for g in (r, p):
        _add_items(g)
        assert g.cell_data_item("on_dev0").sum() == np.sum(g.plan.owner == 0)
        first = int(g.get_cells()[0])
        assert len(g.neighbor_data_item("dist", first)) == \
            len(g.get_neighbors_of(first))
    np.testing.assert_array_equal(p.cell_data_item("on_dev0"),
                                  r.cell_data_item("on_dev0"))
    np.testing.assert_array_equal(p.neighbor_data_item("dist"),
                                  r.neighbor_data_item("dist"))
    n_before = len(p.cell_data_item("on_dev0"))
    for g in (r, p):
        _refine_first(g)
    assert len(p.cell_data_item("on_dev0")) == n_before + 7
    np.testing.assert_array_equal(p.cell_data_item("on_dev0"),
                                  r.cell_data_item("on_dev0"))
    np.testing.assert_array_equal(p.neighbor_data_item("dist"),
                                  r.neighbor_data_item("dist"))
    ids = p.get_cells()[3:9]
    np.testing.assert_array_equal(p.cell_data_item("on_dev0", ids),
                                  r.cell_data_item("on_dev0", ids))
    assert p.cell_data_item("on_dev0", ids[0]) == \
        r.cell_data_item("on_dev0", ids[0])
    for g in (r, p):
        g.remove_cell_data_item("on_dev0")
        with pytest.raises(KeyError):
            g.cell_data_item("on_dev0")
    with pytest.raises(KeyError):
        p.cell_data_item("dist")


def test_items_recomputed_at_balance_and_dropped_with_hood():
    g = (Grid(cell_data={"rho": torch.float32})
         .set_initial_length((8, 4, 4)).set_periodic(True, True, True)
         .set_load_balancing_method("block").initialize(["cpu"] * 4))
    _add_items(g)
    g.add_neighborhood(7, [(1, 0, 0), (-1, 0, 0)])
    g.add_neighbor_data_item("x_only", lambda g, s, n, o: o[:, 0],
                             neighborhood_id=7)
    g.set_load_balancing_method("rcb")
    g.balance_load()
    want = g.plan.owner == 0
    np.testing.assert_array_equal(g.cell_data_item("on_dev0"), want)
    assert np.all(np.abs(g.neighbor_data_item("x_only")) == 1)
    g.remove_neighborhood(7)
    with pytest.raises(KeyError):
        g.neighbor_data_item("x_only")


def test_items_of_a_loaded_grid(tmp_path):
    """A grid restored from a file recomputes its items at load."""
    g = (Grid(cell_data={"rho": torch.float32})
         .set_initial_length((4, 4, 4)).set_maximum_refinement_level(1)
         .initialize("cpu"))
    _refine_first(g)
    path = str(tmp_path / "g.dc")
    g.save_grid_data(path)
    h = (Grid(cell_data={"rho": torch.float32})
         .set_initial_length((4, 4, 4)).set_maximum_refinement_level(1)
         .initialize("cpu"))
    h.add_cell_data_item("lvl", lambda g, ids:
                         g.mapping.get_refinement_level(ids))
    h.load_grid_data(path)
    np.testing.assert_array_equal(
        h.cell_data_item("lvl"), g.mapping.get_refinement_level(g.plan.cells))


def test_maximum_refinement_level_difference():
    r, p = make_pair(n_dev=1)
    assert p.get_maximum_refinement_level_difference() == \
        r.get_maximum_refinement_level_difference() == 1


# -- VTK ----------------------------------------------------------------

def _vtk_pair(n_dev=2, length=(2, 2, 1)):
    r = (RefGrid(cell_data={"v": jnp.float32})
         .set_initial_length(length).set_maximum_refinement_level(1)
         .initialize(mesh_of(n_dev)))
    p = (Grid(cell_data={"v": torch.float32})
         .set_initial_length(length).set_maximum_refinement_level(1)
         .initialize(["cpu"] * n_dev))
    for g in (r, p):
        g.refine_completely(1)
        g.stop_refining()
        cells = g.get_cells()
        g.set("v", cells, np.arange(len(cells), dtype=np.float32) * 0.37)
    return r, p


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fields", [["v"], None])
def test_vtk_output_bytes_equal_reference(tmp_path, fields):
    r, p = _vtk_pair()
    fr, fp = str(tmp_path / "r.vtk"), str(tmp_path / "p.vtk")
    r.write_vtk_file(fr, fields=fields)
    p.write_vtk_file(fp, fields=fields)
    assert _read(fp) == _read(fr)
    text = _read(fp).decode()
    cells = p.get_cells()
    assert "UNSTRUCTURED_GRID" in text
    assert f"CELLS {len(cells)}" in text
    assert f"POINTS {8 * len(cells)} float" in text
    assert ("SCALARS v double 1" in text) == bool(fields)


def test_vtk_partitions_write_one_partitions_bytes(tmp_path):
    a, b = str(tmp_path / "a.vtk"), str(tmp_path / "b.vtk")
    _vtk_pair(1, (4, 4, 2))[1].write_vtk_file(a, fields=["v"])
    _vtk_pair(4, (4, 4, 2))[1].write_vtk_file(b, fields=["v"])
    assert _read(a) == _read(b)


def test_dc_to_vtk_bytes_equal_reference(tmp_path):
    """A port-written .dc converts to the same .vtk bytes with either
    package's converter, and the port's CLI writes them too."""
    _r, p = _vtk_pair()
    dc = str(tmp_path / "state.dc")
    p.save_grid_data(dc, header=b"hdr!")
    spec = {"v": ((), np.float32)}
    out_p, out_r = str(tmp_path / "p.vtk"), str(tmp_path / "r.vtk")
    written = dc_to_vtk(dc, out_p, fields=spec, header_size=4)
    np.testing.assert_array_equal(written, p.get_cells())
    ref_dc_to_vtk(dc, out_r, fields=spec, header_size=4)
    assert _read(out_p) == _read(out_r)
    assert f"CELL_DATA {len(written)}" in _read(out_p).decode()
    out_c = str(tmp_path / "cli.vtk")
    port_vtk.main([dc, out_c, "--field", "v:float32", "--header-size", "4",
                   "--title", "dccrg_tpu"])
    assert _read(out_c) == _read(out_p)
    with pytest.raises(SystemExit):
        port_vtk._parse_field_spec(["bad"])
    assert port_vtk._parse_field_spec(["pos:float32:16x3"]) == \
        {"pos": ((16, 3), np.dtype("float32"))}


# -- AmrAdvection.from_grid ---------------------------------------------

@pytest.mark.parametrize("n_dev", [1, 2])
def test_amr_advection_from_grid_continues_bitwise(tmp_path, n_dev):
    """Run, save the .dc, restore with Grid.from_file, wrap with
    from_grid and continue: bit for bit an uninterrupted run."""
    dev = ["cpu"] * n_dev
    ref = AmrAdvection((16, 16, 1), 1, device=dev)
    first = AmrAdvection((16, 16, 1), 1, device=dev)
    first.grid.set("density", first.grid.get_cells(),
                   ref.grid.get("density", ref.grid.get_cells()))
    ref.run(8, adapt_n=2)
    first.run(4, adapt_n=2)
    path = str(tmp_path / "amr.dc")
    first.grid.save_grid_data(path)
    grid, _hdr = Grid.from_file(path, first.grid.fields, device=dev)
    app = AmrAdvection.from_grid(grid, time=first.time)
    app.run(4, adapt_n=2)
    assert app.time == ref.time
    np.testing.assert_array_equal(app.grid.plan.cells, ref.grid.plan.cells)
    # the load partitions the cells anew, so compare by cell, not by
    # partition rows
    cells = ref.grid.plan.cells
    for n in ("density", "flux", "max_diff"):
        assert app.grid.get(n, cells).tobytes() == \
            ref.grid.get(n, cells).tobytes(), n
