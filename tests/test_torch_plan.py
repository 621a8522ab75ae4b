"""The port's closed-form single-device plan against the reference.

Both packages build the plan of a complete level-0 grid; the port's
must agree bit for bit: the row layout (``L``, ``R``), the per-slot
offsets, the roll plan (flat shifts, wrong rows, true sources) and the
bulk executor's fixup cascade tables (``build_epilogue_sets``).
"""

import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dccrg_tpu.grid import DEFAULT_NEIGHBORHOOD_ID, Grid, default_mesh
from dccrg_tpu.ops import roll_executor as ref_exec

import dccrg_tpu_torch as port
from dccrg_tpu_torch.ops import roll_executor as port_exec

DIMS = [(16, 16, 16), (24, 24, 24), (8, 12, 20)]
PERIODIC = list(itertools.product((False, True), repeat=3))


def _ref_grid(dims, periodic, hood_len):
    return (Grid(cell_data={"rho": jnp.float32})
            .set_initial_length(dims).set_periodic(*periodic)
            .set_maximum_refinement_level(0)
            .set_neighborhood_length(hood_len)
            .initialize(default_mesh(jax.devices()[:1])))


def _port_grid(dims, periodic, hood_len, cell_data=None):
    return (port.Grid(cell_data={"rho": "float32"} if cell_data is None
                      else cell_data)
            .set_initial_length(dims).set_periodic(*periodic)
            .set_maximum_refinement_level(0)
            .set_neighborhood_length(hood_len)
            .initialize("cpu"))


@pytest.mark.parametrize("hood_len", [0, 1])
@pytest.mark.parametrize("dims", DIMS)
def test_plan_matches_reference(dims, hood_len):
    for periodic in PERIODIC:
        g, p = _ref_grid(dims, periodic, hood_len), _port_grid(dims, periodic, hood_len)
        msg = f"dims={dims} periodic={periodic} hood={hood_len}"
        assert (g.plan.L, g.plan.R) == (p.plan.L, p.plan.R), msg
        assert p.plan.R == p.plan.L + 1
        assert p.plan.L == port.bucket_capacity(int(np.prod(dims)))
        hr = g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID]
        hp = p.plan.hoods[port.DEFAULT_NEIGHBORHOOD_ID]
        np.testing.assert_array_equal(np.asarray(hr.offs_const), hp.offs_const,
                                      err_msg=msg)
        cr, cp = hr.closed_form, hp.closed_form
        assert tuple(cr["dims"]) == tuple(cp["dims"]), msg
        assert tuple(cr["periodic"]) == tuple(cp["periodic"]), msg
        assert cr["n0"] == cp["n0"], msg
        np.testing.assert_array_equal(cr["offsets"], cp["offsets"], err_msg=msg)
        rr, rp = hr.roll_plan(g.plan.L), hp.roll_plan(p.plan.L)
        for name, a, b in zip(("shifts", "wrong_rows", "wrong_src"), rr, rp):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{name}: {msg}")
        # the lazy dense tables agree too (host introspection path)
        np.testing.assert_array_equal(np.asarray(hr.nbr_rows), hp.nbr_rows,
                                      err_msg=msg)
        np.testing.assert_array_equal(np.asarray(hr.nbr_mask), hp.nbr_mask,
                                      err_msg=msg)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("dims,periodic,hood_len", [
    ((16, 16, 16), (True, True, False), 0),
    ((24, 24, 24), (True, True, True), 0),
    ((8, 12, 20), (False, True, False), 1),
    ((16, 16, 16), (False, False, False), 1),
])
def test_epilogue_sets_match_reference(dims, periodic, hood_len, k):
    g, p = _ref_grid(dims, periodic, hood_len), _port_grid(dims, periodic, hood_len)
    hr = g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID]
    hp = p.plan.hoods[port.DEFAULT_NEIGHBORHOOD_ID]
    cf = hr.closed_form
    rr = hr.roll_plan(g.plan.L)
    spec_r = ref_exec.RollPassSpec(rr[0], cf["dims"], cf["periodic"],
                                   cf["offsets"], cf["n0"], g.plan.L, k)
    spec_p = port_exec._grid_spec_for(p, hp)
    assert spec_p is not None
    assert spec_p.L == g.plan.L
    assert spec_p.shifts == spec_r.shifts
    tr = ref_exec.build_epilogue_sets(spec_r, rr[1])
    tp = port_exec.build_epilogue_sets(spec_p, hp.roll_plan(p.plan.L)[1], k)
    assert len(tr) == len(tp) == k
    for t, (a, b) in enumerate(zip(tr, tp)):
        for name, x, y in zip(("rows", "nbr", "mask"), a, b):
            np.testing.assert_array_equal(x, y, err_msg=f"table {t} {name}")


# a user neighbourhood with reach 2 in y and z
REACH2_HOOD = [(1, 2, 0), (-1, -2, 0), (1, 0, 2), (-1, 0, -2), (0, 1, 0)]


def test_pass_spec_geometry():
    """The port's step geometry: the face set takes the plane-tile
    route with z cut into chunks and the bound counts one step; every
    other slot set takes the direct route."""
    # no fields: only the host plan is built, nothing is allocated
    p = _port_grid((512, 512, 512), (True, True, False), 0, cell_data={})
    hood = p.plan.hoods[port.DEFAULT_NEIGHBORHOOD_ID]
    spec = port_exec._grid_spec_for(p, hood)
    # face hood: the upwind flux reads x and y neighbors only
    assert len(spec.slots) == 4
    assert spec.face4
    assert spec.tile == (128, 16, 32)
    assert spec.bytes_moved(4) == 4 * 2 ** 27 * 4
    # one face term of 6 for each face slot and the final add; a
    # k-deep pass computes the face coefficients once (16 + 9k)
    assert spec.flops() == 25 * 2 ** 27
    assert spec.flops(8) == 88 * 2 ** 27
    assert p.plan.L == 2 ** 27 and p.plan.R == 2 ** 27 + 1
    # the 26-cube: the direct route
    q = _port_grid((8, 12, 20), (False, True, False), 1, cell_data={})
    spec = port_exec._grid_spec_for(q, q.plan.hoods[port.DEFAULT_NEIGHBORHOOD_ID])
    assert not spec.face4 and spec.tile == (32, 8, 1)
    # reach 2 in y and z (a user neighbourhood): the direct route
    q = _port_grid((8, 12, 20), (True, True, True), 2, cell_data={})
    assert q.add_neighborhood(7, REACH2_HOOD)
    spec = port_exec._grid_spec_for(q, q.plan.hoods[7])
    assert not spec.face4 and spec.tile == (32, 8, 1)


NL_FIELDS = ("of_source", "of_neighbor", "of_offset", "of_item",
             "to_source", "to_neighbor", "to_offset")


@pytest.mark.parametrize("periodic", PERIODIC)
@pytest.mark.parametrize("hood_len", [0, 1])
@pytest.mark.parametrize("dims", [(8, 12, 20), (2, 1, 5)])
def test_neighbor_lists_match_reference(dims, hood_len, periodic):
    """The port's level-0 neighbor lists (computed from the indices)
    against the reference engine's, bit for bit and dtype for dtype:
    non-periodic edges drop neighbors, and periodic axes of length 1
    and 2 make a cell its own neighbor or both sides the same cell."""
    g, p = _ref_grid(dims, periodic, hood_len), _port_grid(dims, periodic, hood_len)
    lr = g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID].lists
    lp = p.plan.hoods[port.DEFAULT_NEIGHBORHOOD_ID].lists
    for name in NL_FIELDS:
        a, b = np.asarray(getattr(lr, name)), getattr(lp, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_neighbor_lists_refuse_refined_cells():
    """A cell set other than the complete level-0 grid goes through the
    AMR engine, which refuses a set that does not tile the grid (a
    missing cell) with the reference's StructureError."""
    from dccrg_tpu_torch.neighbors import StructureError, build_neighbor_lists

    p = _port_grid((4, 4, 4), (True, True, True), 1)
    with pytest.raises(StructureError):
        build_neighbor_lists(p.mapping, p.topology, p.plan.cells[:-1],
                             p.neighborhoods[port.DEFAULT_NEIGHBORHOOD_ID])
