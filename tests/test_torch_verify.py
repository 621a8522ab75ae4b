"""The port's DEBUG verifiers (verify.py) against the reference's.

tests/test_verify.py's scenarios, each run by both packages on eight
partitions (the reference on its virtual mesh, the port on
``["cpu"] * 8``): healthy grids pass ``verify_all``; every corruption of
derived state is caught by the matching verifier, with the same message
and naming the same cells as the reference's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dccrg_tpu import verify as RV
from dccrg_tpu.grid import Grid as RefGrid

from dccrg_tpu_torch import Grid, VerificationError, verify_all
from dccrg_tpu_torch import verify as V
from dccrg_tpu_torch.grid import DEFAULT_NEIGHBORHOOD_ID


def make_pair(length=(4, 4, 2), max_lvl=0, hood=1, periodic=True, n=8):
    out = []
    for cls, dt, dev in (
            (RefGrid, np.float32, Mesh(np.array(jax.devices()[:n]), ("dev",))),
            (Grid, torch.float32, ["cpu"] * n)):
        out.append(cls(cell_data={"rho": dt})
                   .set_initial_length(length)
                   .set_maximum_refinement_level(max_lvl)
                   .set_periodic(periodic, periodic, periodic)
                   .set_neighborhood_length(hood)
                   .initialize(dev))
    return out


def _both_fail(fn_ref, fn_port):
    """Run the reference's and the port's verifier; both must raise,
    with the same message and the same cells."""
    with pytest.raises(RV.VerificationError) as er:
        fn_ref()
    with pytest.raises(VerificationError) as ep:
        fn_port()
    assert ep.value.cells == er.value.cells
    assert str(ep.value) == str(er.value)
    return ep.value


def test_healthy_grids_pass():
    r, p = make_pair(max_lvl=2)
    verify_all(p)
    for g in (r, p):
        g.add_neighborhood(7, [[1, 0, 0], [0, 1, 0]])
    verify_all(p)
    for g in (r, p):
        g.refine_completely(int(g.get_cells()[0]))
        g.stop_refining()
    verify_all(p)
    for g in (r, p):
        g.balance_load()
    verify_all(p)
    np.testing.assert_array_equal(p.plan.owner, r.plan.owner)


def test_pin_verified():
    r, p = make_pair()
    cid = int(p.get_cells()[0])
    for g in (r, p):
        g.pin(cid, 3)
        g.balance_load()
    V.pin_requests_succeeded(p)
    for g in (r, p):
        g._pins[cid] = 5
    e = _both_fail(lambda: RV.pin_requests_succeeded(r),
                   lambda: V.pin_requests_succeeded(p))
    assert e.cells == (cid,) and str(cid) in str(e)


def test_corrupt_owner_detected():
    r, p = make_pair()
    for g in (r, p):
        g.plan.owner = g.plan.owner.copy()
        g.plan.owner[0] = 99
    e = _both_fail(lambda: RV.is_consistent(r), lambda: V.is_consistent(p))
    assert int(p.plan.cells[0]) in e.cells


def test_corrupt_neighbor_list_detected():
    r, p = make_pair()
    for g in (r, p):
        nl = g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID].lists
        nl.of_neighbor = nl.of_neighbor.copy()
        nl.of_neighbor[0] = nl.of_neighbor[1]
    e = _both_fail(lambda: RV.verify_neighbors(r), lambda: V.verify_neighbors(p))
    assert len(e.cells) >= 1


@pytest.mark.parametrize("how", ["drop", "swap"])
def test_corrupt_send_list_detected(how):
    """A send slot dropped (padding mismatch) or two send rows swapped
    (a cell sent into another cell's ghost row)."""
    r, p = make_pair()
    for g in (r, p):
        hp = g.plan.hoods[DEFAULT_NEIGHBORHOOD_ID]
        hp._send_rows = np.array(hp.send_rows)
        pq = np.argwhere(hp._send_rows >= 0)
        a, b, j = pq[0]
        if how == "drop":
            hp._send_rows[a, b, j] = -1
        else:
            j2 = pq[(pq[:, 0] == a) & (pq[:, 1] == b)][1, 2]
            hp._send_rows[a, b, [j, j2]] = hp._send_rows[a, b, [j2, j]]
    e = _both_fail(lambda: RV.verify_remote_neighbor_info(r),
                   lambda: V.verify_remote_neighbor_info(p))
    assert (len(e.cells) == 2) == (how == "swap")


def test_corrupt_pad_row_detected():
    r, p = make_pair()
    arr = np.asarray(r.data["rho"]).copy()
    arr[:, r.plan.R - 1] = 1.0
    r.data["rho"] = jnp.asarray(arr, device=r._sharding())
    p.data["rho"][:, p.plan.R - 1] = 1.0
    _both_fail(lambda: RV.verify_user_data(r), lambda: V.verify_user_data(p))
    p.data["rho"] = p.data["rho"].to(torch.float64)
    with pytest.raises(VerificationError, match="dtype"):
        V.verify_user_data(p)


def test_debug_env_hook(monkeypatch):
    """DCCRG_DEBUG=1: the verifiers run after initialize, after every
    rebuild and at every transactional boundary; a healthy commit and a
    balance pass them."""
    monkeypatch.setenv("DCCRG_DEBUG", "1")
    calls = []
    real = V.verify_all
    monkeypatch.setattr(V, "verify_all",
                        lambda g, **kw: (calls.append(kw), real(g, **kw)))
    p = make_pair(max_lvl=1)[1]
    assert p._debug
    p.refine_completely(int(p.get_cells()[0]))
    p.stop_refining()
    p.balance_load()
    p.load_cells(p.get_cells())
    # stop_refining, the balance (its stages joined it) and load_cells
    assert calls == [{"check_pins": False}] * 3


def test_debug_hook_catches_a_bad_rebuild(monkeypatch):
    """Under DCCRG_DEBUG=1 a rebuild outside a transaction runs the
    structure verifiers: a plan with a corrupted owner array fails at
    install."""
    monkeypatch.setenv("DCCRG_DEBUG", "1")
    p = make_pair()[1]
    cells, owner = p.plan.cells, p.plan.owner.copy()
    plan = p._construct_plan(cells, owner)
    plan.owner = owner.copy()
    plan.owner[3] = 99
    with pytest.raises(VerificationError, match="owner out of device range"):
        p._finish_plan(plan)


def test_partition_coverage_detects_double_ownership():
    r, p = make_pair()
    V.verify_partition_coverage(p)
    for g in (r, p):
        stolen = g.plan.local_ids[0][0]
        g.plan.local_ids[1] = np.concatenate([g.plan.local_ids[1], [stolen]])
    e = _both_fail(lambda: RV.verify_partition_coverage(r),
                   lambda: V.verify_partition_coverage(p))
    assert e.cells == (int(stolen),)


def test_partition_coverage_detects_dropped_cell():
    r, p = make_pair()
    for g in (r, p):
        dropped = g.plan.local_ids[2][-1]
        g.plan.local_ids[2] = g.plan.local_ids[2][:-1]
    e = _both_fail(lambda: RV.verify_partition_coverage(r),
                   lambda: V.verify_partition_coverage(p))
    assert int(dropped) in e.cells


def test_refinement_balance_detects_level_jump():
    r, p = make_pair(max_lvl=2)
    for g in (r, p):
        g.refine_completely(1)
        g.stop_refining()
    V.verify_refinement_balance(p)
    for g in (r, p):
        lvl = g.mapping.get_refinement_level(g.plan.cells)
        child = g.plan.cells[lvl == 1][0]
        grandkids = g.mapping.get_all_children(np.uint64(child))
        g.plan.cells = np.sort(np.concatenate(
            [g.plan.cells[g.plan.cells != child], grandkids]))
    e = _both_fail(lambda: RV.verify_refinement_balance(r),
                   lambda: V.verify_refinement_balance(p))
    assert any(int(k) in e.cells for k in grandkids)


def test_neighbor_symmetry_detects_dropped_edge(monkeypatch):
    r, p = make_pair()
    V.verify_neighbor_symmetry(p)
    for mod in (RV, V):
        real = mod.find_neighbors_to_subset

        def lossy(mapping, topology, cells, query, offsets, real=real):
            qi, src, off = real(mapping, topology, cells, query, offsets)
            return qi[:-1], src[:-1], off[:-1]

        monkeypatch.setattr(mod, "find_neighbors_to_subset", lossy)
    e = _both_fail(lambda: RV.verify_neighbor_symmetry(r),
                   lambda: V.verify_neighbor_symmetry(p))
    assert len(e.cells) >= 1


def test_verify_all_check_pins_flag():
    r, p = make_pair()
    cid = int(p.get_cells()[0])
    for g in (r, p):
        g.pin(cid, (g.get_process(cid) + 1) % 8)
    verify_all(p, check_pins=False)
    _both_fail(lambda: RV.verify_all(r), lambda: verify_all(p))


def test_find_nonfinite_cells_names_the_same_cells():
    r, p = make_pair()
    cells = p.get_cells()
    bad = cells[[2, 5, 17]]
    vals = np.ones(len(cells), np.float32)
    vals[[2, 5]] = np.nan
    vals[17] = np.inf
    for g in (r, p):
        g.set("rho", cells, vals)
    got = V.find_nonfinite_cells(p)
    want = RV.find_nonfinite_cells(r)
    assert list(got) == list(want) == ["rho"]
    np.testing.assert_array_equal(got["rho"], want["rho"])
    np.testing.assert_array_equal(np.sort(got["rho"]), np.sort(bad))
