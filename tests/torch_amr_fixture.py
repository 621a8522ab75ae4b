"""Shared helpers of the port's AMR parity tests (test_torch_amr.py,
test_torch_hybrid.py, test_torch_advection_amr.py): the same grid built
by the reference on a one-device mesh and by the port on the CPU, and
the bitwise comparison of their structure plans."""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch

from dccrg_tpu.grid import Grid as RefGrid

import dccrg_tpu_torch as port

HOOD_TABLES = ("nbr_rows", "nbr_mask", "nbr_offs", "offs_const", "hard_rows",
               "hard_nbr_rows", "hard_offs", "hard_mask", "scale_rows",
               "to_rows", "to_offs", "to_mask", "send_rows", "recv_rows")
LIST_FIELDS = ("of_source", "of_neighbor", "of_offset", "of_item",
               "to_source", "to_neighbor", "to_offset")


def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("dev",))


def grid_pair(length=(4, 4, 4), max_lvl=2, hood=1, periodic=(False,) * 3,
              user_hood=None):
    """(reference grid, port grid) with one float32 field ``v``."""
    r = (RefGrid(cell_data={"v": jnp.float32})
         .set_initial_length(length).set_periodic(*periodic)
         .set_maximum_refinement_level(max_lvl)
         .set_neighborhood_length(hood).initialize(mesh1()))
    p = (port.Grid(cell_data={"v": torch.float32})
         .set_initial_length(length).set_periodic(*periodic)
         .set_maximum_refinement_level(max_lvl)
         .set_neighborhood_length(hood).initialize("cpu"))
    if user_hood is not None:
        r.add_neighborhood(42, user_hood)
        p.add_neighborhood(42, user_hood)
    return r, p


def both(pair, fn):
    """``fn(grid)`` on both grids; returns both results."""
    return tuple(fn(g) for g in pair)


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(b, a, err_msg=what)


PAIR_KEYS = ("n_dev", "M", "p", "q", "pos", "srow", "rrow")


def assert_plans_equal(r, p, lists=True):
    """Layout (every partition's local and ghost ids), every hood's
    dense, hard, to- and pair tables (dense and compact) and (with
    ``lists``) the flat neighbor lists: bit for bit."""
    rp, pp = r.plan, p.plan
    _equal(rp.cells, pp.cells, "cells")
    _equal(rp.owner, pp.owner, "owner")
    assert (rp.n_dev, rp.L, rp.R) == (pp.n_dev, pp.L, pp.R), (
        (rp.n_dev, rp.L, rp.R), (pp.n_dev, pp.L, pp.R))
    _equal(rp.n_local, pp.n_local, "n_local")
    _equal(rp.row_of_pos, pp.row_of_pos, "row_of_pos")
    for a, b, what in ((rp.local_ids, pp.local_ids, "local_ids"),
                       (rp.ghost_ids, pp.ghost_ids, "ghost_ids")):
        assert len(a) == len(b) == rp.n_dev
        for d in range(rp.n_dev):
            _equal(a[d], b[d], f"{what}[{d}]")
    assert set(rp.hoods) == set(pp.hoods)
    for hid in rp.hoods:
        a, b = rp.hoods[hid], pp.hoods[hid]
        assert (a.closed_form is None) == (b.closed_form is None), hid
        for name in HOOD_TABLES:
            x, y = getattr(a, name), getattr(b, name)
            if x is None:
                assert y is None, (hid, name)
            else:
                _equal(x, y, f"{hid} {name}")
        _equal(a.n_inner if a.n_inner is not None else [],
               b.n_inner if b.n_inner is not None else [], f"{hid} n_inner")
        for k in PAIR_KEYS:
            _equal(np.asarray(a.pair_compact[k]), np.asarray(b.pair_compact[k]),
                   f"{hid} pair {k}")
        if lists:
            for f in LIST_FIELDS:
                _equal(getattr(a.lists, f), getattr(b.lists, f), f"{hid} {f}")
