"""The port's general-grid PoissonSolver on n partitions against the
reference's on its virtual mesh.

tests/test_poisson.py's partitioned configurations, each built by both
packages with the same seeded numpy rhs (and Dirichlet or skip data):
the reference on ``Mesh(jax.devices()[:n], ("dev",))``, the port on
``["cpu"] * n``. The port solves in four modes — the host loop
(``fused=False``), the fused solve with the overlap off
(``DCCRG_OVERLAP=0``), on (``DCCRG_OVERLAP=1``: the split exchange and
the outer re-pass) and on with ``DCCRG_GHOST_SPLIT=0`` (which turns the
fused overlap off, as in the reference) — and each mode is held to:

- the reference's host-loop solve (its fused program stops elsewhere
  once the target sits below float32's floor: 7 iterations against its
  host loop's 10 on "dirichlet"'s rtol 1e-8): solution within 1e-4 of
  its peak, iterations within 2 (dots over partitions sum in another
  order);
- the port's own one-partition solve of the same system: within 1e-4
  of the peak, iterations within 2;
- the system itself: the recomputed residual ``|A x - b|`` below
  1e-3 of ``|b|`` on the solved cells (of ``|x|`` when ``b`` is zero).
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dccrg_tpu.models import poisson as ref

from dccrg_tpu_torch.models import poisson as port

SOL_TOL, IT_TOL = 1e-4, 2


def _build(pkg, name, n_dev):
    """(solver, rhs, solve kwargs) of one configuration of
    tests/test_poisson.py."""
    if pkg is ref:
        dev = Mesh(np.array(jax.devices()[:n_dev]), ("dev",))
        kw = dict(mesh=dev, dtype=jnp.float32)
    else:
        kw = dict(device=["cpu"] * n_dev, dtype=torch.float32)
    P = pkg.PoissonSolver
    if name == "1d_periodic":
        n = 32
        s = P((n, 1, 1), periodic=(True, False, False), **kw)
        x = s.grid.geometry.get_center(s.grid.get_cells())[:, 0] / n
        lam = -(2 - 2 * np.cos(2 * np.pi / n))
        return s, (lam * np.sin(2 * np.pi * x)).astype(np.float32), {}
    if name == "2d":
        rng = np.random.default_rng(3)
        rhs = rng.standard_normal(64).astype(np.float32)
        return (P((8, 8, 1), periodic=(True, True, False), **kw),
                rhs - rhs.mean(), {})
    if name == "3d_residual":
        rng = np.random.default_rng(0)
        return (P((8, 8, 8), **kw),
                rng.standard_normal(512).astype(np.float32), {})
    if name == "dirichlet":
        s = P((8, 1, 1), periodic=(False, False, False), **kw)
        cells = s.grid.get_cells()
        x = s.grid.geometry.get_center(cells)[:, 0]
        boundary = cells[(x < 1) | (x > 7)]
        s.grid.set("solution", boundary, (3 * x[(x < 1) | (x > 7)] + 1)
                   .astype(np.float32))
        return (s, np.zeros(len(cells), np.float32),
                dict(cells_to_solve=cells[(x > 1) & (x < 7)]))
    if name == "skip":
        s = P((9, 1, 1), periodic=(False, False, False), **kw)
        cells = s.grid.get_cells()
        x = s.grid.geometry.get_center(cells)[:, 0]
        mid = cells[len(cells) // 2]
        s.grid.set("solution", np.array([mid]), np.array([123.0], np.float32))
        rng = np.random.default_rng(5)
        rhs = rng.standard_normal(len(cells)).astype(np.float32)
        for half in (x < x[4], x > x[4]):
            rhs[half] -= rhs[half].mean()
        return s, rhs, dict(cells_to_solve=cells[cells != mid],
                            cells_to_skip=[mid])
    if name == "refined":
        s = P((8, 8, 4), periodic=(True, False, False),
              max_refinement_level=1, **kw)
        s.grid.refine_completely(1)
        s.grid.stop_refining()
        cells = s.grid.get_cells()
        centers = s.grid.geometry.get_center(cells)
        rng = np.random.default_rng(0)
        rhs = (np.sin(centers[:, 0]) + 0.1 * rng.random(len(cells)))
        return (s, rhs.astype(np.float32),
                dict(cells_to_solve=cells[centers[:, 1] > 1.5]))
    raise KeyError(name)


CONFIGS = {  # name: (partitions, rtol, max_iterations)
    "1d_periodic": (4, 1e-6, 500),
    "2d": (8, 1e-6, 1000),
    "3d_residual": (8, 1e-5, 2000),
    "dirichlet": (2, 1e-8, 500),
    "skip": (2, 1e-6, 500),
    "refined": (4, 1e-6, 60),
}

MODES = {  # name: (fused, environment)
    "host": (False, {"DCCRG_OVERLAP": "0"}),
    "fused": (True, {"DCCRG_OVERLAP": "0"}),
    "fused_overlap": (True, {"DCCRG_OVERLAP": "1"}),
    "fused_overlap_nosplit": (True, {"DCCRG_OVERLAP": "1",
                                     "DCCRG_GHOST_SPLIT": "0"}),
}


def _solve(pkg, name, n_dev, fused):
    s, rhs, kw = _build(pkg, name, n_dev)
    _parts, rtol, it = CONFIGS[name]
    s.set_rhs(rhs)
    info = s.solve(rtol=rtol, max_iterations=it, fused=fused, **kw)
    return s, rhs, kw, info, np.asarray(s.solution(), np.float64)


@functools.lru_cache(maxsize=None)
def _reference(name):
    _s, _rhs, _kw, info, sol = _solve(ref, name, CONFIGS[name][0], False)
    return info, sol


@functools.lru_cache(maxsize=None)
def _one_partition(name):
    _s, _rhs, _kw, info, sol = _solve(port, name, 1, True)
    return info, sol


def _residual(s, rhs, kw):
    """|A x - b| / |b| over the solved cells, recomputed by the host
    loop's exchange and matvec (tests/test_poisson.py's check)."""
    g = s.grid
    cells = g.get_cells()
    g.data["p0"] = g.data["solution"].clone()
    s._exchange_p(["p0"])
    s._apply(transpose=False)
    solve = kw.get("cells_to_solve", cells)
    sel = np.isin(cells, solve)
    ax = g.get("Ap0", cells)[sel].astype(np.float64)
    b = rhs[sel].astype(np.float64)
    if "cells_to_solve" not in kw:
        b = b - b.mean()
    r = ax - b
    if kw.get("cells_to_skip") is not None:  # decoupled halves
        x = g.geometry.get_center(cells)[sel, 0]
        mid = g.geometry.get_center(np.asarray(kw["cells_to_skip"],
                                               np.uint64))[0, 0]
        for m in (x < mid, x > mid):
            r[m] -= r[m].mean()
    elif "cells_to_solve" not in kw:
        r -= r.mean()
    # a Laplace problem (zero rhs, Dirichlet data) is measured against
    # the solution's size
    scale = np.linalg.norm(b) or np.linalg.norm(
        g.get("solution", cells)[sel].astype(np.float64))
    return float(np.linalg.norm(r) / scale)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_partitioned_solve_matches_reference(name, mode, monkeypatch):
    fused, env = MODES[mode]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    n_dev = CONFIGS[name][0]
    s, rhs, kw, info, sol = _solve(port, name, n_dev, fused)
    assert s.grid.n_dev == n_dev
    if fused:
        # a hybrid (refined) plan has no outer re-pass: no overlap
        assert s.last_overlap == (mode == "fused_overlap"
                                  and name != "refined")
    scale = max(np.abs(sol).max(), 1e-30)
    for want_info, want in (_reference(name), _one_partition(name)):
        assert abs(info["iterations"] - want_info["iterations"]) <= IT_TOL, (
            info, want_info)
        assert np.abs(sol - want).max() <= SOL_TOL * scale
    assert _residual(s, rhs, kw) < 1e-3, info


def test_overlap_repass_rows_cover_the_refreshed_ghosts():
    """The fused overlap re-runs exactly the rows whose gather reads a
    ghost refreshed by the p0 exchange: on 4 partitions of an 8^3 grid
    every partition has rows to redo, and one iteration of the
    overlapped solve equals one of the plain fused solve bit for bit."""
    outs = []
    for ov in ("0", "1"):
        os.environ["DCCRG_OVERLAP"] = ov
        try:
            s, rhs, _kw = _build(port, "3d_residual", 4)
            s.set_rhs(rhs)
            info = s.solve(rtol=1e-5, max_iterations=1)
        finally:
            os.environ.pop("DCCRG_OVERLAP", None)
        outs.append((info, s.grid.data["solution"].clone(), s.last_overlap))
    assert outs[0][2] is False and outs[1][2] is True
    assert outs[0][0] == outs[1][0]
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=0, atol=0)
