"""Poisson solvers on partitions of one device.

Port of ``dccrg_tpu/models/poisson.py``, the equivalent of the
reference's tests/poisson solver family (tests/poisson/poisson_solve.hpp):

- ``PoissonSolver``: the Numerical-Recipes 2.7.6 biconjugate scheme over
  grid cells, with per-cell per-direction geometry factors, boundary
  (Dirichlet) cells and skipped cells, on the general ``Grid``
  (``apply_stencil`` over a face neighborhood), on one or n partitions:
  ``p0``/``p1`` ghosts are exchanged before each matvec, and the fused
  solve can overlap that exchange with the matvecs (the ghost split).
  The factor arithmetic keeps its AMR branches (``ilen``, the f/4
  weights of finer neighbors) so it reads as the reference does.
- ``DensePoissonSolver``: conjugate gradients on ``DenseGrid`` (one
  block or a ``dense_mesh`` of blocks) with the 7-point Laplacian as
  plain PyTorch on each halo-padded block — the dense yardstick of the
  Poisson bench.
- ``cg_solve``: plain conjugate gradients over any ``matvec`` callable
  on tensors, shared by ``DensePoissonSolver`` and ``CudaPoissonSolver``
  (ops/poisson_kernel.py, kernel C).

Global dot products are ``torch.sum`` reductions read back to the host
with ``float()``, as the reference reads its jnp sums; on n partitions
each partition sums its local rows and the partition sums are added
(comm.py's reduction over the partition axis). The reference's fused
solve is one XLA program with a device while-loop; PyTorch has none, so
the port's fused solve keeps every scalar of the iteration on the
device and reads one flag per iteration for the loop condition.
Partitions on distinct cards wait for ROADMAP.md queue 1, item 5b.1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dense import AXES, DenseGrid
from ..grid import Grid, as_torch_dtype, resolve_device
from ..neighbors import face_masks, make_neighborhood
from ..ops.poisson_kernel import rdd2_coefficients

POISSON_NEIGHBORHOOD_ID = 0xB01550

# cell_type values (poisson_solve.hpp:143-149)
SOLVE_CELL, BOUNDARY_CELL, SKIP_CELL = 1, 0, -1


def poisson_fields(dtype=torch.float32):
    """The solver's field spec at a given float width. The reference
    solver is double-precision throughout (poisson_solve.hpp:47-141);
    ``poisson_fields(torch.float64)`` is the parity mode, float32 the
    card's working width."""
    f = as_torch_dtype(dtype)
    return {
        "rhs": f, "solution": f,
        "r0": f, "r1": f,
        "p0": f, "p1": f, "Ap0": f,
        "fxp": f, "fxn": f,
        "fyp": f, "fyn": f,
        "fzp": f, "fzn": f,
        "scale": f, "ctype": torch.int32, "ilen": torch.int32,
    }


POISSON_FIELDS = poisson_fields(torch.float32)

_F_NAMES = (("fxp", "fxn"), ("fyp", "fyn"), ("fzp", "fzn"))
_GEOMETRY_FIELDS = [n for pair in _F_NAMES for n in pair] + ["scale", "ctype", "ilen"]


def _matvec_kernel(transpose: bool):
    """A·p (or transpose(A)·p) over face neighbors
    (poisson_solve.hpp:296-338 forward, :422-466 transpose)."""
    src = "p1" if transpose else "p0"

    def kernel(cell, nbr, offs, mask):
        p_c = cell[src]
        p_n = nbr[src]
        faces = face_masks(cell["ilen"][:, None], nbr["ilen"], offs, mask)
        if transpose:
            # transpose reads A[n, c]: the /4 averaging applies when
            # THIS cell is the finer side of n's face (:463-466)
            finer = cell["ilen"][:, None] < nbr["ilen"]
        else:
            # finer face neighbors: 4 per direction, each weighted f/4
            finer = nbr["ilen"] < cell["ilen"][:, None]
        w = torch.where(finer, 0.25, 1.0) * (nbr["ctype"] != SKIP_CELL)
        acc = cell["scale"] * p_c
        for d, (face_pos, face_neg) in enumerate(faces):
            if transpose:
                # neighbor's factor of the opposite direction (:436-455)
                m_pos = nbr[_F_NAMES[d][1]]
                m_neg = nbr[_F_NAMES[d][0]]
            else:
                m_pos = cell[_F_NAMES[d][0]][:, None]
                m_neg = cell[_F_NAMES[d][1]][:, None]
            acc = acc + torch.sum(torch.where(face_pos, m_pos * w * p_n, 0.0), dim=1)
            acc = acc + torch.sum(torch.where(face_neg, m_neg * w * p_n, 0.0), dim=1)
        return {"out": acc}

    def wrapped(cell, nbr, offs, mask):
        out = kernel(cell, nbr, offs, mask)
        # only solve cells carry the result; others stay 0
        return {("r1" if transpose else "Ap0"):
                torch.where(cell["ctype"] == SOLVE_CELL, out["out"], 0.0)}

    return wrapped


class PoissonSolver:
    """Biconjugate Poisson solve on the general grid.

    Either wraps an existing grid declared with ``poisson_fields`` (the
    reference solver is grid-agnostic the same way,
    poisson_solve.hpp:252-258) or builds a uniform one from ``length``
    on ``device`` (``"cuda"`` when None; a list of n devices is n
    partitions, as ``Grid.initialize`` takes them).
    """

    def __init__(self, length=None, device=None, periodic=(True, True, True),
                 dtype=torch.float32, grid: Grid | None = None,
                 max_refinement_level: int = 0):
        if grid is not None:
            self.grid = grid
        else:
            self.grid = (
                Grid(cell_data=poisson_fields(dtype))
                .set_initial_length(length)
                .set_periodic(*periodic)
                .set_maximum_refinement_level(max_refinement_level)
                .set_neighborhood_length(1)
                .initialize(device)
            )
        missing = [n for n in POISSON_FIELDS if n not in self.grid.fields]
        if missing:
            raise ValueError(f"grid lacks Poisson fields {missing}")
        self.dtype = self.grid.fields["solution"][1]
        self._np_dtype = np.dtype(str(self.dtype).removeprefix("torch."))
        if POISSON_NEIGHBORHOOD_ID not in self.grid.neighborhoods:
            self.grid.add_neighborhood(POISSON_NEIGHBORHOOD_ID, make_neighborhood(0))
        self._fwd = _matvec_kernel(transpose=False)
        self._tr = _matvec_kernel(transpose=True)
        self._prepared_epoch = None
        self._solve_mask = None
        self.last_overlap = None  # whether the last fused solve overlapped

    def _cache_key(self, cells_to_solve, cells_to_skip):
        return (
            self.grid.plan.epoch,
            None if cells_to_solve is None
            else np.asarray(cells_to_solve, np.uint64).tobytes(),
            None if cells_to_skip is None
            else np.asarray(cells_to_skip, np.uint64).tobytes(),
        )

    # -- field setup ---------------------------------------------------

    def set_rhs(self, values) -> None:
        cells = self.grid.get_cells()
        self.grid.set("rhs", cells, np.asarray(values, dtype=self._np_dtype))

    def set_rhs_from(self, fn) -> None:
        """rhs from a function of cell centers."""
        cells = self.grid.get_cells()
        centers = self.grid.geometry.get_center(cells)
        self.set_rhs(fn(centers[:, 0], centers[:, 1], centers[:, 2]))

    def solution(self) -> np.ndarray:
        return self.grid.get("solution", self.grid.get_cells())

    # -- preparation (cache_system_info, poisson_solve.hpp:838-970) ----

    def prepare(self, cells_to_solve=None, cells_to_skip=None) -> None:
        """Classify cells and compute geometry factors for the current
        structure epoch (host float64, as the reference computes them)."""
        g = self.grid
        cells = g.get_cells()
        n = len(cells)

        def positions(ids, what):
            ids = np.asarray(ids, dtype=np.uint64)
            pos = np.searchsorted(cells, ids)
            bad = (pos >= n) | (cells[np.minimum(pos, n - 1)] != ids)
            if bad.any():
                raise ValueError(f"{what} contains unknown cell id(s): "
                                 f"{ids[bad][:5].tolist()}")
            return pos

        ctype = np.full(n, BOUNDARY_CELL, dtype=np.int32)
        if cells_to_solve is None:
            ctype[:] = SOLVE_CELL
        else:
            ctype[positions(cells_to_solve, "cells_to_solve")] = SOLVE_CELL
        if cells_to_skip is not None:
            pos = positions(cells_to_skip, "cells_to_skip")
            # solve wins over skip (poisson_solve.hpp:230-233)
            ctype[pos[ctype[pos] != SOLVE_CELL]] = SKIP_CELL

        lengths = g.geometry.get_length(cells).astype(np.float64)
        half = lengths / 2.0
        ilen = g.mapping.get_cell_length_in_indices(cells).astype(np.int64)

        # host face classification over the face-hood neighbor lists
        nl = g.plan.hoods[POISSON_NEIGHBORHOOD_ID].lists
        src, nbr_pos = nl.of_source, np.searchsorted(cells, nl.of_neighbor)
        offs = nl.of_offset
        ok = ctype[nbr_pos] != SKIP_CELL
        faces = face_masks(ilen[src], ilen[nbr_pos], offs, ok)
        # per (cell, direction, sign): non-skip face neighbor half size
        has = np.zeros((n, 3, 2), dtype=bool)
        nbr_half = np.zeros((n, 3, 2), dtype=np.float64)
        for d in range(3):
            for s, mm in enumerate(faces[d]):
                has[src[mm], d, s] = True
                nbr_half[src[mm], d, s] = half[nbr_pos[mm], d]

        # offsets to neighbor centers; missing/skipped neighbors act as
        # equal-size cells (poisson_solve.hpp:716-723)
        pos_off = half + np.where(has[:, :, 0], nbr_half[:, :, 0], half)
        neg_off = half + np.where(has[:, :, 1], nbr_half[:, :, 1], half)
        tot = pos_off + neg_off
        f_pos = np.where(has[:, :, 0], 2.0 / (pos_off * tot), 0.0)
        f_neg = np.where(has[:, :, 1], 2.0 / (neg_off * tot), 0.0)
        scale = -(f_pos.sum(axis=1) + f_neg.sum(axis=1))

        for d in range(3):
            g.set(_F_NAMES[d][0], cells, f_pos[:, d].astype(self._np_dtype))
            g.set(_F_NAMES[d][1], cells, f_neg[:, d].astype(self._np_dtype))
        g.set("scale", cells, scale.astype(self._np_dtype))
        g.set("ctype", cells, ctype)
        g.set("ilen", cells, ilen.astype(np.int32))
        # the GEOMETRY transfer: factors valid for the whole epoch
        g.update_copies_of_remote_neighbors(
            neighborhood_id=POISSON_NEIGHBORHOOD_ID, fields=_GEOMETRY_FIELDS
        )

        self._solve_mask = g.local_row_mask().to(self.dtype) * (
            g.data["ctype"] == SOLVE_CELL)
        self._prepared_epoch = self._cache_key(cells_to_solve, cells_to_skip)

    # -- reductions ----------------------------------------------------

    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of an ``[n_dev, R]`` tensor: on n partitions each
        partition's sum, then the sum over the partitions."""
        if self.grid.n_dev == 1:
            return torch.sum(x)
        return x.reshape(x.shape[0], -1).sum(dim=1).sum()

    def _dot(self, a: str, b: str) -> float:
        return float(self._psum(self.grid.data[a] * self.grid.data[b]
                                * self._solve_mask))

    def _exchange_p(self, fields) -> None:
        self.grid.update_copies_of_remote_neighbors(
            neighborhood_id=POISSON_NEIGHBORHOOD_ID, fields=fields
        )

    def _apply(self, transpose: bool) -> None:
        fields_in = ["p1" if transpose else "p0", "ilen", "ctype", "scale"] + [
            n for pair in _F_NAMES for n in pair
        ]
        self.grid.apply_stencil(
            self._tr if transpose else self._fwd,
            fields_in,
            ["r1" if transpose else "Ap0"],
            neighborhood_id=POISSON_NEIGHBORHOOD_ID,
        )

    # -- solve (poisson_solve.hpp:252-523) -----------------------------

    def _fused_solve(self, rtol, max_iterations):
        """The biconjugate solve with every scalar of the iteration kept
        on the device: alpha, beta, the three dots and the ``go`` flag
        are 0-dim tensors combined with ``torch.where`` exactly as the
        reference's while-loop body (poisson.py:389-429), and the host
        reads one flag per iteration for the loop condition.

        On n partitions (the reference's ``_fused_solve_fn``,
        poisson.py:273-441) ``p0``'s ghosts are exchanged before the
        initial residual and ``p0``'s and ``p1``'s before each
        iteration's matvecs. With the overlap on (``Grid._use_overlap``
        and ``DCCRG_GHOST_SPLIT`` not 0) the iteration starts the sends,
        runs both matvecs on the pre-exchange state, lands the receives
        and re-runs only the rows whose gather reads a refreshed ghost
        (``Grid._make_outer_repass``), for ``Ap0`` and for ``A^T p1``.
        Returns (solution, iterations, squared residual) as tensors."""
        from ..grid import _land_halos, _send_halos, ghost_split_enabled

        g = self.grid
        hid = POISSON_NEIGHBORHOOD_ID
        fields_in_fwd = ("p0", "ilen", "ctype", "scale") + tuple(
            n for pair in _F_NAMES for n in pair)
        fields_in_tr = ("p1",) + fields_in_fwd[1:]
        fwd_fn, fwd_tables = g._make_stencil(
            self._fwd, fields_in_fwd, ("Ap0",), hid, False)
        tr_fn, tr_tables = g._make_stencil(
            self._tr, fields_in_tr, ("r1",), hid, False)
        statics = tuple(g.data[n] for n in fields_in_fwd[1:])
        mask = self._solve_mask
        dtype, dev = self.dtype, mask.device
        single = g.n_dev == 1
        R = g.plan.R

        rp_fwd = rp_tr = None
        if not single and g._use_overlap() and ghost_split_enabled():
            rp_fwd = g._make_outer_repass(self._fwd, fields_in_fwd, ("Ap0",),
                                          hid, ("p0",))
            rp_tr = g._make_outer_repass(self._tr, fields_in_tr, ("r1",),
                                         hid, ("p1",))
        overlap = rp_fwd is not None and rp_tr is not None
        self.last_overlap = overlap
        if not single:
            g1 = g._exchange_groups(hid, ("p0",))
            g2 = g._exchange_groups(hid, ("p0", "p1"))
            side = (g._side_stream()
                    if overlap and g.device.type == "cuda" else None)

        def exchange1(p0):
            _land_halos([p0], (0,), g1, _send_halos([p0], (0,), g1, None),
                        None, R)

        def exchange2(p0, p1):
            _land_halos([p0, p1], (0, 1), g2,
                        _send_halos([p0, p1], (0, 1), g2, None), None, R)

        def fwd(p0, scratch):
            return fwd_fn(*fwd_tables, p0, *statics, scratch)[0]

        def tr(p1, scratch):
            return tr_fn(*tr_tables, p1, *statics, scratch)[0]

        def dot(a, b):
            return self._psum(a * b * mask)

        solution, rhs = g.data["solution"], g.data["rhs"]
        rtol_t = torch.tensor(rtol, dtype=dtype, device=dev)
        # initial residual (initialize_solver, :986-1041); the exchange
        # lands in a copy, so the grid's solution keeps its ghost rows
        p0 = solution
        if not single:
            p0 = solution.clone()
            exchange1(p0)
        Ap0 = fwd(p0, g.data["Ap0"])
        r0 = (rhs - Ap0) * mask
        dot_r0 = dot(r0, r0)
        b2 = dot(rhs, rhs)
        tiny = torch.tensor(1e-30, dtype=dtype, device=dev)
        target = torch.maximum(
            rtol_t * rtol_t * torch.maximum(torch.maximum(b2, dot_r0), tiny),
            tiny)

        s = {
            "solution": solution, "r0": r0, "r1": r0, "p0": r0,
            "p1": r0,
            "Ap0": Ap0, "dot_r": dot_r0, "residual": dot_r0,
            "it": torch.tensor(0, dtype=torch.int32, device=dev),
            "go": torch.tensor(True, device=dev),
        }
        while bool(s["go"] & (s["residual"] > target)
                   & (s["it"] < max_iterations)):
            p0, p1 = s["p0"], s["p1"]
            if overlap:
                # the sends read local rows only: they fly under both
                # matvecs, then only the refreshed rows are redone
                sent = _send_halos([p0, p1], (0, 1), g2, side)
                Ap0 = fwd(p0, s["Ap0"])
                Atp1 = tr(p1, s["r1"])
                _land_halos([p0, p1], (0, 1), g2, sent, side, R)
                Ap0 = rp_fwd[0](*rp_fwd[1], p0, *statics, Ap0)[0]
                Atp1 = rp_tr[0](*rp_tr[1], p1, *statics, Atp1)[0]
            else:
                if not single:
                    exchange2(p0, p1)
                Ap0 = fwd(p0, s["Ap0"])
                Atp1 = tr(p1, s["r1"])
            dot_p = dot(p1, Ap0)
            go = (dot_p != 0) & (s["dot_r"] != 0)
            safe_p = torch.where(dot_p == 0, 1, dot_p)
            alpha = torch.where(go, s["dot_r"] / safe_p, 0.0)
            solution = s["solution"] + alpha * p0 * mask
            r0 = s["r0"] - alpha * Ap0 * mask
            r1 = s["r1"] - alpha * Atp1 * mask
            new_dot_r = dot(r0, r1)
            safe_r = torch.where(s["dot_r"] == 0, 1, s["dot_r"])
            beta = torch.where(go, new_dot_r / safe_r, 0.0)
            p0 = (r0 + beta * p0) * mask
            p1 = (r1 + beta * p1) * mask
            s = {
                "solution": torch.where(go, solution, s["solution"]),
                "r0": torch.where(go, r0, s["r0"]),
                "r1": torch.where(go, r1, s["r1"]),
                "p0": torch.where(go, p0, s["p0"]),
                "p1": torch.where(go, p1, s["p1"]),
                "Ap0": Ap0,
                "dot_r": torch.where(go, new_dot_r, s["dot_r"]),
                "residual": torch.where(go, dot(r0, r0), s["residual"]),
                "it": s["it"] + go.to(torch.int32),
                "go": go,
            }
        return s["solution"], s["it"], s["residual"]

    def solve(self, rtol: float = 1e-5, max_iterations: int = 1000,
              cells_to_solve=None, cells_to_skip=None,
              cache_is_up_to_date: bool = False, fused: bool = True) -> dict:
        g = self.grid
        # re-prepare only when the structure epoch or the cell
        # classification changed (the reference's cache_is_up_to_date
        # flag, poisson_solve.hpp:241-245, made automatic)
        del cache_is_up_to_date
        if self._cache_key(cells_to_solve, cells_to_skip) != self._prepared_epoch:
            self.prepare(cells_to_solve, cells_to_skip)
        mask = self._solve_mask
        # the solve writes these fields by assignment, past the grid's
        # own writers: mark them for the delta checkpoints
        g._mark_ckpt_dirty(("solution", "rhs", "p0", "p1", "r0", "r1", "Ap0"))
        # with no Dirichlet classification every boundary closure —
        # periodic wrap or missing-neighbor zero flux alike — is
        # Neumann, so the operator always has the constant nullspace
        singular = cells_to_solve is None and cells_to_skip is None
        if singular:
            self._remove_mean("rhs")

        if fused:
            sol, it, residual = self._fused_solve(rtol, max_iterations)
            g.data["solution"] = sol
            if singular:
                self._remove_mean("solution")
            return {"iterations": int(it),
                    "residual": float(np.sqrt(max(float(residual), 0.0)))}

        # r0 = rhs - A·solution, with boundary cells' solution as data
        # (initialize_solver, poisson_solve.hpp:986-1041)
        g.data["p0"] = g.data["solution"]
        self._exchange_p(["p0"])
        self._apply(transpose=False)
        g.data["r0"] = (g.data["rhs"] - g.data["Ap0"]) * mask
        g.data["r1"] = g.data["r0"]
        g.data["p0"] = g.data["r0"]
        g.data["p1"] = g.data["r0"]

        # r1 == r0 here, so one reduction serves all three initial dots
        dot_r = residual = r2_0 = self._dot("r0", "r0")
        b2 = self._dot("rhs", "rhs")
        # pure-Dirichlet/Laplace problems have zero rhs on solve cells;
        # fall back to the initial residual so rtol still applies
        target = max(rtol * rtol * max(b2, r2_0, 1e-30), 1e-30)
        iterations = 0
        while residual > target and iterations < max_iterations:
            self._exchange_p(["p0", "p1"])
            self._apply(transpose=False)
            dot_p = self._dot("p1", "Ap0")
            if dot_p == 0.0 or dot_r == 0.0:
                break
            alpha = dot_r / dot_p
            g.data["solution"] = g.data["solution"] + alpha * g.data["p0"] * mask
            g.data["r0"] = g.data["r0"] - alpha * g.data["Ap0"] * mask
            # r1 -= alpha · transpose(A)·p1 (:415-470); the stencil
            # writes A^T p1 into r1's slot, so stash r1 first
            r1_old = g.data["r1"]
            self._apply(transpose=True)
            g.data["r1"] = r1_old - alpha * g.data["r1"] * mask
            new_dot_r = self._dot("r0", "r1")
            beta = new_dot_r / dot_r
            g.data["p0"] = (g.data["r0"] + beta * g.data["p0"]) * mask
            g.data["p1"] = (g.data["r1"] + beta * g.data["p1"]) * mask
            dot_r = new_dot_r
            residual = self._dot("r0", "r0")
            iterations += 1
        if singular:
            self._remove_mean("solution")
        return {"iterations": iterations, "residual": float(np.sqrt(max(residual, 0.0)))}

    def _remove_mean(self, field: str) -> None:
        total = float(self._psum(self.grid.data[field] * self._solve_mask))
        cnt = float(self._psum(self._solve_mask))
        self.grid.data[field] = (
            self.grid.data[field] - (total / max(cnt, 1.0)) * self._solve_mask
        )


class DensePoissonSolver:
    """CG on the dense path (uniform grids, big problems); ``mesh`` (a
    ``dense_mesh``) splits the grid into blocks, each matvec'd on its
    halo-padded block, the dots taken over every block."""

    def __init__(self, length, device=None, periodic=(True, True, True),
                 dtype=torch.float32, mesh=None):
        self.grid = DenseGrid(
            length,
            {"p": dtype, "Ap": dtype},
            device=device,
            periodic=periodic,
            cell_length=tuple(1.0 / l for l in length),
            mesh=mesh,
        )
        self.periodic = tuple(periodic)
        self.dtype = as_torch_dtype(dtype)
        rdx2 = rdd2_coefficients(self.grid.cell_length, self.dtype)
        grid = self.grid

        def lap_kernel(b):
            p = b["p"]
            core = tuple(slice(1, s - 1) for s in p.shape)
            nloc = tuple(s - 2 for s in p.shape)
            out = torch.zeros_like(p[core])
            for d in range(3):
                lo = tuple(
                    slice(0 if dd == d else 1, (s - 2 if dd == d else s - 1))
                    for dd, s in enumerate(p.shape)
                )
                hi = tuple(
                    slice(2 if dd == d else 1, (s if dd == d else s - 1))
                    for dd, s in enumerate(p.shape)
                )
                t_lo = p[lo] - p[core]
                t_hi = p[hi] - p[core]
                if not grid.periodic[d]:
                    # homogeneous Neumann: drop missing-neighbor terms,
                    # matching PoissonSolver's masked stencil, at the
                    # cell's global index
                    shape = [1, 1, 1]
                    shape[d] = nloc[d]
                    g = (grid.axis_index(AXES[d]) * nloc[d]
                         + torch.arange(nloc[d], device=p.device).reshape(shape))
                    t_lo = torch.where(g > 0, t_lo, 0.0)
                    t_hi = torch.where(g < grid.length[d] - 1, t_hi, 0.0)
                out = out + rdx2[d] * (t_lo + t_hi)
            return {"Ap": out}

        self._matvec = self.grid.make_step(lap_kernel, ("p",), ("Ap",), halo=1)

    def matvec(self, p):
        """``A p`` of a ``[nx, ny, nz]`` tensor through the dense step."""
        return self._matvec({"p": p, "Ap": p})["Ap"]

    def solve(self, rhs, rtol=1e-5, max_iterations=1000):
        return cg_solve(self.matvec, rhs, singular=all(self.periodic),
                        dtype=self.dtype, rtol=rtol,
                        max_iterations=max_iterations, device=self.grid.device)


def cg_solve(matvec, rhs, singular, dtype, rtol=1e-5, max_iterations=1000,
             device=None):
    """Plain conjugate gradients over an SPD ``matvec`` callable on
    tensors — shared by DensePoissonSolver (plain PyTorch dense step)
    and CudaPoissonSolver (kernel C). ``singular`` removes the constant
    null space (all-periodic Laplacian): the RHS and the solution are
    projected to zero mean. ``rhs`` (array or tensor) is moved to
    ``device`` when given. Per iteration the host reads ``p·Ap`` and
    ``r·r``, as the reference does."""
    rhs = torch.as_tensor(rhs, dtype=as_torch_dtype(dtype),
                          device=None if device is None else resolve_device(device))
    if singular:
        rhs = rhs - torch.mean(rhs)
    x = torch.zeros_like(rhs)
    r = rhs
    p = r
    rs = float(torch.sum(r * r))
    target = max(rtol * rtol * float(torch.sum(rhs * rhs)), 1e-30)
    it = 0
    while rs > target and it < max_iterations:
        Ap = matvec(p)
        pAp = float(torch.sum(p * Ap))
        if pAp == 0.0:
            break
        alpha = rs / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = float(torch.sum(r * r))
        p = r + (rs_new / rs) * p
        rs = rs_new
        it += 1
    if singular:
        x = x - torch.mean(x)
    return x, {"iterations": it, "residual": float(np.sqrt(max(rs, 0.0)))}
