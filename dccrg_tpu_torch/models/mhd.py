"""Finite-volume ideal-MHD-style solver: the model zoo's multi-field
workload, on PyTorch.

Port of ``dccrg_tpu/models/mhd.py``. Eight coupled per-cell fields
(density, momentum x3, total energy, magnetic field x3) advanced by two
operator-split passes with different ghost dependencies:

- the hydro flux pass (first-order Rusanov fluxes of the Euler
  subsystem over face neighbours) reads only the hydro fields' ghosts;
- the B cleaning pass (a conservative resistive smoothing of B over
  face neighbours) reads only the B fields' ghosts.

Each pass declares ``ghost_deps``, so the overlapped step's ghost split
(``DCCRG_GHOST_SPLIT``) recomputes only its own subsystem's outer rows,
and a step gathers only the neighbour fields its pass reads.

Face fluxes are written so the two sides of a face compute the same
bits (commutative flux average, shared ``U_right - U_left`` term,
symmetric ``max`` wave speed): mass, momentum, energy and B are
conserved up to the rounding of the sums, inside
``integrity.sum_tolerance``. Pressure and density are floored inside the
flux evaluation only.

Kernels broadcast over a leading batch dimension (``[B, L]`` cells,
``[B, L, S]`` neighbours, ``[B, 1]`` parameters in a fleet bucket) and
sum the neighbour slots one by one in slot order, so a fleet slot's
bytes equal its solo run's. The reference's ``jnp.sum`` adds the slots
in an order of XLA's choosing: the two agree to float32 re-association.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import comm
from ..grid import Grid, groups_of, slot_sum

GAMMA = 5.0 / 3.0
ETA = 0.08          # B cleaning diffusivity (stability: lam*ETA*6 < 1)
P_FLOOR = 1.0e-6
RHO_FLOOR = 1.0e-3

MHD_HYDRO = ("rho", "mx", "my", "mz", "en")
MHD_BFIELD = ("bx", "by", "bz")
MHD_ALL = MHD_HYDRO + MHD_BFIELD

_F32 = torch.float32


def mhd_cell_data(dtype=torch.float32) -> dict:
    """The 8-field MHD schema (every field a scalar per cell)."""
    return {n: dtype for n in MHD_ALL}


def _widen(fields, names):
    return {n: fields[n].to(_F32) for n in names}


def _euler_flux(U, d):
    """Euler flux along axis ``d`` plus the local max wave speed
    ``|v_d| + c``, elementwise over any shape."""
    rho = torch.clamp_min(U["rho"], RHO_FLOOR)
    inv = 1.0 / rho
    vx, vy, vz = U["mx"] * inv, U["my"] * inv, U["mz"] * inv
    ke = 0.5 * (U["mx"] * vx + U["my"] * vy + U["mz"] * vz)
    p = torch.clamp_min((GAMMA - 1.0) * (U["en"] - ke), P_FLOOR)
    vd = (vx, vy, vz)[d]
    md = ("mx", "my", "mz")[d]
    F = {
        "rho": U[md],
        "mx": vd * U["mx"],
        "my": vd * U["my"],
        "mz": vd * U["mz"],
        "en": vd * (U["en"] + p),
    }
    F[md] = F[md] + p
    speed = torch.abs(vd) + torch.sqrt(GAMMA * p * inv)
    return F, speed


def _face(offs, mask):
    """Face-neighbour slots: unit offsets among the valid ones."""
    return mask & (offs.abs().sum(dim=-1) == 1)


def _hydro_update(cell, nbr, offs, mask, lam):
    """One Rusanov step of the hydro subsystem: ``U += lam * sum of face
    fluxes`` with ``lam = dt/dx``. Reads hydro neighbour values only."""
    U_c = _widen(cell, MHD_HYDRO)
    U_n = _widen(nbr, MHD_HYDRO)
    face = _face(offs, mask)
    zero = torch.zeros((), dtype=_F32, device=mask.device)
    acc = {n: torch.zeros_like(U_c[n]) for n in MHD_HYDRO}
    for d in range(3):
        Fc, sc = _euler_flux(U_c, d)
        Fn, sn = _euler_flux(U_n, d)
        pos = face & (offs[..., d] == 1)
        neg = face & (offs[..., d] == -1)
        sc1 = sc[..., None]
        # the two sides of a face compute the same bits: the average is
        # x + y either way, the dissipation term is always
        # (U_right - U_left), and max(a, b) == max(b, a)
        for n in MHD_HYDRO:
            cc = U_c[n][..., None]
            fc = Fc[n][..., None]
            f_hi = (0.5 * (fc + Fn[n])
                    - 0.5 * torch.maximum(sc1, sn) * (U_n[n] - cc))
            f_lo = (0.5 * (Fn[n] + fc)
                    - 0.5 * torch.maximum(sn, sc1) * (cc - U_n[n]))
            acc[n] = acc[n] + (slot_sum(torch.where(neg, f_lo, zero))
                               - slot_sum(torch.where(pos, f_hi, zero)))
    return {n: U_c[n] + lam * acc[n] for n in MHD_HYDRO}


def _b_update(cell, nbr, offs, mask, lam):
    """One cleaning step of the B subsystem: conservative face smoothing
    ``B += lam * ETA * sum_faces (B_nbr - B)``. Reads B neighbour values
    only."""
    face = _face(offs, mask)
    zero = torch.zeros((), dtype=_F32, device=mask.device)
    out = {}
    for n in MHD_BFIELD:
        b_c = cell[n].to(_F32)
        b_n = nbr[n].to(_F32)
        s = slot_sum(torch.where(face, b_n - b_c[..., None], zero))
        out[n] = b_c + lam * ETA * s
    return out


def make_mhd_kernel():
    """The fused fleet kernel (registry name ``"mhd"``): hydro flux and
    B cleaning every step, one parameter ``lam = dt/dx``. Declares the
    per-field ghost split: hydro outputs read hydro ghosts, B outputs B
    ghosts."""

    def kernel(cell, nbr, offs, mask, lam):
        out = _hydro_update(cell, nbr, offs, mask, lam)
        out.update(_b_update(cell, nbr, offs, mask, lam))
        return out

    kernel.ghost_deps = {**{n: MHD_HYDRO for n in MHD_HYDRO},
                         **{n: MHD_BFIELD for n in MHD_BFIELD}}
    return kernel


def make_mhd_pass_kernels():
    """The operator-split pair ``(hydro_pass, b_pass)`` driving
    :class:`GridMHD`: each pass updates its subsystem and passes the
    other through unchanged, so a ``run_steps`` call exchanges only the
    subsystem that changes."""

    def hydro_pass(cell, nbr, offs, mask, lam):
        out = _hydro_update(cell, nbr, offs, mask, lam)
        out.update({n: cell[n] for n in MHD_BFIELD})
        return out

    hydro_pass.ghost_deps = {**{n: MHD_HYDRO for n in MHD_HYDRO},
                             **{n: () for n in MHD_BFIELD}}

    def b_pass(cell, nbr, offs, mask, lam):
        out = {n: cell[n] for n in MHD_HYDRO}
        out.update(_b_update(cell, nbr, offs, mask, lam))
        return out

    b_pass.ghost_deps = {**{n: () for n in MHD_HYDRO},
                         **{n: MHD_BFIELD for n in MHD_BFIELD}}
    return hydro_pass, b_pass


def mhd_default_init(grid, seed: int) -> None:
    """The fleet's seeded default init for ``"mhd"`` jobs: a smooth
    random state with positive density and pressure, the reference's
    bytes (numpy draws in the same order)."""
    rng = np.random.default_rng(seed)
    cells = grid.plan.cells
    nc = len(cells)
    rho = (1.0 + 0.5 * rng.random(nc)).astype(np.float32)
    mom = {n: (0.2 * (rng.random(nc) - 0.5)).astype(np.float32)
           for n in ("mx", "my", "mz")}
    p = (0.5 + 0.5 * rng.random(nc)).astype(np.float32)
    ke = 0.5 * (mom["mx"] ** 2 + mom["my"] ** 2 + mom["mz"] ** 2) / rho
    en = (p / np.float32(GAMMA - 1.0) + ke).astype(np.float32)
    vals = {"rho": rho, **mom, "en": en}
    for n in MHD_BFIELD:
        vals[n] = (0.3 * (rng.random(nc) - 0.5)).astype(np.float32)
    grid.set_many(cells, vals)


def _local_rows(g, name) -> list:
    """Per storage group, the owned rows of its held partitions of
    ``g``'s field, flattened on the group's device (one tensor on a grid
    of one device)."""
    nl = np.asarray(g.plan.n_local)
    return [torch.cat([t[i, :int(nl[g._held[s]])]
                       for i, s in enumerate(grp.slots)])
            for t, grp in zip(groups_of(g.data[name]), g._groups)]


class GridMHD:
    """The MHD model on the general ``Grid`` runtime: a blast-wave setup
    advanced by the two-pass operator splitting (hydro^n then
    cleaning^n per :meth:`run` call) through ``Grid.run_steps``, each
    pass exchanging only its own subsystem's ghosts. On the card unless
    ``device`` says otherwise; a list of devices runs it on that many
    partitions (distinct devices each holding their own), a placement of
    ``(rank, device)`` entries on the ranks of a process group (each
    rank steps its own partitions, both exchanges cross the ranks, and
    the CFL step and the sums cover every rank and device)."""

    def __init__(self, n=16, nz=None, device=None, dtype=torch.float32,
                 partition="block", profile="blast", seed=0):
        nz = nz if nz is not None else n
        self.n, self.nz = n, nz
        dx = 1.0 / n
        self.dx = dx
        self.grid = (
            Grid(cell_data=mhd_cell_data(torch.float32), dtype=dtype)
            .set_initial_length((n, n, nz))
            .set_periodic(True, True, True)
            .set_maximum_refinement_level(0)
            .set_neighborhood_length(0)
            .set_geometry("cartesian", start=(0.0, 0.0, 0.0),
                          level_0_cell_length=(dx, dx, 1.0 / nz))
            .initialize(device, partition=partition)
        )
        if profile == "blast":
            self._init_blast(self.grid.plan.cells)
        else:
            mhd_default_init(self.grid, seed)
        self.grid.update_copies_of_remote_neighbors()
        self._hydro, self._bpass = make_mhd_pass_kernels()
        self.time = 0.0

    def _init_blast(self, cells):
        """Sedov-style pressure blast in a uniform magnetized medium."""
        g = self.grid
        idx = g.mapping.get_indices(np.asarray(cells, np.uint64))
        x = (idx[:, 0].astype(np.float64) + 0.5) * self.dx
        y = (idx[:, 1].astype(np.float64) + 0.5) * self.dx
        z = (idx[:, 2].astype(np.float64) + 0.5) / self.nz
        r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2
        del idx, x, y, z
        p = np.where(r2 < 0.1 ** 2, 10.0, 0.1).astype(np.float32)
        nc = len(cells)
        zeros = np.zeros(nc, np.float32)
        g.set_many(cells, {
            "rho": np.ones(nc, np.float32),
            "mx": zeros, "my": zeros, "mz": zeros,
            "en": p / np.float32(GAMMA - 1.0),
            "bx": np.full(nc, 0.2, np.float32),
            "by": zeros, "bz": zeros,
        })

    def max_time_step(self) -> float:
        """CFL bound from the current state: the reference's float64
        reduction (the same elementwise operations, each correctly
        rounded, and exact maxima), run where the grid lies: the maxima
        of each storage group's held rows on its device, then over the
        groups and the ranks of a placement."""
        g = self.grid
        f64 = torch.float64
        fold = comm.grid_fold_device(g)
        peaks = []
        for grp in zip(*(_local_rows(g, n) for n in ("rho", "mx", "my", "mz",
                                                    "en"))):
            rho = torch.clamp_min(grp[0].to(f64), RHO_FLOOR)
            vmax = []
            ke = torch.zeros_like(rho)
            for m in grp[1:4]:
                m = m.to(f64)
                vmax.append((m / rho).abs().max())
                ke += 0.5 * m * m / rho
            p = torch.clamp_min((GAMMA - 1.0) * (grp[4].to(f64) - ke),
                                P_FLOOR)
            c = torch.sqrt(GAMMA * p / rho).max()
            peaks.append(torch.stack([torch.stack(vmax).max(), c]).to(fold))
        peaks = comm.all_reduce(torch.stack(peaks).amax(dim=0)[None],
                                "max", g._rank_held)[0].cpu().tolist()
        return self.dx / max(peaks[0] + peaks[1], ETA * 6.0, 1e-12)

    def run(self, n_steps: int, dt: float | None = None,
            cfl: float = 0.4) -> float:
        """``n_steps`` hydro steps then ``n_steps`` cleaning steps, each
        pass one ``run_steps`` call exchanging only its own subsystem."""
        if dt is None:
            dt = cfl * self.max_time_step()
        lam = torch.tensor(dt / self.dx, dtype=_F32,
                           device=comm.grid_fold_device(self.grid))
        self.grid.run_steps(self._hydro, MHD_ALL, MHD_ALL, n_steps,
                            exchange_fields=MHD_HYDRO, extra_args=(lam,))
        self.grid.run_steps(self._bpass, MHD_ALL, MHD_ALL, n_steps,
                            exchange_fields=MHD_BFIELD, extra_args=(lam,))
        self.time += n_steps * dt
        return dt

    def conserved_sums(self) -> dict:
        """Float64 global sums of every conserved field
        (``comm.grid_field_totals``: the same value on every rank)."""
        return comm.grid_field_totals(self.grid, MHD_ALL)


def register() -> None:
    """Register the zoo entries: the ``"mhd"`` fleet kernel with its
    schema defaults and seeded init, and the conservation invariants
    the integrity layer checks. Idempotent."""
    from .. import fleet, integrity

    fleet.register_kernel("mhd", make_mhd_kernel())
    fleet.register_kernel_spec(
        "mhd", cell_data=mhd_cell_data(torch.float32),
        fields_in=MHD_ALL, fields_out=MHD_ALL, params=(0.05,),
        init=mhd_default_init)
    integrity.register_conserved("mhd", MHD_ALL, periodic_axes=(0, 1, 2))


ZOO_INFO = {
    "kernel": "mhd",
    "fields": MHD_ALL,
    "ghost_deps": {**{n: MHD_HYDRO for n in MHD_HYDRO},
                   **{n: MHD_BFIELD for n in MHD_BFIELD}},
    "conserved": MHD_ALL,
    "model": "GridMHD",
    "description": ("finite-volume ideal-MHD-style: Rusanov hydro "
                    "fluxes (hydro ghosts) + conservative B cleaning "
                    "(B ghosts)"),
}
