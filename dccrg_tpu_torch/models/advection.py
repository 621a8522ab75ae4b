"""Finite-volume upwind advection — the north-star workload, on PyTorch.

Port of ``dccrg_tpu/models/advection.py``: the reference advection
test's math (tests/advection/solve.hpp:44-333, initialize.hpp:36-80):
solid-body rotation velocity field (vx = 0.5 - y, vy = x - 0.5, vz = 0;
solve.hpp:339-346), cosine-hump initial density (radius 0.15 at
(0.25, 0.5), initialize.hpp:54-66), first-order upwind fluxes with
face-interpolated velocities, CFL-limited global step.

Three routes reach the card: ``GridAdvection`` runs through the general
``Grid`` step loop (kernel A, csrc/bulk_pass.cu, on an eligible grid),
``CudaRotationAdvection`` is the single-kernel fast path (kernel B,
csrc/rotation_step.cu), and ``AdvectionSolver`` is the dense path on
``DenseGrid`` in plain PyTorch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import comm
from ..dense import AXES, BLOCKS, WHOLE, DenseGrid
from ..grid import Grid, Grouped, SlotwiseKernel, resolve_device
from ..ops.advection_kernel import make_rotation_step

HUMP_X0, HUMP_Y0, HUMP_RADIUS = 0.25, 0.5, 0.15


def hump_density(x, y):
    """Cosine hump (initialize.hpp:54-66) on tensors."""
    r = torch.clamp(torch.sqrt((x - HUMP_X0) ** 2 + (y - HUMP_Y0) ** 2),
                    max=HUMP_RADIUS) / HUMP_RADIUS
    return 0.25 * (1.0 + torch.cos(math.pi * r))


def analytic_density(x, y, t):
    """Exact solution: the hump rotated by angle t about (0.5, 0.5).
    ``t`` becomes a tensor of ``x``'s dtype, so the rotation is taken in
    the coordinates' precision."""
    t = torch.as_tensor(t, dtype=x.dtype)
    xc, yc = x - 0.5, y - 0.5
    c, s = torch.cos(-t), torch.sin(-t)
    x0, y0 = xc * c - yc * s + 0.5, xc * s + yc * c + 0.5
    return hump_density(x0, y0)


class CudaRotationAdvection:
    """Single-GPU fast path on the benchmark's separable rotation field:
    the CUDA rotation kernel (ops/advection_kernel.py, kernel B) with
    temporal blocking. Replaces ``PallasRotationAdvection``
    (dccrg_tpu/models/advection.py:50), whose Pallas kernel was
    ``make_rotation_step`` (dccrg_tpu/ops/advection_kernel.py:40).
    Runs on the card unless ``device`` says otherwise."""

    def __init__(self, n=512, nz=None, dtype=torch.float32, cfl=0.5,
                 steps_per_pass=7, tile=None, device=None):
        self.device = resolve_device(device)
        nz = nz if nz is not None else n
        self.n, self.nz, self.cfl = n, nz, cfl
        self.steps_per_pass = steps_per_pass
        dx = 1.0 / n
        self.dx = dx
        x = (np.arange(n) + 0.5) * dx
        xt = torch.as_tensor(x)
        plane = hump_density(xt[:, None], xt[None, :]).to(self.device, dtype)
        self.rho = plane[:, :, None].expand(n, n, nz).contiguous()
        self.vx_face = torch.as_tensor(
            (0.5 - x).astype(np.float32)[None, :], device=self.device)
        vy = (x - 0.5).astype(np.float32)
        # 8-row wrap margin on each side (make_rotation_step docstring)
        self.vy_face = torch.as_tensor(
            np.concatenate([vy[-8:], vy, vy[:8]])[:, None], device=self.device)
        self._vmax = float(max(np.abs(0.5 - x).max(), np.abs(vy).max()))
        self._step = make_rotation_step(
            (n, n, nz), dtype=dtype, tile=tile, steps_per_pass=steps_per_pass,
            cell_length=(dx, dx, 1.0 / nz),
        )
        self.time = 0.0

    def max_time_step(self) -> float:
        return self.dx / self._vmax

    def step(self, dt: float | None = None) -> float:
        """One kernel pass = ``steps_per_pass`` time steps."""
        if dt is None:
            dt = self.cfl * self.max_time_step()
        self.rho = self._step(self.rho, self.vx_face, self.vy_face,
                              np.float32(dt))
        self.time += float(dt) * self.steps_per_pass
        return float(dt)


def make_uniform_flux_kernel(cell_length):
    """Upwind flux kernel for the general-Grid step loop on a uniform
    (max_refinement_level=0) grid with in-plane velocities, over face
    neighbors (offsets in index units, cell size 1). Arithmetic is
    always float32: narrow-storage fields are widened on read and the
    step loop narrows the result. The kernel names its CUDA twin,
    device flux ``"upwind_xy"`` of csrc/bulk_pass.cu, which computes
    the same function in the same order."""
    inv = [1.0 / float(cell_length[d]) for d in range(3)]
    f32 = torch.float32

    def init(cell, dt):
        return torch.zeros(cell["density"].shape, dtype=f32,
                           device=cell["density"].device)

    def slot(acc, cell, nbr, offs, mask, dt):
        # one stencil leg: nbr[name] is [L], offs [3] or [L, 3] (raw,
        # gated by mask), mask [L]
        rho_c = cell["density"].to(f32)
        rho_n = nbr["density"].to(f32)
        for d, vname in ((0, "vx"), (1, "vy")):
            v = 0.5 * (cell[vname].to(f32) + nbr[vname].to(f32))
            up_pos = torch.where(v >= 0, rho_c, rho_n)
            up_neg = torch.where(v >= 0, rho_n, rho_c)
            face_pos = mask & (offs[..., d] == 1)
            face_neg = mask & (offs[..., d] == -1)
            m = v * (dt * inv[d])
            acc = acc - torch.where(face_pos, up_pos * m, 0.0)
            acc = acc + torch.where(face_neg, up_neg * m, 0.0)
        return acc

    def finish(acc, cell, dt):
        return {"density": cell["density"].to(f32) + acc}

    return SlotwiseKernel(init, slot, finish, device_flux="upwind_xy",
                          device_params={"inv": tuple(inv)})


class GridAdvection:
    """The north-star benchmark on the general ``Grid`` runtime: the
    solid-body-rotation advection through the closed-form plan and the
    ``Grid.run_steps`` loop, face-neighbor neighborhood
    (set_neighborhood_length(0), dccrg.hpp:8015-8076). Periodic in x
    and y as the reference configuration (2d.cpp:237); ``periodic``
    overrides that. Runs on the card unless ``device`` says otherwise;
    a list of devices runs it on that many partitions, taking the
    ``block`` partition as the reference does (contiguous slabs keep the
    closed-form plan and talk to one or two peers)."""

    def __init__(self, n=256, nz=None, device=None, cfl=0.5,
                 dtype=torch.float32, periodic=(True, True, False)):
        nz = nz if nz is not None else n
        self.n, self.nz, self.cfl = n, nz, cfl
        self.dtype = dtype
        dx = 1.0 / n
        self.dx = dx
        self.grid = (
            # grid-wide storage dtype: bfloat16 halves the state's
            # device residency; the flux computes in float32 either way
            Grid(cell_data={"density": torch.float32, "vx": torch.float32,
                            "vy": torch.float32}, dtype=dtype)
            .set_initial_length((n, n, nz))
            .set_periodic(*periodic)
            .set_maximum_refinement_level(0)
            .set_neighborhood_length(0)
            .set_geometry("cartesian", start=(0.0, 0.0, 0.0),
                          level_0_cell_length=(dx, dx, 1.0 / nz))
            .initialize(device, partition="block")
        )
        # init on the device: the cell center is affine in the row id on
        # this uniform grid, so no host center arrays are made (ghost
        # rows take their cells' values, pad rows zero)
        # (on a grid whose partitions span devices the row ids are a
        # Grouped array, and each group computes its own rows)
        ridx = self.grid.device_row_ids()
        valid = ridx >= 0
        r = torch.where(valid, ridx, 0)
        x = ((r % n).to(torch.float32) + 0.5) * np.float32(dx)
        y = (((r // n) % n).to(torch.float32) + 0.5) * np.float32(dx)
        self.grid.data["density"] = torch.where(
            valid, x.map(hump_density, y) if isinstance(x, Grouped)
            else hump_density(x, y), 0.0).to(dtype)
        self.grid.data["vx"] = torch.where(valid, 0.5 - y, 0.0).to(dtype)
        self.grid.data["vy"] = torch.where(valid, x - 0.5, 0.0).to(dtype)
        self._kernel = make_uniform_flux_kernel((dx, dx, 1.0 / nz))
        self.time = 0.0

    def max_time_step(self) -> float:
        # centers span [dx/2, 1-dx/2], so max |v| over cell centers is
        # 0.5 - dx/2 exactly
        return self.dx / (0.5 - 0.5 * self.dx)

    def run(self, n_steps: int, dt: float | None = None, bulk=True) -> float:
        """``n_steps`` steps through ``Grid.run_steps``; ``bulk=False``
        forces the plain roll path (the in-port baseline)."""
        if dt is None:
            dt = self.cfl * self.max_time_step()
        self.grid.run_steps(
            self._kernel, ["density", "vx", "vy"], ["density"], n_steps,
            extra_args=(torch.tensor(dt, dtype=torch.float32),), bulk=bulk,
        )
        self.time += n_steps * dt
        return dt

    def density(self) -> np.ndarray:
        return self.grid.get("density", self.grid.plan.cells)

    def _sum(self, x) -> float:
        """``x`` summed over the held rows, then over the ranks a grid
        whose partitions span ranks is placed on. On several partitions
        each partition's rows are summed, then the partitions in
        partition order (``comm.partition_sums``, ``comm.grid_total``),
        so a grid whose partitions span devices reads the one-device
        grid's bits."""
        if self.grid.n_dev == 1:
            return float(torch.sum(x))
        return float(comm.grid_total(self.grid, comm.partition_sums(x)))

    def checksum(self) -> float:
        """Sum of the density over local rows (pad rows masked out): the
        total density, a mass probe at unit cell volume. Reading the
        scalar waits for the device."""
        return self._sum(self.grid.data["density"]
                         * self.grid.local_row_mask())

    def l2_error(self) -> float:
        """L2 error vs the rotated analytic hump, computed on the device
        over local rows in float32."""
        g = self.grid
        ridx = g.device_row_ids()
        valid = ridx >= 0
        r = torch.where(valid, ridx, 0)
        dx = np.float32(self.dx)
        x = ((r % self.n).to(torch.float32) + 0.5) * dx
        y = (((r // self.n) % self.n).to(torch.float32) + 0.5) * dx
        exact = (x.map(analytic_density, y, np.float32(self.time))
                 if isinstance(x, Grouped)
                 else analytic_density(x, y, np.float32(self.time)))
        sq = self._sum((g.data["density"] - exact) ** 2 * g.local_row_mask())
        vol = self.dx * self.dx * (1.0 / self.nz)
        return float(np.sqrt(sq * vol))


class AdvectionSolver:
    """Dense-path advection on [0,1]^3.

    Port of the reference's ``AdvectionSolver``
    (dccrg_tpu/models/advection.py:257): tests/advection/2d.cpp's
    configuration for normal dimension z, grid (n, n, nz), periodic in
    x and y (2d.cpp:237), velocities in the x-y plane; ``nz > 1``
    replicates the 2-D problem along z (the 512^3 configuration of
    BASELINE.json). Plain PyTorch on ``DenseGrid``: the reference
    computes this step in XLA, outside any Pallas kernel. Runs on the
    card unless ``device`` says otherwise; ``mesh`` (a ``dense_mesh``)
    splits the grid into blocks, each stepped on its halo-padded block
    (on a mesh placed on ranks, each rank its own blocks; the CFL step,
    the mass and the L2 error cover every rank).
    """

    def __init__(self, n=64, nz=None, mesh=None, dtype=torch.float32, cfl=0.5,
                 device=None):
        nz = nz if nz is not None else 1
        self.n, self.nz, self.cfl = n, nz, cfl
        self.grid = DenseGrid(
            (n, n, nz),
            {"rho": dtype, "vx": dtype, "vy": dtype, "vz": dtype},
            device=device,
            periodic=(True, True, False),
            start=(0.0, 0.0, 0.0),
            cell_length=(1.0 / n, 1.0 / n, 1.0 / nz),
            mesh=mesh,
        )
        self.grid.init_fields(lambda x, y, z: {
            "rho": hump_density(x, y),
            "vx": 0.5 - y,
            "vy": x - 0.5,
            "vz": torch.zeros_like(z),
        })
        # velocities are constant in time: halo-pad them once, block by
        # block (the padded blocks laid side by side, as the reference's
        # shard_map pad returns them), and pass the padded blocks into
        # every step, so each step exchanges only rho
        self._vel_padded = tuple(self.grid.pad_with_halo(self.grid.arrays[f], 1)
                                 for f in ("vx", "vy", "vz"))
        self._step = self.grid.make_step(
            self._kernel, ("rho",), ("rho",), halo=1,
            extra_specs=(BLOCKS, BLOCKS, BLOCKS, WHOLE))
        self.time = 0.0

    # -- CFL (solve.hpp:289-333) --------------------------------------

    def max_time_step(self) -> float:
        """Largest stable dt: min over cells of length/|v| per dim (over
        every block, and every rank of a mesh placed on ranks)."""
        steps = []
        for d, name in enumerate(("vx", "vy", "vz")):
            v = self.grid.arrays[name].abs()
            dlen = float(self.grid.cell_length[d])
            steps.append(float(self.grid.minimum(
                torch.where(v > 0, dlen / v, math.inf))))
        return min(steps)

    # -- the fused step (solve.hpp:44-279) ----------------------------

    def _kernel(self, b, vxp, vyp, vzp, dt):
        rho = b["rho"]
        vel = (vxp, vyp, vzp)
        nloc = tuple(s - 2 for s in rho.shape)  # interior block extent

        def interior_shift(a, d, off):
            return a[tuple(slice(1 + (off if dd == d else 0),
                                 a.shape[dd] - 1 + (off if dd == d else 0))
                           for dd in range(3))]

        rho_c = interior_shift(rho, 0, 0)
        out = rho_c
        for d in range(3):
            v = vel[d]
            v_c = interior_shift(v, d, 0)
            v_p = interior_shift(v, d, +1)
            v_m = interior_shift(v, d, -1)
            rho_p = interior_shift(rho, d, +1)
            rho_m = interior_shift(rho, d, -1)
            # velocity interpolated to the shared face (equal-size cells
            # reduce solve.hpp:169-176 to the average)
            vface_hi = 0.5 * (v_c + v_p)
            vface_lo = 0.5 * (v_m + v_c)
            # upwind donor density (solve.hpp:178-226)
            flux_hi = vface_hi * torch.where(vface_hi >= 0, rho_c, rho_p)
            flux_lo = vface_lo * torch.where(vface_lo >= 0, rho_m, rho_c)
            if not self.grid.periodic[d]:
                # missing neighbor => no flux through that face, at the
                # cell's GLOBAL index: mesh position x block extent +
                # local index
                shape = [1, 1, 1]
                shape[d] = nloc[d]
                glob = (self.grid.axis_index(AXES[d]) * nloc[d]
                        + torch.arange(nloc[d], device=rho.device).view(shape))
                flux_hi = torch.where(glob < self.grid.length[d] - 1, flux_hi, 0.0)
                flux_lo = torch.where(glob > 0, flux_lo, 0.0)
            out = out + (flux_lo - flux_hi) * (dt / float(self.grid.cell_length[d]))
        return {"rho": out}

    def step(self, dt: float | None = None) -> float:
        """One upwind step of ``dt`` (the CFL step times ``cfl`` when
        None); ``dt`` enters the arithmetic as float32."""
        if dt is None:
            dt = self.cfl * self.max_time_step()
        self.grid.arrays = self._step(self.grid.arrays, *self._vel_padded,
                                      torch.tensor(dt, dtype=torch.float32))
        self.time += float(dt)
        return float(dt)

    # -- diagnostics ---------------------------------------------------

    def total_mass(self) -> float:
        """Total mass: the density summed in float64 over every block
        (``DenseGrid.total``, the same bits on any mesh or split over
        ranks), times the cell volume."""
        vol = float(np.prod(self.grid.cell_length))
        return self.grid.total(self.grid.arrays["rho"]) * vol

    def l2_error(self) -> float:
        """L2 error against the rotated analytic hump (the parity
        metric of BASELINE.json), in float64: the exact field of the
        whole grid's x-y plane, each held block against its part,
        summed by ``DenseGrid.total``."""
        g = self.grid
        x = g.cell_centers(0)[:, None, None]
        y = g.cell_centers(1)[None, :, None]
        exact = g.hold(analytic_density(x, y, self.time).expand(g.length))
        diff = g.arrays["rho"].to(torch.float64) - exact
        vol = float(np.prod(g.cell_length))
        return float(np.sqrt(g.total(diff * diff) * vol))
