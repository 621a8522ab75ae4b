"""Adaptive advection on PyTorch: the reference advection test's full
loop on the AMR grid, on one partition or n partitions of a device, or
on partitions placed on the ranks of a process group.

Port of ``dccrg_tpu/models/advection_amr.py`` (tests/advection/2d.cpp:
321-442, solve.hpp:44-333, adapter.hpp:47-311): upwind finite-volume
fluxes over AMR face neighbors, the relative-density-difference
adaptation criterion and the adapt / balance epochs.

The reference's per-cell scatter loop (visit each face once, update
both sides, solve.hpp:166-234) is a *gather* kernel here: every cell
accumulates its own flux from all of its face neighbors, so each face
is evaluated twice (once per side) with the same face velocity, area
and upwind density, which keeps the scheme conservative. Face
detection is the reference's offset arithmetic (solve.hpp:76-120,
``neighbors.face_masks``). On a refined grid the stencils run through
the grid's table path: the dense far/easy tables, then the hard rows
near refinement.

Static per-cell quantities (edge lengths, velocities at the center,
index length) are fields refreshed once per structure epoch and
exchanged once, so the per-step exchange moves only the density (the
reference's transfer-count trick, tests/advection/cell.hpp:31-55). The
CFL limit and the total mass are per-partition reductions combined
over the partitions (``comm.all_reduce``, ``comm.grid_total``).

On a grid whose partitions span the ranks of a process group (``device``
a placement of ``(rank, device)`` entries, ``coord.rank_devices``) each
rank steps its own partitions, the reductions cover every rank (each
rank reads the one process's CFL step and mass), an adapt commits
through the distributed AMR protocol (``Grid.enable_distributed_amr``,
each rank requesting its own cells) and a balance moves rows between
the ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import comm
from ..grid import Grid, group_map, slot_sum
from ..neighbors import face_masks

STATIC_FIELDS = ("vx", "vy", "vz", "lx", "ly", "lz", "ilen")
FLUX_INPUTS = ("density",) + STATIC_FIELDS

# adaptation codes of _flagged_cells
REFINE, KEEP, UNREFINE = 1, 2, 3


def velocity(centers: np.ndarray) -> np.ndarray:
    """Solid-body rotation about (0.5, 0.5) (solve.hpp:339-346)."""
    v = np.zeros_like(centers)
    v[:, 0] = 0.5 - centers[:, 1]
    v[:, 1] = centers[:, 0] - 0.5
    return v


def hump(centers: np.ndarray, x0=0.25, y0=0.5, radius=0.15) -> np.ndarray:
    """Cosine hump initial density (tests/advection/initialize.hpp:54-66)."""
    r = np.minimum(
        np.sqrt((centers[:, 0] - x0) ** 2 + (centers[:, 1] - y0) ** 2), radius
    ) / radius
    return (1.0 + np.cos(np.pi * r)) / 4


def make_flux_kernel():
    """The upwind flux gather kernel (solve.hpp:44-266)."""

    def kernel(cell, nbr, offs, mask, dt):
        rho_c = cell["density"][:, None]
        rho_n = nbr["density"]
        ilen_c = cell["ilen"]
        ilen_n = nbr["ilen"]
        lens_c = [cell["lx"][:, None], cell["ly"][:, None], cell["lz"][:, None]]
        lens_n = [nbr["lx"], nbr["ly"], nbr["lz"]]
        vels_c = [cell["vx"][:, None], cell["vy"][:, None], cell["vz"][:, None]]
        vels_n = [nbr["vx"], nbr["vy"], nbr["vz"]]
        vol_c = (cell["lx"] * cell["ly"] * cell["lz"])[:, None]

        faces = face_masks(ilen_c[:, None], ilen_n, offs, mask)
        flux = torch.zeros_like(rho_n)
        for d, (face_pos, face_neg) in enumerate(faces):
            # velocity interpolated to the shared face (solve.hpp:168-175)
            v = (lens_c[d] * vels_n[d] + lens_n[d] * vels_c[d]) / (
                lens_c[d] + lens_n[d] + 1e-30
            )
            o1, o2 = [e for e in range(3) if e != d]
            area = torch.minimum(lens_c[o1] * lens_c[o2], lens_n[o1] * lens_n[o2])
            # +d face: positive v carries cell density out (solve.hpp:180-234)
            up_pos = torch.where(v >= 0, rho_c, rho_n)
            up_neg = torch.where(v >= 0, rho_n, rho_c)
            m = dt * v * area / vol_c
            flux = flux - torch.where(face_pos, up_pos * m, 0.0)
            flux = flux + torch.where(face_neg, up_neg * m, 0.0)
        # slot by slot: a plan rebuilt with other capacities (a restart)
        # adds the same terms in the same order
        return {"flux": slot_sum(flux)}

    return kernel


def make_fused_step_kernel():
    """Flux + apply in one kernel for the step loop: returns the
    post-step density (solve.hpp:272-279 folded into the flux gather)."""
    base = make_flux_kernel()

    def kernel(cell, nbr, offs, mask, dt):
        r = base(cell, nbr, offs, mask, dt)
        return {"density": cell["density"] + r["flux"]}

    return kernel


def make_diff_kernel(diff_threshold: float):
    """Max relative density difference over face neighbors
    (adapter.hpp:110-131)."""

    def kernel(cell, nbr, offs, mask):
        rho_c = cell["density"][:, None]
        rho_n = nbr["density"]
        faces = face_masks(cell["ilen"][:, None], nbr["ilen"], offs, mask)
        is_face = torch.zeros(mask.shape, dtype=torch.bool, device=mask.device)
        for fp, fn in faces:
            is_face = is_face | fp | fn
        diff = torch.abs(rho_c - rho_n) / (torch.minimum(rho_c, rho_n) + diff_threshold)
        return {"max_diff": torch.amax(torch.where(is_face, diff, 0.0), dim=1)}

    return kernel


class AmrAdvection:
    """The reference test's main program (tests/advection/2d.cpp):
    solve / adapt every ``adapt_n`` / balance every ``balance_n``, on
    ``device`` (the card when None; ``[dev] * n`` for n partitions of
    it, cut by ``partition``, the grid's load balancing method when
    None; a list of distinct devices for partitions on each; a
    placement of ``(rank, device)`` entries for partitions on the ranks
    of a process group)."""

    def __init__(self, length=(32, 32, 1), max_refinement_level=1,
                 device=None, cfl=0.5, diff_increase=0.02,
                 diff_threshold=0.025, unrefine_sensitivity=0.5,
                 partition=None):
        self.cfl = cfl
        self.diff_increase = diff_increase
        self.diff_threshold = diff_threshold
        self.unrefine_sensitivity = unrefine_sensitivity
        cell_len = tuple(1.0 / n for n in length)
        self.grid = (
            Grid(cell_data={
                "density": torch.float32, "flux": torch.float32,
                "max_diff": torch.float32,
                "vx": torch.float32, "vy": torch.float32, "vz": torch.float32,
                "lx": torch.float32, "ly": torch.float32, "lz": torch.float32,
                "ilen": torch.int32,
            })
            .set_initial_length(length)
            .set_maximum_refinement_level(max_refinement_level)
            .set_neighborhood_length(1)
            .set_geometry("cartesian", start=(0.0, 0.0, 0.0),
                          level_0_cell_length=cell_len)
            .initialize(device, partition=partition)
        )
        self._flux_kernel = make_flux_kernel()
        self._fused_kernel = make_fused_step_kernel()
        self._diff_kernel = make_diff_kernel(diff_threshold)
        self._join_ranks()
        self._refresh_static()
        cells = self.grid.get_cells()
        self.grid.set("density", cells,
                      hump(self.grid.geometry.get_center(cells)).astype(np.float32))
        self.time = 0.0

    @classmethod
    def from_grid(cls, grid, cfl=0.5, diff_increase=0.02,
                  diff_threshold=0.025, unrefine_sensitivity=0.5,
                  time=0.0):
        """Wrap an existing grid carrying this app's field schema (one
        restored with ``Grid.from_file`` or ``Grid.load_checkpoint``):
        the restart path of the reference's advection test. The static
        fields are recomputed and exchanged; the density is the
        grid's."""
        app = cls.__new__(cls)
        app.cfl = cfl
        app.diff_increase = diff_increase
        app.diff_threshold = diff_threshold
        app.unrefine_sensitivity = unrefine_sensitivity
        app.grid = grid
        app._flux_kernel = make_flux_kernel()
        app._fused_kernel = make_fused_step_kernel()
        app._diff_kernel = make_diff_kernel(diff_threshold)
        app._join_ranks()
        app._refresh_static()
        app.time = time
        return app

    def _join_ranks(self) -> None:
        """On partitions placed on ranks, commit adapts through the
        distributed AMR protocol over the group's store: each rank's
        requests are its own cells, and every rank installs the merged
        commit."""
        g = self.grid
        if g._rank_held and getattr(g, "_amr_group", None) is None:
            g.enable_distributed_amr()

    # -- static per-epoch fields ---------------------------------------

    def _refresh_static(self) -> None:
        g = self.grid
        cells = g.get_cells()
        centers = g.geometry.get_center(cells)
        lengths = g.geometry.get_length(cells)
        v = velocity(centers)
        # the static fields cover every cell: fresh tensors, whose ghost
        # rows the exchange below fills for the whole epoch
        g.set_many(cells, {
            "vx": v[:, 0].astype(np.float32),
            "vy": v[:, 1].astype(np.float32),
            "vz": v[:, 2].astype(np.float32),
            "lx": lengths[:, 0].astype(np.float32),
            "ly": lengths[:, 1].astype(np.float32),
            "lz": lengths[:, 2].astype(np.float32),
            "ilen": g.mapping.get_cell_length_in_indices(cells).astype(np.int32),
        }, preserve_ghosts=False)
        g.update_copies_of_remote_neighbors(fields=list(STATIC_FIELDS))

    # -- time stepping (2d.cpp:321-343) --------------------------------

    def max_time_step(self) -> float:
        """Global CFL limit (solve.hpp:289-333), once per structure
        epoch: it depends only on the static velocity/length fields.
        Each partition's minimum over its rows (ghost rows hold copies,
        pad rows no velocity), then the minimum over the partitions (on
        every device) and the ranks they are placed on."""
        g = self.grid
        cached = getattr(self, "_cfl_cache", None)
        if cached is not None and cached[0] == g.plan.epoch:
            return cached[1]
        steps = []
        for lname, vname in (("lx", "vx"), ("ly", "vy"), ("lz", "vz")):
            s = group_map(
                lambda l, v: torch.where(
                    v.abs() > 0, l / torch.clamp(v.abs(), min=1e-30),
                    torch.inf),
                g.data[lname], g.data[vname])
            steps.append(comm.group_extreme(s, "min", g._rank_held))
        dt = float(torch.stack([t.cpu() for t in steps]).min())
        self._cfl_cache = (g.plan.epoch, dt)
        return dt

    def step(self, dt: float | None = None) -> float:
        """One step: the flux stencil, then apply_fluxes
        (solve.hpp:272-279) as field arithmetic."""
        if dt is None:
            dt = self.cfl * self.max_time_step()
        g = self.grid
        g.update_copies_of_remote_neighbors(fields=["density"])
        g.apply_stencil(
            self._flux_kernel, FLUX_INPUTS, ["flux"],
            extra_args=(torch.tensor(dt, dtype=torch.float32),),
        )
        g.data["density"] = g.data["density"] + g.data["flux"]
        g.data["flux"] = torch.zeros_like(g.data["flux"])
        g._mark_ckpt_dirty(("density", "flux"))
        self.time += dt
        return dt

    def run_fused(self, n_steps: int, dt: float | None = None) -> float:
        """``n_steps`` advection steps through the grid's step loop
        (flux + apply per step). dt is constant across the segment: the
        CFL limit depends only on the static per-epoch fields."""
        if dt is None:
            dt = self.cfl * self.max_time_step()
        self.grid.run_steps(
            self._fused_kernel, FLUX_INPUTS, ["density"], n_steps,
            extra_args=(torch.tensor(dt, dtype=torch.float32),),
        )
        self.time += n_steps * dt
        return dt

    # -- adaptation (adapter.hpp:47-311) -------------------------------

    def _flagged_cells(self) -> tuple:
        """The adaptation criterion on the device: a per-row decision
        code from max_diff and the level (recovered from ilen =
        2^(max_lvl - lvl)), and only the int8 codes cross to the host.
        Returns (ids, codes) with code 1=refine, 2=dont_unrefine,
        3=unrefine, of this process's cells (rows are held slots)."""
        g = self.grid
        max_lvl = g.mapping.max_refinement_level

        def codes(diff, ilen, local):
            lvl = max_lvl - torch.round(
                torch.log2(torch.clamp(ilen, min=1).to(torch.float32))
            ).to(torch.int32)
            refine_t = (lvl + 1).to(torch.float32) * self.diff_increase
            unref_t = self.unrefine_sensitivity * refine_t
            code = torch.where(
                (diff > refine_t) & (lvl < max_lvl), REFINE,
                torch.where(
                    (diff < unref_t) & (lvl > 0), UNREFINE,
                    torch.where((diff <= refine_t) & (diff >= unref_t)
                                & (lvl > 0), KEEP, 0)))
            return torch.where(local > 0, code, 0).to(torch.int8)

        code = g._to_held(group_map(codes, g.data["max_diff"],
                                    g.data["ilen"],
                                    g.local_row_mask())).numpy()
        d, row = np.nonzero(code)
        if len(row) == 0:
            return np.empty(0, np.uint64), np.empty(0, np.int8)
        ids = np.empty(len(d), dtype=np.uint64)
        for i, dev in enumerate(g._held):
            m = d == i
            if m.any():
                ids[m] = g.plan.local_ids[dev][row[m]]
        return ids, code[d, row]

    def adapt(self) -> tuple:
        """check_for_adaptation + adapt_grid: returns (created, removed)."""
        g = self.grid
        if g.mapping.max_refinement_level == 0:
            return (np.empty(0, np.uint64), np.empty(0, np.uint64))
        g.update_copies_of_remote_neighbors(fields=["density"])
        g.apply_stencil(self._diff_kernel, ["density", "ilen"], ["max_diff"])
        ids, codes = self._flagged_cells()
        # conflict resolution between siblings is the grid's job
        # (refine_completely overrides sibling unrefines, dccrg.hpp:2517)
        for c in ids[codes == REFINE]:
            g.refine_completely(c)
        for c in ids[codes == KEEP]:
            g.dont_unrefine(c)
        for c in ids[codes == UNREFINE]:
            g.unrefine_completely(c)
        created = g.stop_refining()
        removed = g.get_removed_cells()
        # project data across the structure change (adapter.hpp:229-301)
        g.assign_children_from_parents(fields=["density"])
        g.average_parents_from_children(fields=["density"])
        g.clear_refined_unrefined_data()
        self._refresh_static()
        g.data["flux"] = torch.zeros_like(g.data["flux"])
        g._mark_ckpt_dirty(("flux",))
        return created, removed

    # -- load balancing (2d.cpp:425-438) -------------------------------

    def balance(self) -> None:
        self.grid.balance_load()
        self._refresh_static()

    # -- diagnostics ---------------------------------------------------

    def total_mass(self) -> float:
        """Sum of density times cell volume in float64: each held
        partition's sum over its local rows, then the sum over every
        partition in partition order (``comm.grid_total``: the one
        process's value on every rank; one host read). The volumes come
        from the geometry in float64, uploaded once per structure
        epoch."""
        g = self.grid
        plan = g.plan
        vol = getattr(plan, "_volume_rows", None)
        if vol is None:
            host = np.zeros((len(g._held), plan.R), dtype=np.float64)
            for i, d in enumerate(g._held):
                ids = plan.local_ids[d]
                if len(ids):
                    host[i, :len(ids)] = np.prod(
                        g.geometry.get_length(ids), axis=1)
            vol = plan._volume_rows = g._from_held(host)
        part = comm.per_partition(g.data["density"].to(torch.float64) * vol,
                                  lambda t: t.sum(dim=1))
        return float(comm.grid_total(g, part))

    def run(self, steps: int, adapt_n: int = 0, balance_n: int = 0,
            fused: bool = True) -> None:
        """The main loop (2d.cpp:321-442). With ``fused`` (default) the
        steps between structure events run as one step loop each
        (run_fused); otherwise one stencil call per step."""
        i = 0
        while i < steps:
            # next structure event bounds the fused segment
            nexts = [steps - i]
            if adapt_n:
                nexts.append(adapt_n - i % adapt_n)
            if balance_n:
                nexts.append(balance_n - i % balance_n)
            seg = min(nexts)
            if fused:
                self.run_fused(seg)
                i += seg
            else:
                self.step()
                i += 1
            if adapt_n and i % adapt_n == 0:
                self.adapt()
            if balance_n and i % balance_n == 0:
                self.balance()
