"""Lagrangian particle tracking on the distributed grid, on PyTorch.

Port of ``dccrg_tpu/models/particles.py``, the reference dccrg's
tests/particles apps: each cell owns a variable-size list of 3-D
particle coordinates (tests/particles/cell.hpp:37-84) that moves between
cells as particles advect, with a two-phase transfer (counts first, then
resize, then coordinates, cell.hpp:50-84).

Per-cell particle storage is a fixed-capacity padded buffer (fields
``pos [capacity, 3]`` and ``count``), so a halo update moves both in one
phase. Capacity overflow is detected on the device and handled as a host
replanning event (:meth:`ParticleModel.ensure_capacity`): the collect is
rolled back to a snapshot taken before it, capacity grows to what the
counts demanded and the collect runs again, so no particle is dropped.

Migration is gather-based like every other stencil here: each cell
collects, from itself and all its neighbours, the particles whose
positions fall inside its bounds (the vectorized form of
tests/particles/simple.cpp:62-97). On n partitions the positions and
counts are bit for bit those of one partition: every cell runs the same
operations on the same gathered rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import Grid, _flat


class ParticleModel:
    """``velocity_fn(pos [N, 3] tensor) -> [N, 3]`` is fixed at
    construction. On the card unless ``device`` says otherwise; a list
    of devices runs the model on that many partitions."""

    def __init__(self, velocity_fn, length=(4, 4, 4), capacity=16,
                 device=None, periodic=(False, False, False)):
        self.velocity_fn = velocity_fn
        self.capacity = int(capacity)
        self.grid = (
            Grid(
                cell_data={
                    "pos": ((self.capacity, 3), torch.float32),
                    "count": torch.int32,
                    "overflow": torch.int32,
                    # cell bounds stored per cell (the reference's apps
                    # cache geometry in the cell, tests/advection/cell.hpp)
                    "cell_min": ((3,), torch.float32),
                    "cell_max": ((3,), torch.float32),
                }
            )
            .set_initial_length(length)
            .set_periodic(*periodic)
            .set_neighborhood_length(1)
            .initialize(device)
        )
        self._refresh_bounds()
        # constant per grid: the wrap's bounds and periodic axes
        g = self.grid
        self._start = torch.as_tensor(g.geometry.get_start(), dtype=torch.float32,
                                      device=g.device)
        self._extent = torch.as_tensor(g.geometry.get_end(), dtype=torch.float32,
                                       device=g.device) - self._start
        self._periodic = torch.as_tensor(g.topology.periodic, device=g.device)

    def _refresh_bounds(self) -> None:
        g = self.grid
        cells = g.get_cells()
        g.set_many(cells, {
            "cell_min": g.geometry.get_min(cells).astype(np.float32),
            "cell_max": g.geometry.get_max(cells).astype(np.float32)})

    # -- population ----------------------------------------------------

    def add_particles(self, coordinates) -> int:
        """Host-side seeding: assign each coordinate to its cell, in the
        order given. Returns the number of particles placed (drops those
        outside the grid or beyond a cell's capacity)."""
        coords = np.atleast_2d(np.asarray(coordinates, dtype=np.float32))
        g = self.grid
        # the smallest existing cell containing each coordinate (the
        # reference's get_existing_cell, over the whole array)
        cid = np.zeros(len(coords), dtype=np.uint64)
        todo = np.ones(len(coords), dtype=bool)
        cells = g.plan.cells
        for lvl in range(g.mapping.max_refinement_level, -1, -1):
            if not todo.any():
                break
            c = np.asarray(g.geometry.get_cell(lvl, coords[todo]),
                           dtype=np.uint64)
            pos = np.minimum(np.searchsorted(cells, c), len(cells) - 1)
            hit = (c != 0) & (cells[pos] == c)
            idx = np.nonzero(todo)[0]
            cid[idx[hit]] = c[hit]
            todo[idx[hit]] = False
        keep = cid != 0
        if not keep.any():
            return 0
        kc, kxyz = cid[keep], coords[keep]
        ids, inv = np.unique(kc, return_inverse=True)
        pos = np.array(g.get("pos", ids))
        cnt = np.array(g.get("count", ids)).astype(np.int64)
        # rank of each particle among those of its cell, in input order
        order = np.argsort(inv, kind="stable")
        inv_s = inv[order]
        first = np.r_[0, np.flatnonzero(np.diff(inv_s)) + 1]
        rank = np.arange(len(inv_s)) - np.repeat(
            first, np.diff(np.r_[first, len(inv_s)]))
        slot = cnt[inv_s] + rank
        fits = slot < self.capacity
        pos[inv_s[fits], slot[fits]] = kxyz[order][fits]
        placed = np.bincount(inv_s[fits], minlength=len(ids))
        cnt = (cnt + placed).astype(np.int32)
        g.set_many(ids, {"pos": pos, "count": cnt})
        return int(fits.sum())

    def particles(self) -> np.ndarray:
        """All particle coordinates, gathered to the host, in cell
        order."""
        cells = self.grid.get_cells()
        pos = np.array(self.grid.get("pos", cells))
        cnt = np.array(self.grid.get("count", cells))
        k = np.arange(pos.shape[1])[None, :] < cnt[:, None]
        return pos[k].reshape(-1, 3)

    def counts(self) -> np.ndarray:
        return np.array(self.grid.get("count", self.grid.get_cells()))

    # -- the step -------------------------------------------------------

    def _move_kernel(self, cell, nbr, offs, mask, dt):
        pos = cell["pos"]
        cap = pos.shape[1]
        k = torch.arange(cap, device=pos.device)[None, :]
        alive = k < cell["count"][:, None]
        vel = self.velocity_fn(pos.reshape(-1, 3)).reshape(pos.shape)
        newpos = pos + dt * vel
        # wrap positions through periodic boundaries so the collection
        # phase finds them in the wrapped cell
        wrapped = self._start + torch.remainder(newpos - self._start,
                                                self._extent)
        newpos = torch.where(self._periodic[None, None, :], wrapped, newpos)
        return {"pos": torch.where(alive[..., None], newpos, pos)}

    def _collect(self) -> None:
        g = self.grid
        g.update_copies_of_remote_neighbors(fields=["pos", "count"])
        g.apply_stencil(
            self._collect_kernel,
            ["pos", "count", "cell_min", "cell_max"],
            ["pos", "count", "overflow"],
        )

    def step(self, dt: float) -> None:
        """Advance positions, then migrate particles to their new cells
        via neighbour gathers.

        Capacity overflow is the resize() moment of the reference's
        two-phase transfer: the buffers are copied before the collect,
        and if any cell overflows, they are restored, capacity grows to
        what the counts demanded and the collect runs again. The copy is
        a clone: the halo update writes ghost rows in place."""
        g = self.grid
        # phase 1: move (elementwise on the device)
        g.apply_stencil(
            self._move_kernel, ["pos", "count"], ["pos"],
            extra_args=(torch.tensor(dt, dtype=torch.float32,
                                     device=g.device),),
        )
        # phase 2: exchange buffers, then each cell collects what is
        # inside it. The radius-1 neighbors_of list holds every touching
        # cell, each once on uniform grids
        snap_pos = g.data["pos"].clone()
        snap_cnt = g.data["count"].clone()
        self._collect()
        max_over = int(g.data["overflow"].max())
        if max_over > 0:
            g.data["pos"], g.data["count"] = snap_pos, snap_cnt
            g._mark_ckpt_dirty(("pos", "count"))
            self.ensure_capacity(self.capacity + max_over)
            self._collect()

    def _collect_kernel(self, cell, nbr, offs, mask):
        """Each cell keeps its still-inside particles and adopts those
        of any touching neighbour that now fall in its bounds. Particles
        that cross more than one cell per step are lost, the constraint
        of the reference's neighbour-list transfer
        (tests/particles/simple.cpp). Uniform grids only."""
        cap = self.capacity
        own_pos = cell["pos"]  # [L, cap, 3]
        own_cnt = cell["count"]
        dev = own_pos.device
        kk = torch.arange(cap, device=dev)

        L, X = nbr["count"].shape
        nbr_v = ((kk[None, None, :] < nbr["count"][:, :, None])
                 & mask[:, :, None]).reshape(L, X * cap)
        nbr_p = nbr["pos"].reshape(L, X * cap, 3)
        own_valid = kk[None, :] < own_cnt[:, None]
        cand = torch.cat([own_pos, nbr_p], dim=1)  # [L, M, 3]
        valid = torch.cat([own_valid, nbr_v], dim=1)

        lo = cell["cell_min"][:, None, :]
        hi = cell["cell_max"][:, None, :]
        inside = ((cand >= lo) & (cand < hi)).all(dim=-1) & valid
        # compact: stable order, keepers first (an integer key: sorting
        # a bool tensor is not stable everywhere)
        order = torch.argsort((~inside).to(torch.int32), dim=1, stable=True)
        take = order[:, :cap]
        picked = torch.gather(cand, 1, take[..., None].expand(-1, -1, 3))
        picked_ok = torch.gather(inside, 1, take)
        count = inside.sum(dim=1).to(torch.int32)
        overflow = torch.clamp_min(count - cap, 0)
        count = torch.clamp_max(count, cap)
        newpos = torch.where(picked_ok[..., None], picked,
                             picked.new_zeros(()))
        return {"pos": newpos, "count": count, "overflow": overflow}

    def ensure_capacity(self, new_capacity: int) -> None:
        """Grow the per-cell particle buffers (the resize() phase of the
        reference's two-phase transfer, as a structure epoch): the
        ``[n_dev, R, capacity, 3]`` field is reallocated on the grid's
        device and every cell's particles copied over."""
        if new_capacity <= self.capacity:
            return
        g = self.grid
        old = g.data["pos"]
        self.capacity = int(new_capacity)
        g.fields["pos"] = ((self.capacity, 3), torch.float32)
        grown = torch.zeros((g.n_dev, g.plan.R, self.capacity, 3),
                            dtype=torch.float32, device=g.device)
        # every row of every partition keeps its particles (ghost rows
        # too; the next exchange refreshes them)
        _flat(grown)[:, :old.shape[2]] = _flat(old)
        g.data["pos"] = grown
        # a new capacity changes the field's schema: every save until
        # the next baseline is a keyframe
        g._mark_ckpt_dirty()
