"""Conway's game of life on the port's grid.

Port of ``dccrg_tpu/models/game_of_life.py``, the reference's minimal
stencil application (examples/simple_game_of_life.cpp: cell struct
:20-32, main loop :91-159): each cell counts live neighbors over the
radius-1 cube neighborhood and applies the standard rules. On a
refined grid the count runs over the AMR neighbor tables unchanged
(tests/game_of_life/refined.cpp, refined2d.cpp).
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import Grid


def life_kernel(cell, nbr, offs, mask):
    """Count live neighbors and apply the rules (the loop at
    examples/simple_game_of_life.cpp:103-120, as one gather)."""
    total = torch.sum(torch.where(mask, nbr["live"], 0), dim=1,
                      dtype=torch.int32)
    live = torch.where((total == 3) | ((cell["live"] > 0) & (total == 2)), 1, 0)
    return {"live": live, "total": total}


class GameOfLife:
    def __init__(self, length=(10, 10, 1), periodic=(False, False, False),
                 device=None, partition=None, max_refinement_level=0):
        """``device`` as for ``Grid.initialize`` (a list of devices runs
        the game on that many partitions, partitioned by ``partition``);
        ``max_refinement_level > 0`` allows running the game on a
        refined grid (the reference's refined variants), on any number of
        partitions."""
        self.grid = (
            Grid(cell_data={"live": torch.int32, "total": torch.int32})
            .set_initial_length(length)
            .set_periodic(*periodic)
            .set_maximum_refinement_level(max_refinement_level)
            .set_neighborhood_length(1)
            .initialize(device, partition=partition)
        )

    def refine(self, ids) -> None:
        """Refine the given cells and commit; new children inherit the
        parent's live state (refined.cpp re-initializes equivalently)."""
        for c in np.atleast_1d(ids):
            self.grid.refine_completely(c)
        self.grid.stop_refining()
        self.grid.assign_children_from_parents(fields=["live"])
        self.grid.clear_refined_unrefined_data()

    def set_alive(self, ids) -> None:
        self.grid.set("live", np.asarray(ids, dtype=np.uint64),
                      np.ones(len(ids), dtype=np.int32))

    def alive_cells(self) -> np.ndarray:
        cells = self.grid.get_cells()
        live = self.grid.get("live", cells)
        return cells[live > 0]

    def step(self) -> None:
        self.grid.update_copies_of_remote_neighbors(fields=["live"])
        self.grid.apply_stencil(life_kernel, ["live"], ["live", "total"])

    def run(self, n_steps: int) -> None:
        """``n_steps`` generations through the grid's step loop."""
        self.grid.run_steps(life_kernel, ["live"], ["live", "total"],
                            n_steps, exchange_fields=["live"])
