"""The port's copy of the golden ``.dc`` fixture's builder
(``tests/golden_fixture.py`` imports ``jax.numpy``; this one imports
only torch, numpy and ``dccrg_tpu_torch``, so ``chip_smoke.py`` builds
the same grid on the card).

``build_golden_grid`` makes the deterministic (4, 4, 2) grid with cells
1 and 22 refined and per-cell values derived from the ids; saved with
``header=HEADER, variable=GOLDEN_VARIABLE`` it reproduces
``tests/data/golden.dc`` byte for byte.
"""

import os

import numpy as np
import torch

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden.dc")
HEADER = b"golden-v1\n"

GOLDEN_SCHEMA = {
    "density": torch.float32,
    "flag": torch.int32,
    "count": torch.int32,
    "pos": ((4, 3), torch.float32),  # variable, truncated by "count"
}
GOLDEN_VARIABLE = {"pos": "count"}


def golden_values(cells):
    """The fixture's per-cell values ``{field: numpy array}``."""
    ids = cells.astype(np.float64)
    pos = np.zeros((len(cells), 4, 3), dtype=np.float32)
    for r in range(4):
        for c in range(3):
            pos[:, r, c] = (ids * (r + 1) + c).astype(np.float32)
    return {
        "density": (ids * 0.5).astype(np.float32),
        "flag": (cells % np.uint64(7)).astype(np.int32),
        "count": (cells % np.uint64(5)).astype(np.int32),
        "pos": pos,
    }


def build_golden_grid(device="cpu"):
    """The golden grid on ``device``."""
    from dccrg_tpu_torch import Grid

    g = (Grid(cell_data=GOLDEN_SCHEMA)
         .set_initial_length((4, 4, 2))
         .set_periodic(True, False, False)
         .set_maximum_refinement_level(1)
         .set_neighborhood_length(1)
         .set_geometry("cartesian", start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(0.25, 0.25, 0.5))
         .initialize(device))
    g.refine_completely(np.uint64(1))
    g.refine_completely(np.uint64(22))
    g.stop_refining()
    cells = g.plan.cells
    g.set_many(cells, golden_values(cells))
    return g


def check_golden_values(g):
    """Raise AssertionError unless ``g`` holds the fixture's values
    (``pos`` only in the rows below each cell's count, the rows a file
    stores)."""
    cells = np.asarray(g.plan.cells)
    if len(cells) != 46 or np.uint64(1) in cells or np.uint64(22) in cells:
        raise AssertionError(f"golden cell set differs ({len(cells)} cells)")
    want = golden_values(cells)
    for name in ("density", "flag", "count"):
        np.testing.assert_array_equal(g.get(name, cells), want[name],
                                      err_msg=name)
    keep = np.arange(4)[None, :] < want["count"][:, None]
    np.testing.assert_array_equal(g.get("pos", cells)[keep],
                                  want["pos"][keep], err_msg="pos")
