"""Model zoo of the port (single-device slices: advection on the grid,
rotation and dense paths, Poisson, adaptive advection, the game of
life)."""

from .advection import (AdvectionSolver, CudaRotationAdvection, GridAdvection,
                        analytic_density, hump_density,
                        make_uniform_flux_kernel)
from .advection_amr import AmrAdvection
from .game_of_life import GameOfLife
from .poisson import (POISSON_FIELDS, POISSON_NEIGHBORHOOD_ID,
                      DensePoissonSolver, PoissonSolver, cg_solve,
                      poisson_fields)

__all__ = ["AdvectionSolver", "AmrAdvection", "CudaRotationAdvection",
           "DensePoissonSolver", "GameOfLife", "GridAdvection",
           "POISSON_FIELDS", "POISSON_NEIGHBORHOOD_ID", "PoissonSolver",
           "analytic_density", "cg_solve", "hump_density",
           "make_uniform_flux_kernel", "poisson_fields"]
