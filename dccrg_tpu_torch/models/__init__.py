"""Model zoo of the port: advection on the grid, the rotation and dense
paths, Poisson, adaptive advection, the game of life, and the fleet's
zoo kernels (``"mhd"``, ``"vlasov"``), the particle tracker and the
scalability harness.

Importing this package registers every zoo kernel with the fleet
(schemas, seeded default inits and conservation invariants included),
so a :class:`~dccrg_tpu_torch.fleet.FleetJob` can name any zoo kernel;
the fleet imports this package on an unknown kernel name for the same
effect.
"""

from __future__ import annotations

from . import mhd, vlasov
from .mhd import GridMHD
from .vlasov import GridVlasov
from .advection import (AdvectionSolver, CudaRotationAdvection, GridAdvection,
                        analytic_density, hump_density,
                        make_uniform_flux_kernel)
from .advection_amr import AmrAdvection
from .game_of_life import GameOfLife
from .poisson import (POISSON_FIELDS, POISSON_NEIGHBORHOOD_ID,
                      DensePoissonSolver, PoissonSolver, cg_solve,
                      poisson_fields)

# registration at package import (both calls are idempotent)
mhd.register()
vlasov.register()

#: the zoo table: fleet-kernel name -> fields, ghost dependencies,
#: conserved quantities and the model class name
MODEL_ZOO = {
    "mhd": dict(mhd.ZOO_INFO),
    "vlasov": dict(vlasov.ZOO_INFO),
    "diffuse": {
        "kernel": "diffuse", "fields": ("rho",),
        "ghost_deps": None, "conserved": ("rho",),
        "model": None,
        "description": "neighbor-coupling relaxation (fleet workhorse)",
    },
    "advect_x": {
        "kernel": "advect_x", "fields": ("rho",),
        "ghost_deps": None, "conserved": ("rho",),
        "model": None,
        "description": "first-order upwind advection along +x",
    },
}

def ensure_registered() -> None:
    """Idempotent zoo registration (it already ran at package import)."""
    mhd.register()
    vlasov.register()


def available_models() -> list:
    """The zoo, one dict per registered kernel: ``name``, ``fields``,
    ``ghost_deps`` (None = undeclared), ``conserved`` fields, the model
    class name and a one-line description."""
    return [dict(info, name=name)
            for name, info in sorted(MODEL_ZOO.items())]


__all__ = ["AdvectionSolver", "AmrAdvection", "CudaRotationAdvection",
           "DensePoissonSolver", "GameOfLife", "GridAdvection", "GridMHD",
           "GridVlasov", "MODEL_ZOO", "POISSON_FIELDS",
           "POISSON_NEIGHBORHOOD_ID", "PoissonSolver", "analytic_density",
           "available_models", "cg_solve", "ensure_registered",
           "hump_density", "make_uniform_flux_kernel", "poisson_fields"]
