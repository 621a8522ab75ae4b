"""Model zoo of the port (single-device slice: advection)."""

from .advection import (CudaRotationAdvection, GridAdvection, analytic_density,
                        hump_density, make_uniform_flux_kernel)

__all__ = ["CudaRotationAdvection", "GridAdvection", "analytic_density",
           "hump_density", "make_uniform_flux_kernel"]
