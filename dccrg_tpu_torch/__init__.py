"""dccrg_tpu_torch: the PyTorch / CUDA port of dccrg_tpu.

A second package beside ``dccrg_tpu`` (the JAX reference, which it never
imports). It holds the single-device advection main path: the grid
metadata (mapping, length, topology, geometry), the closed-form uniform
plan, the ``Grid`` step loop with its bulk executor (CUDA kernel A,
csrc/bulk_pass.cu) and the rotation fast path (CUDA kernel B,
csrc/rotation_step.cu); and the single-device Poisson solvers
(models/poisson.py: the general-grid ``PoissonSolver`` on
``Grid.apply_stencil``, ``DensePoissonSolver`` on ``DenseGrid``, and
``CudaPoissonSolver`` on CUDA kernel C, csrc/laplacian_matvec.cu);
the fleet's single-device execution layer (fleet.py: ``GridBatch``
stacks same-shape jobs along a batch axis and steps them through CUDA
kernel A', csrc/fleet_bulk_pass.cu; ``run_solo`` is the one-grid
baseline), with its integrity fingerprints (integrity.py); and
single-device adaptive mesh refinement: the neighbor engine under AMR
(neighbors.py), the commit (amr.py), the hybrid plan of refined grids
(hybrid.py), the dense-table gather path of ``Grid`` and the AMR
applications (models/advection_amr.py, models/game_of_life.py); and
durable restart on one device: ``.dc`` checkpoints (checkpoint.py),
their CRC sidecar, salvage, delta-chain loads and the numerics watchdog
(resilience.py), fault plans (faults.py) and telemetry (telemetry.py);
and the distributed level-0 grid on partitions of one device: the
partitioner (partition.py), the partition reductions (comm.py), the
partitioned plans (uniform.py), and in ``Grid`` the halo exchange, the
overlapped step and load balancing (``Grid.initialize([dev] * n)``).
Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); kernels are built with ``nvcc`` at their first CUDA
call, never on import.
"""

from .geometry import CartesianGeometry, NoGeometry, StretchedCartesianGeometry
from .grid import (DEFAULT_NEIGHBORHOOD_ID, CellView, Grid, SlotwiseKernel,
                   bucket_capacity)
from .partition import PARTITION_METHODS, partition_cells
from .length import GridLength
from .dense import DenseGrid
from .fleet import FleetJob, GridBatch, run_solo, template_grid
from .integrity import register_conserved
from .mapping import Mapping
from .neighbors import (NeighborLists, StructureError, build_neighbor_lists,
                        face_masks, find_neighbors_of,
                        find_neighbors_to_subset, make_neighborhood,
                        validate_neighborhood, verify_tiling)
from .topology import GridTopology
from .types import ERROR_CELL, ERROR_INDEX, as_cell_array, as_index_array

__all__ = [
    "CartesianGeometry", "CellView", "DEFAULT_NEIGHBORHOOD_ID", "DenseGrid",
    "ERROR_CELL", "ERROR_INDEX", "FleetJob", "Grid", "GridBatch",
    "GridLength", "GridTopology",
    "Mapping", "NeighborLists", "NoGeometry", "PARTITION_METHODS",
    "SlotwiseKernel",
    "StretchedCartesianGeometry", "StructureError", "as_cell_array",
    "as_index_array", "bucket_capacity", "build_neighbor_lists",
    "face_masks", "find_neighbors_of", "find_neighbors_to_subset",
    "make_neighborhood", "partition_cells", "register_conserved", "run_solo",
    "template_grid", "validate_neighborhood", "verify_tiling",
]
