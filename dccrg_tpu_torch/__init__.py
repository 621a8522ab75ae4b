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
overlapped step and load balancing (``Grid.initialize([dev] * n)``),
and adaptive refinement across those partitions; the dense grid on a
mesh of blocks (``dense_mesh``) with ``AdvectionSolver`` and
``DensePoissonSolver`` on it, and ``PoissonSolver`` on partitions; a
grid's partitions, the models on it and a mesh's blocks placed on the
ranks of a ``torch.distributed`` group (``coord.rank_devices``), each
rank holding and stepping its own; and
atomic, verified grid mutations: the ``DCCRG_DEBUG=1`` verifiers
(verify.py) and ``grid_transaction`` around the commit, the balance and
``load_cells`` (txn.py); and the model zoo (models/mhd.py and
models/vlasov.py, registered with the fleet at ``import
dccrg_tpu_torch.models``; models/particles.py, models/scalability.py),
the VTK writer and phase timers (utils/), and the background plan build
and async checkpoint save (background.py); and run supervision: the
coordination layer on ``torch.distributed`` (coord.py), delta
checkpoints, the OOM fallback chain, ``ResilientRunner`` and the device
probes (resilience.py), and preemption, step deadlines, the numbered
checkpoint store with its retention GC and ``resume_latest``
(supervise.py); and the fleet's serving layer: ``FleetScheduler``
(scheduler.py: admission, backfill, per-job checkpoint stems, the SDC
defence, SLO shedding, preemption and the elastic multi-rank fleet over
job leases) with its autopilot (autopilot.py) and the fleet CLI
(``python -m dccrg_tpu_torch.fleet``).
Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); kernels are built with ``nvcc`` at their first CUDA
call, never on import.
"""

from .geometry import CartesianGeometry, NoGeometry, StretchedCartesianGeometry
from .grid import (DEFAULT_NEIGHBORHOOD_ID, CellView, Grid, SlotwiseKernel,
                   bucket_capacity)
from .partition import PARTITION_METHODS, partition_cells
from .length import GridLength
from .dense import DenseGrid, dense_mesh
from .fleet import (FleetJob, GridBatch, job_from_row, max_batch_default,
                    quantum_default, run_solo, template_grid)
from .integrity import register_conserved
from .mapping import Mapping
from .neighbors import (NeighborLists, StructureError, build_neighbor_lists,
                        face_masks, find_neighbors_of,
                        find_neighbors_to_subset, make_neighborhood,
                        validate_neighborhood, verify_tiling)
from .topology import GridTopology
from .types import ERROR_CELL, ERROR_INDEX, as_cell_array, as_index_array
from .verify import VerificationError, verify_all
from .txn import (CrossRankAbortedError, GridInvariantError,
                  MutationAbortedError, MutationError)
from .faults import FaultPlan
from .coord import (BarrierTimeoutError, CheckpointCommitError,
                    DistributedInitError, Membership, PeerDeadError,
                    barrier, distributed_init, trip_consensus)
from .resilience import (CheckpointCorruptionError, DeviceProbeError,
                         NumericsError, ResilienceExhaustedError,
                         ResilientRunner, guarded_step, load_checkpoint,
                         save_checkpoint, safe_devices)
from .supervise import (RESUMABLE_EXIT, CheckpointStore, PreemptedError,
                        StepTimeoutError, SupervisedRunner,
                        gc_checkpoints, resume_latest)
from .autopilot import Autopilot
from .scheduler import (FleetPreemptedError, FleetScheduler, JobLeases,
                        OwnershipLostError, SLOPolicy)

__all__ = [
    "Autopilot", "FleetPreemptedError", "FleetScheduler", "JobLeases",
    "OwnershipLostError", "SLOPolicy", "job_from_row", "max_batch_default",
    "quantum_default",
    "BarrierTimeoutError", "CheckpointCommitError",
    "CheckpointCorruptionError", "CheckpointStore", "DeviceProbeError",
    "DistributedInitError", "FaultPlan", "Membership", "NumericsError",
    "PeerDeadError", "PreemptedError", "RESUMABLE_EXIT",
    "ResilienceExhaustedError", "ResilientRunner", "StepTimeoutError",
    "SupervisedRunner", "barrier", "distributed_init", "gc_checkpoints",
    "guarded_step", "load_checkpoint", "resume_latest", "safe_devices",
    "save_checkpoint", "trip_consensus",
    "CartesianGeometry", "CellView", "CrossRankAbortedError",
    "DEFAULT_NEIGHBORHOOD_ID", "DenseGrid",
    "ERROR_CELL", "ERROR_INDEX", "FleetJob", "Grid", "GridBatch",
    "GridInvariantError", "GridLength", "GridTopology",
    "MutationAbortedError", "MutationError", "VerificationError",
    "Mapping", "NeighborLists", "NoGeometry", "PARTITION_METHODS",
    "SlotwiseKernel",
    "StretchedCartesianGeometry", "StructureError", "as_cell_array",
    "as_index_array", "bucket_capacity", "build_neighbor_lists",
    "face_masks", "find_neighbors_of", "find_neighbors_to_subset",
    "make_neighborhood", "partition_cells", "register_conserved", "run_solo",
    "dense_mesh", "template_grid", "validate_neighborhood", "verify_all",
    "verify_tiling",
]
