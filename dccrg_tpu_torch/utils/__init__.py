"""Auxiliary subsystems of the port: VTK dumps and phase timing (the
card's kernel profiler is :mod:`dccrg_tpu_torch.profiling`)."""

from .profiling import PhaseTimer
from .vtk import dc_to_vtk, write_vtk_file

__all__ = ["PhaseTimer", "dc_to_vtk", "write_vtk_file"]
