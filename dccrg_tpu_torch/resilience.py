"""Recovery errors of the port (counterpart of ``dccrg_tpu/resilience.py``).

Only the error that the integrity layer subclasses is ported so far;
the checkpoint-driven runner comes with the checkpoint slice.
"""

from __future__ import annotations


class ResilienceExhaustedError(RuntimeError):
    """Every bounded recovery attempt failed; the error is surfaced."""
