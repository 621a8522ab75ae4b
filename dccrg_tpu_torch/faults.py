"""Fault-injection primitives of the port (counterpart of
``dccrg_tpu/faults.py``).

Only the silent bit-flip value map is ported so far; it is what
``GridBatch.flip`` lands in a slot. Fault plans and their injection
sites come with the resilience slice.
"""

from __future__ import annotations

import numpy as np


def flip_values(vals: np.ndarray, bit: int) -> np.ndarray:
    """XOR ``bit`` into each element's raw bits, guaranteed FINITE:
    an element whose flip would land inf/NaN (exponent saturation)
    takes a finite wrong value instead (``0.5 * v`` for ``|v| >= 2``,
    else ``0.5 * v + 1``, which never overflows and has no fixed point
    at 0). Silent corruption must stay invisible to the finiteness
    watchdog."""
    vals = np.ascontiguousarray(vals)
    kind = vals.dtype.kind
    u = vals.view(f"u{vals.dtype.itemsize}")
    flipped = (u ^ (np.array(1, dtype=u.dtype) << int(bit))).view(
        vals.dtype)
    if kind == "f":
        bad = ~np.isfinite(flipped)
        if bad.any():
            with np.errstate(over="ignore", invalid="ignore"):
                safe = np.where(np.abs(vals) >= 2.0, vals * 0.5,
                                vals * 0.5 + 1.0).astype(vals.dtype)
            flipped = np.where(bad, safe, flipped)
    return flipped
