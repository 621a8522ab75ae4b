"""Silent-data-corruption invariants of the port (counterpart of
``dccrg_tpu/integrity.py``, its in-program layer).

The fleet step computes, per slot, an exact fingerprint of the input
and the output state in the same quantum as the step, plus
conservation sums for kernels registered conservative; the host
compares the fingerprints exactly and the sums within
:func:`sum_tolerance`. ``DCCRG_INTEGRITY=0`` turns the whole layer off:
the quantum then runs no invariant operation at all.

A fingerprint is the pair ``(sum(x), sum((lo16(x)+1) * (hi16(x)+1)))``
over uint32 words in wrapping uint32 arithmetic: commutative and
associative exactly, so the device sums, the host numpy sums and the
reference package's sums agree bit for bit on equal bytes, while a
change that keeps the linear sum still moves the nonlinear one.
PyTorch has no wrapping uint32 reduction, so the device sums run in
int64 and are masked to 32 bits: each term is below 2^34, so 2^29
terms stay far below 2^63.

The checkpoint layer reads :func:`grid_fingerprint` (the live
grid's payload fingerprint, computed on the device) and
:func:`file_fingerprint` (the same pair re-derived from a file's
payload bytes); the shadow-execution audits wait for the scheduler.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import checkpoint as checkpoint_mod
from . import comm
from .resilience import ResilienceExhaustedError

_U32 = 0xFFFFFFFF


class IntegrityError(ResilienceExhaustedError):
    """CORRUPT trips exhausted their bounded retries: device state
    repeatedly failed its own fingerprint/conservation invariants
    while every cheaper detector (finiteness, CRCs) passed.
    ``details`` maps invariant name -> a short description of the
    mismatch."""

    def __init__(self, msg, details=None):
        super().__init__(msg)
        self.details = dict(details or {})


# ---------------------------------------------------------------------
# env knobs
# ---------------------------------------------------------------------

def integrity_enabled(default: bool = True) -> bool:
    """The ``DCCRG_INTEGRITY`` env knob: in-program invariants on
    (default) or off. Off means no invariant operation runs at all."""
    v = os.environ.get("DCCRG_INTEGRITY", "")
    if v == "":
        return default
    return v not in ("0", "off", "false", "no")


def audit_every_default(default: int = 0) -> int:
    """The ``DCCRG_AUDIT_EVERY`` env knob: run a shadow-execution
    audit every N scheduler ticks (0 = audits off). Each audit
    re-executes one slot's last quantum from its pre-quantum state and
    compares digests."""
    try:
        return max(0, int(os.environ.get("DCCRG_AUDIT_EVERY", "")
                          or default))
    except ValueError:
        return default


def quarantine_after_default(default: int = 3) -> int:
    """The ``DCCRG_QUARANTINE_AFTER`` env knob: corrupt verdicts
    attributed to one device lane before the scheduler quarantines it
    and migrates its jobs (0 = never quarantine)."""
    try:
        return max(0, int(os.environ.get("DCCRG_QUARANTINE_AFTER", "")
                          or default))
    except ValueError:
        return default


def note_suspect(lane: int, count: int, quarantined: bool = False) -> None:
    """Export one device lane's suspect accounting as gauges
    (``dccrg_lane_suspects{lane}`` / ``dccrg_lane_quarantined{lane}``):
    an input of the autopilot's audit-cadence rule and of the
    operator's dashboard."""
    from . import telemetry

    telemetry.set_gauge("dccrg_lane_suspects", int(count),
                        lane=str(int(lane)))
    telemetry.set_gauge("dccrg_lane_quarantined",
                        1 if quarantined else 0, lane=str(int(lane)))


def integrity_rtol(default: float = 1e-4) -> float:
    """The ``DCCRG_INTEGRITY_RTOL`` env knob: relative tolerance for
    conservation-sum drift (float reductions are inexact; the
    fingerprints are the exact layer)."""
    try:
        return float(os.environ.get("DCCRG_INTEGRITY_RTOL", "")
                     or default)
    except ValueError:
        return default


def sum_tolerance(base, n_elements: int, steps: int = 1) -> float:
    """Allowed |drift| of a conservation sum over ``steps`` steps of a
    conservative kernel: rounding accumulates about eps per element
    update, so the bound scales with the sum's magnitude, the element
    count and the square root of the step count, while one corrupted
    cell moves the sum by about one cell value."""
    scale = abs(float(base)) + float(n_elements)
    return integrity_rtol() * scale * max(1.0, float(steps)) ** 0.5


# ---------------------------------------------------------------------
# conservation registry: which kernels conserve which fields
# ---------------------------------------------------------------------

# kernel registry name -> (fields, axes that must be periodic for the
# conservation to hold; None = any periodicity)
_CONSERVED: dict = {}


def register_conserved(kernel_name: str, fields, periodic_axes=None):
    """Declare that the registered fleet kernel ``kernel_name``
    conserves the total of ``fields`` (exactly, in real arithmetic),
    provided every axis in ``periodic_axes`` is periodic."""
    _CONSERVED[str(kernel_name)] = (tuple(fields),
                                    None if periodic_axes is None
                                    else tuple(periodic_axes))


# diffusion redistributes over a symmetric neighbour relation (any
# periodicity); upwind advection along x conserves only when x wraps
register_conserved("diffuse", ("rho",))
register_conserved("advect_x", ("rho",), periodic_axes=(0,))


def conserved_fields(kernel, periodic, fields_out) -> tuple:
    """The fields a job's kernel provably conserves under its
    periodicity. Callable kernels (no registry entry) conserve
    nothing that can be assumed."""
    if callable(kernel):
        return ()
    entry = _CONSERVED.get(str(kernel))
    if entry is None:
        return ()
    fields, axes = entry
    if axes is not None and not all(bool(periodic[a]) for a in axes):
        return ()
    return tuple(n for n in fields if n in tuple(fields_out))


# ---------------------------------------------------------------------
# fingerprints: order-independent exact uint32 pairs
# ---------------------------------------------------------------------

def _row_words(arr) -> np.ndarray:
    """``[n, k]`` uint32 word view of per-cell rows: each cell's bytes,
    zero-padded per row to a multiple of 4, so the same cells in any
    order give the same multiset of words."""
    a = np.ascontiguousarray(arr)
    n = a.shape[0] if a.ndim else 1
    b = a.reshape(n, -1).view(np.uint8)
    pad = (-b.shape[1]) % 4
    if pad:
        b = np.concatenate(
            [b, np.zeros((n, pad), dtype=np.uint8)], axis=1)
    return b.view(np.uint32)


def fingerprint_rows(arr) -> tuple:
    """The ``(s1, s2)`` fingerprint of per-cell rows ``arr`` (leading
    axis = cells; a numpy array, bfloat16 as its int16 or ml_dtypes
    view): wrapping-uint32 ``sum(x)`` and
    ``sum((lo16(x)+1) * (hi16(x)+1))`` over the word view."""
    w = _row_words(arr)
    s1 = int(np.sum(w, dtype=np.uint32))
    lo = (w & np.uint32(0xFFFF)) + np.uint32(1)
    hi = (w >> np.uint32(16)) + np.uint32(1)
    s2 = int(np.sum(lo * hi, dtype=np.uint32))
    return s1, s2


def _words(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of the uint32 words of ``x``'s elements, one word
    per element: 32-bit types bitcast, 16-bit types (bfloat16 state)
    widen each element to its own word."""
    size = x.element_size()
    if size == 4:
        return x.view(torch.int32).to(torch.int64) & _U32
    if size == 2:
        return x.view(torch.int16).to(torch.int64) & 0xFFFF
    raise TypeError(f"device fingerprints need a 16- or 32-bit element "
                    f"type, got {x.dtype}")


def _pair(w: torch.Tensor) -> torch.Tensor:
    """``[..., 2]`` int64 ``(s1, s2)`` over the last axis of words."""
    s1 = w.sum(dim=-1) & _U32
    s2 = (((w & 0xFFFF) + 1) * ((w >> 16) + 1)).sum(dim=-1) & _U32
    return torch.stack([s1, s2], dim=-1)


def device_fingerprint(x: torch.Tensor, n_own: int) -> torch.Tensor:
    """The ``(s1, s2)`` pair of one field's owned rows ``x[:n_own]``,
    computed where ``x`` lies: an int64 ``[2]`` tensor of values below
    2^32. One word per element, which equals :func:`fingerprint_rows`'
    padded-row words for 32-bit types and for scalar 16-bit fields."""
    return _pair(_words(x[:n_own]).reshape(-1))


def slot_fingerprints(x: torch.Tensor, n_own: int) -> torch.Tensor:
    """:func:`device_fingerprint` of every slot of a batched field
    ``[B, R, ...]``: int64 ``[B, 2]``."""
    return _pair(_words(x[:, :n_own]).reshape(x.shape[0], -1))


def grid_fingerprint(grid, fields=None) -> dict:
    """``{field: (s1, s2)}`` over the grid's OWNED cell bytes (rows
    ``[0, n_local[p])`` of every partition), the rows
    :func:`dccrg_tpu_torch.checkpoint.state_digest` hashes, equal to
    :func:`fingerprint_rows` of those rows and to the reference's
    fingerprint of a grid holding the same bytes; the sums wrap, so the
    partition does not change it. Computed on the grid's device
    (:func:`device_fingerprint`, one host read per field) where a row is
    one word per element: 32-bit types and scalar 16-bit fields; other
    types on the host. On a grid whose partitions span ranks each rank
    fingerprints its held rows and the pairs are summed over the ranks
    (the sums wrap, so the result is the one-process fingerprint)."""
    out = {}
    for name in sorted(fields if fields is not None else grid.fields):
        shape, dtype = grid.fields[name]
        x = checkpoint_mod.owned_rows(grid, name)
        size = x.element_size()
        if size == 4 or (size == 2 and tuple(shape) == ()):
            s1, s2 = device_fingerprint(x, x.shape[0]).tolist()
            out[name] = (int(s1), int(s2))
        else:
            rows = np.frombuffer(checkpoint_mod.tensor_bytes(x),
                                 dtype=checkpoint_mod.storage_dtype(dtype))
            out[name] = fingerprint_rows(
                rows.reshape((x.shape[0],) + tuple(shape)))
    if grid._rank_held and out:
        names = sorted(out)
        t = comm.all_reduce(torch.tensor(
            [[out[n][k] for n in names for k in (0, 1)]],
            dtype=torch.int64), "sum", True)[0] & _U32
        out = {n: (int(t[2 * i]), int(t[2 * i + 1]))
               for i, n in enumerate(names)}
    return out


def file_fingerprint(path: str, cell_data, header_size: int = 0,
                     variable=None) -> dict:
    """Recompute the ``{field: (s1, s2)}`` fingerprint from a
    checkpoint file's payload bytes: the offline half of the at-rest
    audit. Only fixed (non-ragged) fields fingerprint."""
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    try:
        meta = checkpoint_mod.parse_metadata(raw, header_size)
        fields = checkpoint_mod.cell_data_fields(cell_data)
        cols = checkpoint_mod.payload_columns(
            raw, meta, fields, variable=variable)
        return {name: fingerprint_rows(col)
                for name, col in cols.items()}
    finally:
        del raw


def conservation_sums(grid, fields) -> np.ndarray:
    """Per-field sums over the grid's owned cells: each partition's sum
    cast to float32, then summed over the partitions, as the
    reference's ``comm.field_sums`` path does
    (dccrg_tpu/integrity.py:348-391); read by the host once:
    ``[len(fields)]`` float64."""
    names = tuple(fields)
    if not names:
        return np.zeros(0, dtype=np.float64)
    dev = comm.grid_fold_device(grid)
    parts = torch.stack([
        torch.stack([grid.data[n][i, :int(grid.plan.n_local[p])].sum()
                     .to(torch.float32).to(dev) for n in names])
        for i, p in enumerate(grid._held)])
    return comm.pull_replicated(comm.all_reduce(
        parts, "sum", grid._rank_held)[0]).astype(np.float64)
