"""Bulk executor for the grid step loop, on a hand-written CUDA kernel.

Port of ``dccrg_tpu/ops/roll_executor.py``. An eligible
``Grid.run_steps`` runs as passes of ``k`` sub-steps each
(``DCCRG_BULK_SPP``, 1..8); every pass is

1. **kernel A** (``bulk_pass``, csrc/bulk_pass.cu): the ``k`` sub-steps
   of the kernel's device flux over all rows in one HBM pass. The TPU
   kernel walked flat ``[G, 8, 128]`` windows and left the rows whose
   flat roll crosses a periodic wrap wrong; this one works on the 3-D
   grid (rows are grid order on a single-device closed-form plan): at
   ``k`` = 1 each thread reads its cell's neighbours directly, at ``k``
   > 1 blocks stage 3-D bricks with a ``k``-deep halo. It wraps exactly,
   so every row it writes is right;
2. **the fixup epilogue** (plain PyTorch on the device, as it is XLA
   code outside the Pallas kernel in the reference): the host-built
   cascade of dilated row sets around the flat-roll wrong rows is re-run
   through the kernel's slot functions with exact gathered neighbors and
   merged into the pass output with ``index_copy_``, so those rows are
   bitwise the plain roll path's.

Eligibility (anything else takes the plain roll path of
``Grid.compile_step_loop``): a single-device closed-form plan, scalar
cell fields, a ``SlotwiseKernel`` that names a device flux this module
knows, the flux's field set in one storage dtype (float32 or bfloat16),
and a brick that fits shared memory. On a CUDA grid an eligible step
loop always launches kernel A; on a CPU grid ``bulk_pass`` computes the
same pass with its plain PyTorch version.

The fleet's batched form (``make_fleet_bulk_step``, for ``GridBatch``)
is **kernel A'** (``fleet_bulk_pass``, csrc/fleet_bulk_pass.cu): one
step of a fleet twin (``diffuse``, ``advect_x``) over every slot of a
``[B, R]`` bucket state with per-slot extras read on the device. It
wraps exactly, so no epilogue follows it.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..grid import (SlotwiseKernel, _make_offs_col, _make_roll3d_gather,
                    _run_slotwise, _synth_col, _synth_prep)
from . import _build

_F32 = torch.float32


def bulk_steps_per_pass() -> int:
    """DCCRG_BULK_SPP: temporal blocking depth of the bulk pass
    (sub-steps per HBM pass), clamped to 1..8."""
    try:
        k = int(os.environ.get("DCCRG_BULK_SPP", "1"))
    except ValueError:
        k = 1
    return max(1, min(k, 8))


# ---------------------------------------------------------------------
# device fluxes: the compile-time functors of csrc/bulk_pass.cu
# ---------------------------------------------------------------------

# name -> (fields read, fields written): the upwind flux of
# models.advection.make_uniform_flux_kernel
DEVICE_FLUXES = {
    "upwind_xy": (("density", "vx", "vy"), ("density",)),
}

_STORAGE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SLOTS = 26
_MAX_SMEM = 232448  # bytes of shared memory a block may opt into on sm_90


def _face_slots(offs_cells, offs_const):
    """``[(j, ox, oy, oz, fx, fy)]`` for the slots through which the
    upwind flux can move mass: ``fx`` / ``fy`` are +1 / -1 where the
    slot's index-unit offset is exactly +1 / -1 in x / y (the flux's
    ``offs[..., d] == +-1`` test), else 0. Slots with neither add exact
    zeros to a sum that is never -0.0, so the kernel skips them."""
    out = []
    for j, (o, oc) in enumerate(zip(offs_cells, offs_const)):
        fx = 1 if oc[0] == 1 else (-1 if oc[0] == -1 else 0)
        fy = 1 if oc[1] == 1 else (-1 if oc[1] == -1 else 0)
        if fx or fy:
            out.append((j, int(o[0]), int(o[1]), int(o[2]), fx, fy))
    return out


class PassSpec:
    """Static geometry of one bulk pass over a single-device
    closed-form plan: the port's counterpart of ``RollPassSpec``
    (dccrg_tpu/ops/roll_executor.py:90). Instead of flat ``[G, 8, 128]``
    windows it holds 3-D bricks: ``brick`` interior cells per axis (x,
    y, z), ``reach`` cells per sub-step per axis (over the slots the
    device flux reads), ``halo = k * reach``. Only a ``k`` > 1 pass
    stages bricks; the ``k`` = 1 pass reads neighbours directly."""

    def __init__(self, shifts, dims, periodic, offs_cells, offs_const, n0,
                 L, k):
        self.shifts = tuple(int(s) for s in shifts)
        self.dims = tuple(int(d) for d in dims)
        self.periodic = tuple(bool(p) for p in periodic)
        self.offs_cells = tuple(tuple(int(v) for v in o) for o in offs_cells)
        self.offs_const = tuple(tuple(int(v) for v in o) for o in offs_const)
        self.n0 = int(n0)
        self.L = int(L)
        self.k = int(k)
        self.slots = _face_slots(self.offs_cells, self.offs_const)
        if len(self.slots) > _MAX_SLOTS:
            raise ValueError(f"{len(self.slots)} slots exceed {_MAX_SLOTS}")
        self.reach = tuple(max((abs(s[1 + d]) for s in self.slots), default=0)
                           for d in range(3))
        self.halo = tuple(self.k * r for r in self.reach)
        self.brick = self._choose_brick()
        if self.smem_bytes() > _MAX_SMEM:
            raise ValueError(
                f"brick {self.brick} with halo {self.halo} needs "
                f"{self.smem_bytes()} B of shared memory")

    def smem_bytes(self, brick=None):
        b = self.brick if brick is None else brick
        cells = 1
        for d in range(3):
            cells *= b[d] + 2 * self.halo[d]
        return 4 * cells * 4

    def _choose_brick(self):
        """x: a window row of 64 cells (two warps' lanes), or the next
        multiple of 32 that leaves at least 16 interior cells; y, z: 16
        and 4. Clipped to the grid and shrunk (y, then z, then x) until
        the window fits shared memory."""
        hx = self.halo[0]
        row = 64
        while row - 2 * hx < 16:
            row += 32
        b = [min(row - 2 * hx, self.dims[0]), min(16, self.dims[1]),
             min(4, self.dims[2])]
        for axis, floor in ((1, 1), (2, 1), (0, 8)):
            while self.smem_bytes(b) > _MAX_SMEM and b[axis] > floor:
                b[axis] = max(floor, b[axis] // 2)
        return tuple(b)

    def bytes_moved(self, itemsize, n_in=3, n_out=1):
        """HBM bytes of one pass at the bound: each input read once,
        each output written once."""
        return (n_in + n_out) * self.n0 * itemsize

    def flops(self):
        """Float operations of one pass: per cell, sub-step and slot,
        two face terms of 6 (add, 3 multiplies, subtract, add), plus
        the final add."""
        return self.k * self.n0 * (12 * len(self.slots) + 1)


# ---------------------------------------------------------------------
# kernel A: the bulk pass
# ---------------------------------------------------------------------

_BULK_SIG = {
    "dccrg_bulk_upwind": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "dccrg_bulk_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _flux_coeffs(kernel, dt):
    """``dt * (1/dx)`` and ``dt * (1/dy)`` in float32, as the flux's
    ``dt * inv[d]`` rounds them."""
    inv = kernel.device_params["inv"]
    dt32 = np.float32(dt)
    return float(dt32 * np.float32(inv[0])), float(dt32 * np.float32(inv[1]))


def bulk_pass(spec, kernel, fields, extras):
    """One bulk pass: ``spec.k`` sub-steps of ``kernel``'s device flux
    over all ``[L]`` rows of ``fields`` (name -> tensor, the flux's
    input fields). Returns ``{out field: [L] tensor}``; pad rows keep
    their values. On CUDA tensors it launches kernel A
    (csrc/bulk_pass.cu) and counts the launch in ``bulk_pass.launches``;
    on CPU tensors it runs :func:`bulk_pass_plain`."""
    names_in, names_out = DEVICE_FLUXES[kernel.device_flux]
    rho, vx, vy = (fields[n] for n in names_in)
    if rho.device.type == "cpu":
        return bulk_pass_plain(spec, kernel, fields, extras)
    if rho.device.type != "cuda":
        raise ValueError(f"bulk_pass runs on CUDA or CPU, got {rho.device}")
    code = _STORAGE_CODES.get(rho.dtype)
    for t in (rho, vx, vy):
        if (t.device != rho.device or t.dtype != rho.dtype
                or t.shape != (spec.L,) or not t.is_contiguous()):
            raise ValueError("bulk_pass needs contiguous [L] tensors of one "
                             "dtype on one device")
    if code is None:
        raise ValueError(f"bulk_pass storage must be float32 or bfloat16, "
                         f"got {rho.dtype}")
    lib = _build.load("bulk_pass", _BULK_SIG)
    out = torch.empty_like(rho)
    nx, ny, nz = spec.dims
    geom = (ctypes.c_int * 13)(
        nx, ny, nz, *(int(p) for p in spec.periodic), *spec.brick,
        *spec.reach, spec.k)
    flat = [v for s in spec.slots for v in s[1:]]
    slots = (ctypes.c_int * max(1, len(flat)))(*flat)
    c0, c1 = _flux_coeffs(kernel, float(extras[0]))
    rc = lib.dccrg_bulk_upwind(
        code, rho.data_ptr(), vx.data_ptr(), vy.data_ptr(), out.data_ptr(),
        geom, slots, len(spec.slots), c0, c1, rho.device.index or 0,
        torch.cuda.current_stream(rho.device).cuda_stream)
    _build.check(lib, "dccrg_bulk", rc)
    bulk_pass.launches += 1
    if spec.L > spec.n0:
        out[spec.n0:] = rho[spec.n0:]
    return {names_out[0]: out}


bulk_pass.launches = 0


def bulk_pass_plain(spec, kernel, fields, extras):
    """The plain PyTorch version of kernel A: ``spec.k`` sub-steps of
    the kernel's slot functions, each slot gathered with an exact 3-D
    ``torch.roll`` and masked in closed form, the carried fields
    rounded to their storage dtype after every sub-step."""
    _names_in, names_out = DEVICE_FLUXES[kernel.device_flux]
    any_t = next(iter(fields.values()))
    synth = (spec.dims, spec.periodic, spec.n0, spec.offs_cells, False)
    gidx, base = _synth_prep(synth, spec.L, any_t.device)
    n_slots = len(spec.offs_cells)
    masks = [_synth_col(synth, gidx, base, j) for j in range(n_slots)]
    gather = _make_roll3d_gather(synth, spec.L)
    offs_col = _make_offs_col(
        True, torch.tensor(spec.offs_const, dtype=torch.int32,
                           device=any_t.device), None)
    cur = dict(fields)
    for _ in range(spec.k):
        res = _run_slotwise(kernel, dict(cur), cur, gather, offs_col,
                            masks.__getitem__, n_slots, extras)
        for f in names_out:
            cur[f] = res[f].to(fields[f].dtype)
    return {f: cur[f] for f in names_out}


# ---------------------------------------------------------------------
# the fixup scatter epilogue
# ---------------------------------------------------------------------

def _flat_coords(rows, dims):
    nx, ny, _nz = dims
    return rows % nx, (rows // nx) % ny, rows // (nx * ny)


def _apply_offset(rows, off, dims, periodic, n0):
    """(valid, flat target) of stepping ``rows`` by cell offset
    ``off`` under the grid's periodicity — host-side mirror of the
    device mask/neighbor arithmetic."""
    rows = np.asarray(rows, dtype=np.int64)
    nx, ny, nz = dims
    x, y, z = _flat_coords(rows, dims)
    t = [x + off[0], y + off[1], z + off[2]]
    valid = rows < n0
    for d, nd in enumerate((nx, ny, nz)):
        if periodic[d]:
            t[d] = t[d] % nd
        else:
            valid = valid & (t[d] >= 0) & (t[d] < nd)
    tgt = t[0] + nx * (t[1] + ny * t[2])
    return valid, np.where(valid, tgt, 0)


def build_epilogue_sets(spec, wrong_rows_host):
    """Host tables of the fixup cascade for a ``spec.k``-deep pass.

    ``W`` = rows whose flat roll is wrong for some slot. After ``k``
    sub-steps the wrongness has spread ``k-1`` stencil hops, and
    repairing it needs pass-input values ``k`` hops further out:
    ``need_k = W ∪ D(W) ∪ ... ∪ D^{k-1}(W)`` (D = inverse-neighbor
    dilation) re-run for k sub-steps over the nested supersets
    ``need_{t-1} = need_t ∪ N(need_t)`` (N = true neighbors), all
    gathers reading exact neighbor rows. Returns ``[(rows_t [Nt],
    nbr_rows_t [Nt, S], mask_t [Nt, S])]`` for t = 1..k (unpadded)."""
    L, k = spec.L, spec.k
    dims, periodic, n0 = spec.dims, spec.periodic, spec.n0
    offs = spec.offs_cells
    W = np.unique(np.asarray(wrong_rows_host, dtype=np.int64).ravel())
    W = W[W < L]

    def dilate_inverse(rows):
        parts = [rows]
        for o in offs:
            inv = (-o[0], -o[1], -o[2])
            valid, tgt = _apply_offset(rows, inv, dims, periodic, n0)
            parts.append(tgt[valid])
        return np.unique(np.concatenate(parts))

    def dilate_forward(rows):
        parts = [rows]
        for o in offs:
            valid, tgt = _apply_offset(rows, o, dims, periodic, n0)
            parts.append(tgt[valid])
        return np.unique(np.concatenate(parts))

    wrong = W
    for _ in range(k - 1):
        wrong = np.union1d(W, dilate_inverse(wrong))
    need = [None] * (k + 1)
    need[k] = wrong
    for t in range(k - 1, 0, -1):
        need[t] = dilate_forward(need[t + 1])

    tables = []
    for t in range(1, k + 1):
        rows = need[t].astype(np.int64)
        S = len(offs)
        nbr = np.zeros((len(rows), S), dtype=np.int32)
        mask = np.zeros((len(rows), S), dtype=bool)
        for j, o in enumerate(offs):
            valid, tgt = _apply_offset(rows, o, dims, periodic, n0)
            nbr[:, j] = tgt.astype(np.int32)
            mask[:, j] = valid
        tables.append((rows.astype(np.int32), nbr, mask))
    return tables


def pad_epilogue_tables(tables, caps, L):
    """Pad the cascade tables to sticky row capacities (rows pad with
    ``L``; the epilogue gathers clamp them and writes only the real
    prefix) so table shapes survive bucketed structure epochs."""
    out = []
    for (rows, nbr, mask), cap in zip(tables, caps):
        n = len(rows)
        rows_p = np.full(cap, L, dtype=np.int32)
        nbr_p = np.zeros((cap, nbr.shape[1]), dtype=np.int32)
        mask_p = np.zeros((cap, nbr.shape[1]), dtype=bool)
        rows_p[:n] = rows
        nbr_p[:n] = nbr
        mask_p[:n] = mask
        out.append((rows_p, nbr_p, mask_p))
    return out


def make_epilogue(kernel, fields_in, fields_out, dtypes, offs_const, L,
                  counts):
    """``fn(cur, tables_flat, extras) -> {field: values}`` — the fixup
    cascade: for each sub-step t, re-run the kernel's slot loop over
    table t's rows with exact gathered neighbors. ``cur`` maps every
    involved field to its ``[L]`` pass input and is not modified:
    intermediate sub-steps write into copies of the output fields.
    Returns the last sub-step's results for the real rows of the last
    table (``counts[t]`` real rows per padded table), in storage dtype,
    ready to merge into the bulk pass output."""
    offs_dev = torch.as_tensor(np.asarray(offs_const, dtype=np.int32))
    S = len(offs_const)
    n_tables = len(counts)

    def fn(cur, tables_flat, extras):
        cur = dict(cur)
        copied = set()
        offs = offs_dev.to(next(iter(cur.values())).device)
        for t in range(n_tables):
            rows, nbr, mask = tables_flat[3 * t: 3 * t + 3]
            rc = torch.clamp(rows, max=L - 1).long()
            nc = torch.clamp(nbr, max=L - 1).long()
            cell = {f: cur[f][rc] for f in fields_in}
            nbrv = {f: torch.where(mask, cur[f][nc], cur[f].new_zeros(()))
                    for f in fields_in}
            acc = kernel.init(cell, *extras)
            for j in range(S):
                acc = kernel.slot(acc, cell, {f: nbrv[f][:, j] for f in fields_in},
                                  offs[j], mask[:, j], *extras)
            res = kernel.finish(acc, cell, *extras)
            n = counts[t]
            if t + 1 == n_tables:
                return {f: res[f][:n].to(dtypes[f]) for f in fields_out}
            for f in fields_out:
                if f not in copied:
                    cur[f] = cur[f].clone()
                    copied.add(f)
                cur[f].index_copy_(0, rc[:n], res[f][:n].to(dtypes[f]))
        return {}

    return fn


# ---------------------------------------------------------------------
# Grid.run_steps integration
# ---------------------------------------------------------------------

def _grid_spec_for(grid, hood, k):
    """PassSpec for a grid's hood, or None when the bulk executor
    cannot express the plan (the caller takes the plain roll path)."""
    cf = hood.closed_form
    if cf is None or cf.get("multi") or grid.n_dev != 1:
        return None
    roll = hood.roll_plan(grid.plan.L)
    if roll is None:
        return None
    try:
        return PassSpec(roll[0], cf["dims"], cf["periodic"], cf["offsets"],
                        hood.offs_const, cf["n0"], int(grid.plan.L), k)
    except ValueError:
        return None


def _eligible_fields(grid, kernel, fields_in, fields_out):
    if not isinstance(kernel, SlotwiseKernel):
        return False
    flux = DEVICE_FLUXES.get(getattr(kernel, "device_flux", None))
    if flux is None:
        return False
    names_in, names_out = flux
    if set(fields_in) != set(names_in) or tuple(fields_out) != names_out:
        return False
    dtypes = set()
    for f in names_in:
        shape, dt = grid.fields[f]
        if shape != ():
            return False
        dtypes.add(dt)
    return len(dtypes) == 1 and dtypes.pop() in _STORAGE_CODES


def compile_bulk_step_loop(grid, kernel, fields_in, fields_out,
                           exchange_fields, neighborhood_id, n_extra):
    """The bulk replacement for Grid.compile_step_loop on an eligible
    single-device closed-form plan: ``n_steps`` steps as ``k``-deep
    bulk passes with fixup epilogues, then ``n_steps % k`` one-deep
    passes. Same ``(fn, tables, static_in)`` contract, ``fn.step_path
    == "bulk"``; returns None when ineligible."""
    fields_in = tuple(fields_in)
    fields_out = tuple(fields_out)
    if not _eligible_fields(grid, kernel, fields_in, fields_out):
        return None
    hood = grid.plan.hoods[neighborhood_id]
    if hood.offs_const is None:
        return None
    k = bulk_steps_per_pass()
    spec_k = _grid_spec_for(grid, hood, k)
    if spec_k is None:
        return None
    spec_1 = spec_k if k == 1 else _grid_spec_for(grid, hood, 1)
    if spec_1 is None:
        return None
    L, R = grid.plan.L, grid.plan.R
    roll = hood.roll_plan(L)
    dtypes = {f: grid.fields[f][1] for f in set(fields_in) | set(fields_out)}
    offs_const = np.asarray(hood.offs_const)
    static_in = tuple(f for f in fields_in if f not in fields_out)
    device = grid.device

    # epilogue cascade tables (host, padded to sticky caps) for the
    # k-deep pass and — when k > 1 — the 1-deep remainder pass; the
    # numpy dilation cascade is surface-sized (about 10^6 rows at
    # 512^3), so it is memoized on the hood (one structure epoch)
    memo = getattr(hood, "_bulk_epilogue", None)
    if memo is None:
        memo = hood._bulk_epilogue = {}

    def padded(spec, tag):
        hit = memo.get(tag)
        if hit is not None:
            return hit
        raw = build_epilogue_sets(spec, roll[1])
        counts = tuple(len(r[0]) for r in raw)
        caps = [grid._sticky_cap(("bulkN", neighborhood_id, tag, t),
                                 max(1, n)) for t, n in enumerate(counts)]
        hit = (pad_epilogue_tables(raw, caps, L), tuple(caps), counts)
        memo[tag] = hit
        return hit

    def upload(tab, tag):
        out = []
        for t, (rows, nbr, mask) in enumerate(tab):
            for name, arr in (("bulk_rows", rows), ("bulk_nbr", nbr),
                              ("bulk_mask", mask)):
                out.append(hood.dev((name, neighborhood_id, tag, t, len(rows)),
                                    arr, device))
        return out

    tab_k, caps_k, counts_k = padded(spec_k, k)
    tables = upload(tab_k, k)
    if k > 1:
        tab_1, caps_1, counts_1 = padded(spec_1, 1)
        tables += upload(tab_1, 1)
    else:
        caps_1, counts_1 = caps_k, counts_k

    key = ("bulksteploop", kernel, fields_in, fields_out, n_extra, L, R,
           spec_k.shifts, spec_k.dims, spec_k.periodic, k, caps_k, caps_1)
    fn = grid._program_cache.get(key)
    if fn is not None:
        return fn, tables, static_in

    n_static, n_out = len(static_in), len(fields_out)
    n_tabs_k = 3 * len(caps_k)
    epi_k = make_epilogue(kernel, fields_in, fields_out, dtypes, offs_const,
                          L, counts_k)
    epi_1 = epi_k if k == 1 else make_epilogue(
        kernel, fields_in, fields_out, dtypes, offs_const, L, counts_1)

    def fn(n_steps, *args):
        n_tabs = n_tabs_k + (3 * len(caps_1) if k > 1 else 0)
        tabs_k = args[:n_tabs_k]
        tabs_1 = tabs_k if k == 1 else args[n_tabs_k:n_tabs]
        args = args[n_tabs:]
        statics = {f: a[0][:L] for f, a in zip(static_in, args[:n_static])}
        outs_full = args[n_static: n_static + n_out]
        # extras ride through float32, for the kernel and the epilogue
        # alike (a float64 extra would otherwise step fixup rows with
        # more dt bits than the bulk rows)
        extras = tuple(torch.as_tensor(e).to(_F32).to(torch.as_tensor(e).dtype)
                       for e in args[n_static + n_out:])

        def one_pass(state, spec, epi, tabs, counts):
            full = dict(statics)
            full.update(state)
            bulk = bulk_pass(spec, kernel, {f: full[f] for f in fields_in},
                             extras)
            fixed = epi(full, tabs, extras)
            rows_last = tabs[-3][:counts[-1]].long()
            for f in fields_out:
                bulk[f].index_copy_(0, rows_last, fixed[f])
            return bulk

        state = {f: a[0][:L] for f, a in zip(fields_out, outs_full)}
        n_steps = int(n_steps)
        for _ in range(n_steps // k):
            state = one_pass(state, spec_k, epi_k, tabs_k, counts_k)
        for _ in range(n_steps % k if k > 1 else 0):
            state = one_pass(state, spec_1, epi_1, tabs_1, counts_1)
        out = []
        for f, a in zip(fields_out, outs_full):
            new = a.clone()
            new[0, :L] = state[f]
            out.append(new)
        return tuple(out)

    fn.step_path = "bulk"
    grid._program_cache[key] = fn
    return fn, tables, static_in


# ---------------------------------------------------------------------
# kernel A': the fleet's batched bulk pass (GridBatch integration)
# ---------------------------------------------------------------------

# device flux of a fleet twin -> (fields read, fields written, the
# functor's code in csrc/fleet_bulk_pass.cu); the twins are
# fleet._make_diffuse_slotwise / _make_advect_x_slotwise
FLEET_FLUXES = {
    "diffuse": (("rho",), ("rho",), 0),
    "advect_x": (("rho",), ("rho",), 1),
}

_FLEET_SIG = {
    "dccrg_fleet_bulk": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]),
    "dccrg_fleet_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


# the slots kernel A' unrolls: the 3x3x3 cube without its centre,
# z-major and x fastest, the default neighbourhood of length 1
_CUBE = tuple((x, y, z) for z in (-1, 0, 1) for y in (-1, 0, 1)
              for x in (-1, 0, 1) if (x, y, z) != (0, 0, 0))


class FleetPassSpec:
    """Static geometry of kernel A' over one bucket's single-device
    closed-form plan: grid extents and periodicity and the slots' cell
    offsets in ``offs_const`` order. Kernel A' unrolls the 26 slots of
    the default neighbourhood of length 1 in that order; any other
    neighbourhood raises ValueError (the bucket keeps the table
    program)."""

    def __init__(self, dims, periodic, offs_cells, offs_const, n0, L):
        self.dims = tuple(int(d) for d in dims)
        self.periodic = tuple(bool(p) for p in periodic)
        self.offs_cells = tuple(tuple(int(v) for v in o) for o in offs_cells)
        self.offs_const = tuple(tuple(int(v) for v in o) for o in offs_const)
        self.n0 = int(n0)
        self.L = int(L)
        self.R = self.L + 1
        signs = tuple(tuple(int(np.sign(v)) for v in o) for o in self.offs_const)
        if self.offs_cells != _CUBE or signs != _CUBE:
            raise ValueError("kernel A' needs the 26-slot neighbourhood of "
                             "length 1 in its default order")

    def bytes_moved(self, batch, itemsize):
        """HBM bytes of one pass at the bound: every slot's rows read
        once and written once."""
        return 2 * batch * self.R * itemsize

    def flops(self, batch, flux):
        """Float operations of one pass: ``diffuse`` a subtract and an
        add per slot, ``advect_x`` an add per slot; two (diffuse) or
        four (advect_x) in the finish."""
        per_cell = (2 * len(self.offs_cells) + 2 if flux == "diffuse"
                    else len(self.offs_cells) + 4)
        return batch * self.n0 * per_cell


def fleet_bulk_pass(spec, kernel, state, extras):
    """One fleet step of ``kernel``'s device flux over every slot of
    ``state`` (the bucket's ``[B, R]`` field, row stride ``R``) with
    per-slot ``extras`` (``[B, E]`` float32, column 0 read). Returns a
    new ``[B, R]`` tensor: rows ``[0, L)`` stepped, the zero row
    copied. On CUDA tensors it launches kernel A'
    (csrc/fleet_bulk_pass.cu) and counts the launch in
    ``fleet_bulk_pass.launches``; on CPU tensors it runs
    :func:`fleet_bulk_pass_plain`."""
    if state.device.type == "cpu":
        return fleet_bulk_pass_plain(spec, kernel, state, extras)
    if state.device.type != "cuda":
        raise ValueError(f"fleet_bulk_pass runs on CUDA or CPU, got "
                         f"{state.device}")
    code = _STORAGE_CODES.get(state.dtype)
    if code is None:
        raise ValueError(f"fleet_bulk_pass storage must be float32 or "
                         f"bfloat16, got {state.dtype}")
    B = state.shape[0]
    if state.shape != (B, spec.R) or not state.is_contiguous():
        raise ValueError(f"fleet_bulk_pass needs a contiguous [B, {spec.R}] "
                         f"state, got {tuple(state.shape)}")
    if (extras.device != state.device or extras.dtype != _F32
            or extras.ndim != 2 or extras.shape[0] != B
            or extras.shape[1] < 1 or not extras.is_contiguous()):
        raise ValueError("fleet_bulk_pass needs contiguous float32 [B, E] "
                         "extras on the state's device")
    flux = FLEET_FLUXES[kernel.device_flux][2]
    lib = _build.load("fleet_bulk_pass", _FLEET_SIG)
    out = torch.empty_like(state)
    nx, ny, nz = spec.dims
    geom = (ctypes.c_int * 8)(nx, ny, nz, *(int(p) for p in spec.periodic),
                              B, extras.shape[1])
    rc = lib.dccrg_fleet_bulk(
        code, flux, state.data_ptr(), out.data_ptr(), extras.data_ptr(), geom,
        spec.n0, spec.L, spec.R, state.device.index or 0,
        torch.cuda.current_stream(state.device).cuda_stream)
    _build.check(lib, "dccrg_fleet", rc)
    fleet_bulk_pass.launches += 1
    return out


fleet_bulk_pass.launches = 0


def fleet_bulk_pass_plain(spec, kernel, state, extras):
    """The plain PyTorch version of kernel A': the twin's slot
    functions over ``[B, L]``, each slot gathered with an exact 3-D
    ``torch.roll`` per grid and masked in closed form, per-slot extras
    as ``[B, 1]`` columns; the result rounded to the storage dtype
    once, the zero row copied."""
    L = spec.L
    name_in = FLEET_FLUXES[kernel.device_flux][0][0]
    synth = (spec.dims, spec.periodic, spec.n0, spec.offs_cells, False)
    gidx, base = _synth_prep(synth, L, state.device)
    gather = _make_roll3d_gather(synth, L, lead=1)
    offs_col = _make_offs_col(
        True, torch.tensor(spec.offs_const, dtype=torch.int32,
                           device=state.device), None)
    ex = tuple(extras[:, i:i + 1] for i in range(extras.shape[1]))
    res = _run_slotwise(
        kernel, {name_in: state[:, :L]}, {name_in: state}, gather, offs_col,
        lambda j: _synth_col(synth, gidx, base, j), len(spec.offs_cells), ex)
    out = state.clone()
    out[:, :L] = res[FLEET_FLUXES[kernel.device_flux][1][0]].to(state.dtype)
    return out


def make_fleet_bulk_step(grid, kernel, fields_in, fields_out, n_extra):
    """Batched bulk step for a fleet bucket: ``step(state, extras)``
    over ``{field: [capacity, R]}`` state with per-slot float32 extras
    ``[capacity, E]`` on the state's device. Each step is one kernel A'
    pass on CUDA (its plain version on the CPU). Kernel A' wraps
    exactly, so no fixup epilogue runs after it: the reference's
    vmapped epilogue would repair nothing here. Returns None when the
    bucket's template grid, schema or kernel is ineligible (the caller
    keeps the table program). The pass takes its batch from the
    state's shape."""
    from .. import grid as grid_mod

    fields_in = tuple(fields_in)
    fields_out = tuple(fields_out)
    if not isinstance(kernel, SlotwiseKernel):
        return None
    flux = FLEET_FLUXES.get(getattr(kernel, "device_flux", None))
    if flux is None or n_extra < 1 or grid.n_dev != 1:
        return None
    names_in, names_out, _code = flux
    if set(fields_in) != set(names_in) or fields_out != names_out:
        return None
    shape, dtype = grid.fields[names_in[0]]
    if shape != () or dtype not in _STORAGE_CODES:
        return None
    hood = grid.plan.hoods[grid_mod.DEFAULT_NEIGHBORHOOD_ID]
    cf = hood.closed_form
    if cf is None or cf.get("multi") or hood.offs_const is None:
        return None
    try:
        spec = FleetPassSpec(cf["dims"], cf["periodic"], cf["offsets"],
                             hood.offs_const, cf["n0"], grid.plan.L)
    except ValueError:
        return None
    name_out = names_out[0]

    def step(state, extras):
        new = dict(state)
        new[name_out] = fleet_bulk_pass(spec, kernel, state[names_in[0]],
                                        extras)
        return new

    step.spec = spec
    return step
