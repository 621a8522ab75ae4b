"""Bulk executor for the grid step loop, on a hand-written CUDA kernel.

Port of ``dccrg_tpu/ops/roll_executor.py``. An eligible
``Grid.run_steps`` runs as one launch of **kernel A** (``bulk_pass``,
csrc/bulk_pass.cu) per step: one step of the kernel's device flux over
all rows, the carried field rounded to its storage dtype between steps
as the reference's step loop rounds its state.

The TPU kernel walked flat ``[G, 8, 128]`` windows and left the rows
whose flat roll crosses a periodic wrap wrong, for a fixup epilogue to
repair. This one works on the 3-D grid (rows are grid order on a
single-device closed-form plan) and wraps exactly, so every row it
writes is already the plain roll path's and no epilogue runs. The
epilogue's host tables (``build_epilogue_sets``) stay as a ported
reference function: they name the wrap rows, which the tests check on
their own.

Eligibility (anything else takes the plain roll path of
``Grid.compile_step_loop``): a single-device closed-form plan, scalar
cell fields, a ``SlotwiseKernel`` that names a device flux this module
knows, and the flux's field set in one storage dtype (float32 or
bfloat16). On a CUDA grid an eligible step loop always launches kernel
A; on a CPU grid ``bulk_pass`` computes the same pass with its plain
PyTorch version.

The fleet's batched form (``make_fleet_bulk_step``, for ``GridBatch``)
is **kernel A'** (``fleet_bulk_pass``, csrc/fleet_bulk_pass.cu): one
step of a fleet twin (``diffuse``, ``advect_x``) over every slot of a
``[B, R]`` bucket state with per-slot extras read on the device. It
wraps exactly, so no epilogue follows it, and it takes the per-slot
step budgets: a slot whose budget is spent is copied unchanged by the
same launch, so a fleet step on the card is one launch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..grid import (SlotwiseKernel, _make_offs_col, _make_roll3d_gather,
                    _run_slotwise, _synth_col, _synth_prep)
from . import _build

_F32 = torch.float32


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


# the face neighbourhood's four flux slots as (ox, oy, oz, fx, fy), in
# the order of make_neighborhood(0) (-y, -x, +x, +y): the slot set that
# kernel A's plane-tile route unrolls at compile time
_FACE4 = ((0, -1, 0, 0, -1), (-1, 0, 0, -1, 0), (1, 0, 0, 1, 0),
          (0, 1, 0, 0, 1))
_TILE = (128, 16)  # plane-tile route: cells of x and rows of y per block
_TARGET_BLOCKS = 2048  # z is cut into chunks until about this many blocks


class PassSpec:
    """Static geometry of one bulk step over a single-device
    closed-form plan: the port's counterpart of ``RollPassSpec``
    (dccrg_tpu/ops/roll_executor.py:90). ``slots`` are the flux slots.

    The face set (``face4``: the four x / y face slots in ``_FACE4``
    order, the main path's) takes kernel A's plane tiles: a block owns
    a ``tile[0]`` x ``tile[1]`` (x, y) tile and marches ``tile[2]``
    z-planes, each staged with its halo in a shared-memory ring of three
    planes while the next ones load. Any other set takes
    the direct kernel (one cell per thread, neighbours read through the
    cache; ``tile`` is its 32 x 8 block)."""

    def __init__(self, shifts, dims, periodic, offs_cells, offs_const, n0,
                 L):
        self.shifts = tuple(int(s) for s in shifts)
        self.dims = tuple(int(d) for d in dims)
        self.periodic = tuple(bool(p) for p in periodic)
        self.offs_cells = tuple(tuple(int(v) for v in o) for o in offs_cells)
        self.offs_const = tuple(tuple(int(v) for v in o) for o in offs_const)
        self.n0 = int(n0)
        self.L = int(L)
        self.slots = _face_slots(self.offs_cells, self.offs_const)
        if len(self.slots) > _MAX_SLOTS:
            raise ValueError(f"{len(self.slots)} slots exceed {_MAX_SLOTS}")
        self.face4 = tuple(s[1:] for s in self.slots) == _FACE4
        nx, ny, nz = self.dims
        if self.face4:
            tiles = -(-nx // _TILE[0]) * -(-ny // _TILE[1])
            chunks = max(1, min(nz, -(-_TARGET_BLOCKS // tiles)))
            self.tile = (*_TILE, -(-nz // chunks))
        else:
            self.tile = (32, 8, 1)

    def bytes_moved(self, itemsize, n_in=3, n_out=1):
        """HBM bytes of one step at the bound: each input read once,
        each output written once."""
        return (n_in + n_out) * self.n0 * itemsize

    def flops(self):
        """Float operations of one step: per cell and slot, two face
        terms of 6 (add, 3 multiplies, subtract, add), plus the final
        add."""
        return self.n0 * (12 * len(self.slots) + 1)


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


def bulk_pass(spec, kernel, fields, extras, out=None):
    """One step of ``kernel``'s device flux over all ``[L]`` rows of
    ``fields`` (name -> tensor, the flux's input fields). Returns
    ``{out field: [L] tensor}`` in the storage dtype; pad rows keep
    their values. On CUDA tensors it is one launch of kernel A
    (csrc/bulk_pass.cu), counted in ``bulk_pass.launches``; on CPU
    tensors it runs :func:`bulk_pass_plain`. ``out``, an ``[L]``
    tensor, takes the result in place of a new one. ``extras[0]`` (dt)
    is read on the host: the step loop hands it over as a CPU tensor,
    so the launch waits on nothing on the device."""
    names_in, names_out = DEVICE_FLUXES[kernel.device_flux]
    rho, vx, vy = (fields[n] for n in names_in)
    if rho.device.type == "cpu":
        res = bulk_pass_plain(spec, kernel, fields, extras)
        if out is not None:
            out.copy_(res[names_out[0]])
            res = {names_out[0]: out}
        return res
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
    if out is None:
        out = torch.empty_like(rho)
    elif (out.device != rho.device or out.dtype != rho.dtype
          or out.shape != (spec.L,) or not out.is_contiguous()):
        raise ValueError("bulk_pass out must be a contiguous [L] tensor like "
                         "the fields")
    lib = _build.load("bulk_pass", _BULK_SIG)
    nx, ny, nz = spec.dims
    geom = (ctypes.c_int * 9)(nx, ny, nz, *(int(p) for p in spec.periodic),
                              *spec.tile)
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
    """The plain PyTorch version of kernel A: one step of the kernel's
    slot functions, each slot gathered with an exact 3-D ``torch.roll``
    and masked in closed form, the result rounded to its storage
    dtype."""
    _names_in, names_out = DEVICE_FLUXES[kernel.device_flux]
    any_t = next(iter(fields.values()))
    synth = (spec.dims, spec.periodic, spec.n0, spec.offs_cells, False)
    gidx, base = _synth_prep(synth, spec.L, any_t.device)
    n_slots = len(spec.offs_cells)
    gather = _make_roll3d_gather(synth, spec.L)
    offs_col = _make_offs_col(
        True, torch.tensor(spec.offs_const, dtype=torch.int32,
                           device=any_t.device), None)
    res = _run_slotwise(kernel, dict(fields), fields, gather, offs_col,
                        lambda j: _synth_col(synth, gidx, base, j), n_slots,
                        extras)
    return {f: res[f].to(fields[f].dtype) for f in names_out}


# ---------------------------------------------------------------------
# the fixup epilogue's host tables
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


def build_epilogue_sets(spec, wrong_rows_host, k=1):
    """Host tables of the reference's fixup cascade for a ``k``-deep
    pass (its ``DCCRG_BULK_SPP``).

    ``W`` = rows whose flat roll is wrong for some slot. After ``k``
    sub-steps the wrongness has spread ``k-1`` stencil hops, and
    repairing it needs pass-input values ``k`` hops further out:
    ``need_k = W ∪ D(W) ∪ ... ∪ D^{k-1}(W)`` (D = inverse-neighbor
    dilation) re-run for k sub-steps over the nested supersets
    ``need_{t-1} = need_t ∪ N(need_t)`` (N = true neighbors), all
    gathers reading exact neighbor rows. Returns ``[(rows_t [Nt],
    nbr_rows_t [Nt, S], mask_t [Nt, S])]`` for t = 1..k (unpadded)."""
    L = spec.L
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


# ---------------------------------------------------------------------
# Grid.run_steps integration
# ---------------------------------------------------------------------

def _grid_spec_for(grid, hood):
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
                        hood.offs_const, cf["n0"], int(grid.plan.L))
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
    single-device closed-form plan: ``n_steps`` launches of kernel A
    and nothing else on the device. Same ``(fn, tables, static_in)``
    contract (no tables), ``fn.step_path == "bulk"``; returns None when
    ineligible."""
    fields_in = tuple(fields_in)
    fields_out = tuple(fields_out)
    if not _eligible_fields(grid, kernel, fields_in, fields_out):
        return None
    hood = grid.plan.hoods[neighborhood_id]
    if hood.offs_const is None:
        return None
    spec = _grid_spec_for(grid, hood)
    if spec is None:
        return None
    L, R = grid.plan.L, grid.plan.R
    static_in = tuple(f for f in fields_in if f not in fields_out)
    key = ("bulksteploop", kernel, fields_in, fields_out, n_extra, L, R,
           spec.shifts, spec.dims, spec.periodic)
    fn = grid._program_cache.get(key)
    if fn is not None:
        return fn, (), static_in

    n_static, n_out = len(static_in), len(fields_out)

    def fn(n_steps, *args):
        statics = {f: a[0][:L] for f, a in zip(static_in, args[:n_static])}
        outs_full = args[n_static: n_static + n_out]
        # extras ride through float32, as the kernel reads them
        extras = tuple(torch.as_tensor(e).to(_F32).to(torch.as_tensor(e).dtype)
                       for e in args[n_static + n_out:])

        n_steps = int(n_steps)
        # the flux writes one field; the last launch writes the new
        # state's rows in place, and only the rows past L are copied
        (f_out,), (a_out,) = fields_out, outs_full
        new = torch.empty_like(a_out)
        state = {f_out: a_out[0, :L]}
        for i in range(n_steps):
            full = dict(statics)
            full.update(state)
            state = bulk_pass(spec, kernel, {f: full[f] for f in fields_in},
                              extras,
                              out=new[0, :L] if i + 1 == n_steps else None)
        if n_steps == 0:
            new[0, :L] = a_out[0, :L]
        new[0, L:] = a_out[0, L:]
        return (new,)

    fn.step_path = "bulk"
    grid._program_cache[key] = fn
    return fn, (), static_in


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
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]),
    "dccrg_fleet_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}

# kernel A''s routes, by the code its entry point takes: the plane
# route stages z-planes of a y band in shared memory (x extents up to
# 256 that are a whole number of 16-byte chunks), the direct route
# reads neighbours through the cache
FLEET_ROUTES = ("planes", "direct")
_MAX_PLANE_X = 256


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


def fleet_route(spec, state):
    """The route kernel A' takes for ``spec`` over ``state``:
    ``"planes"`` where the x extent is at most 256 and a multiple of
    16 bytes' elements (4 float32, 8 bfloat16), the row stride fits 32
    bits and the allocation is 16-byte aligned, else ``"direct"``. The
    kernel's entry point checks the same rule."""
    nx = spec.dims[0]
    fits = (nx <= _MAX_PLANE_X and nx % (16 // state.element_size()) == 0
            and spec.R < 2 ** 31 - 1 and state.data_ptr() % 16 == 0)
    return FLEET_ROUTES[0 if fits else 1]


def _check_budget(budget, state):
    if (budget.device != state.device or budget.dtype != torch.int32
            or budget.shape != (state.shape[0],)
            or not budget.is_contiguous()):
        raise ValueError("fleet_bulk_pass needs a contiguous int32 [B] "
                         "budget on the state's device")


def fleet_freeze(new, old, budget, i):
    """The per-slot budget freeze: slot ``b`` of ``new`` where
    ``budget[b] > i``, else ``old``'s bytes unchanged (``torch.where``
    selects elements, so NaN payloads and -0.0 stay exactly)."""
    live = (budget > i).reshape((-1,) + (1,) * (new.ndim - 1))
    return torch.where(live, new, old)


def fleet_library():
    """Kernel A''s loaded library, built first where the build directory
    lacks it."""
    return _build.load("fleet_bulk_pass", _FLEET_SIG)


def fleet_bulk_pass(spec, kernel, state, extras, budget=None, i=0):
    """One fleet step of ``kernel``'s device flux over every slot of
    ``state`` (the bucket's ``[B, R]`` field, row stride ``R``) with
    per-slot ``extras`` (``[B, E]`` float32, column 0 read). Returns a
    new ``[B, R]`` tensor: rows ``[0, L)`` stepped, the zero row
    copied. With ``budget`` (int32 ``[B]`` on the state's device), a
    slot whose ``budget[b] <= i`` is frozen: its rows come out as its
    input bytes. ``budget=None`` steps every slot.

    On CUDA tensors it launches kernel A' (csrc/fleet_bulk_pass.cu) once,
    freeze included, and counts the launch in
    ``fleet_bulk_pass.launches``; on CPU tensors it runs
    :func:`fleet_bulk_pass_plain` and, with a budget,
    :func:`fleet_freeze`."""
    if budget is not None:
        _check_budget(budget, state)
    if state.device.type == "cpu":
        out = fleet_bulk_pass_plain(spec, kernel, state, extras)
        return out if budget is None else fleet_freeze(out, state, budget, i)
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
    lib = fleet_library()
    out = torch.empty_like(state)
    nx, ny, nz = spec.dims
    geom = (ctypes.c_int * 8)(nx, ny, nz, *(int(p) for p in spec.periodic),
                              B, extras.shape[1])
    route = FLEET_ROUTES.index(fleet_route(spec, state))
    rc = lib.dccrg_fleet_bulk(
        code, flux, route, state.data_ptr(), out.data_ptr(),
        extras.data_ptr(), None if budget is None else budget.data_ptr(),
        int(i), geom, spec.n0, spec.L, spec.R, state.device.index or 0,
        torch.cuda.current_stream(state.device).cuda_stream)
    _build.check(lib, "dccrg_fleet", rc)
    fleet_bulk_pass.launches += 1
    return out


fleet_bulk_pass.launches = 0


def fleet_bulk_pass_plain(spec, kernel, state, extras):
    """The plain PyTorch version of kernel A' without the freeze: the
    twin's slot functions over ``[B, L]``, each slot gathered with an
    exact 3-D ``torch.roll`` per grid and masked in closed form,
    per-slot extras as ``[B, 1]`` columns; the result rounded to the
    storage dtype once, the zero row copied."""
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
    """Batched bulk step for a fleet bucket: ``step(state, extras,
    budget, i)`` over ``{field: [capacity, R]}`` state with per-slot
    float32 extras ``[capacity, E]`` and int32 budgets ``[capacity]``
    on the state's device: step ``i`` of a quantum, slots with
    ``budget <= i`` frozen. Each step is one kernel A' launch on CUDA,
    freeze included (its plain version and ``torch.where`` on the
    CPU). Kernel A' wraps exactly, so no fixup epilogue runs after it:
    the reference's vmapped epilogue would repair nothing here. Returns
    None when the bucket's template grid, schema or kernel is
    ineligible (the caller keeps the table program). The pass takes its
    batch from the state's shape."""
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

    def step(state, extras, budget, i):
        new = dict(state)
        new[name_out] = fleet_bulk_pass(spec, kernel, state[names_in[0]],
                                        extras, budget, i)
        return new

    step.spec = spec
    return step
