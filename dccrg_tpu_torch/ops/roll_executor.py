"""Bulk executor for the grid step loop, on hand-written CUDA kernels.

Port of ``dccrg_tpu/ops/roll_executor.py``. An eligible
``Grid.run_steps`` runs as one launch of **kernel A** (``bulk_pass``,
csrc/bulk_pass.cu) per step: one step of the kernel's device flux over
all rows, the carried field rounded to its storage dtype between steps
as the reference's step loop rounds its state. The device fluxes
(:data:`DEVICE_FLUXES`, the functors of csrc/fluxes.cuh) are the
upwind advection flux and the fleet's twins ``diffuse`` and
``advect_x``, on any neighbourhood of up to 124 slots (the cube of
length 2).

With ``DCCRG_BULK_SPP=k`` (:func:`bulk_steps_per_pass`, 1..8, the
reference's knob) the loop runs as the reference's does: ``n // k``
launches of **kernel A's k-deep pass** (``bulk_pass_k``,
csrc/bulk_pass_k.cu: k sub-steps on chip, the carried field rounded to
storage after each), then ``n % k`` one-step launches. The k-deep pass
streams the sub-steps through the grid as time-skewed levels: along y
in each z-plane for the face set, along z in (x, y) bricks for any
other slot set. The step loop takes the bricks only where they beat
one-step launches (:meth:`PassSpec.deep_pays`), and runs one-step
launches where the rule declines a set, as the reference's executor
declines a spec whose halo does not fit.

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
bfloat16). The reference traces any Python flux into its Pallas body;
the port compiles its fluxes from the repo's sources, so a
``SlotwiseKernel`` with no named device flux, or fields of mixed
storage dtypes, takes the plain roll path. On a CUDA grid an eligible
step loop always launches kernel A; on a CPU grid ``bulk_pass``
computes the same pass with its plain PyTorch version.

The fleet's batched form (``make_fleet_bulk_step``, for ``GridBatch``)
is **kernel A'** (``fleet_bulk_pass``, csrc/fleet_bulk_pass.cu): one
step of a fleet twin (``diffuse``, ``advect_x``) over every slot of a
``[B, R]`` bucket state with per-slot extras read on the device, on
any default neighbourhood a bucket can have (the 26-cube unrolled,
lengths 0 and 2 over a slot table). It wraps exactly, so no epilogue
follows it, and it takes the per-slot step budgets: a slot whose
budget is spent is copied unchanged by the same launch, so a fleet
step on the card is one launch.
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
    (sub-steps per pass over device memory), clamped to 1..8 and 1
    where it does not parse, as the reference reads it
    (dccrg_tpu/ops/roll_executor.py:75-83)."""
    try:
        k = int(os.environ.get("DCCRG_BULK_SPP", "1"))
    except ValueError:
        k = 1
    return max(1, min(k, 8))


# ---------------------------------------------------------------------
# device fluxes: the compile-time functors of csrc/fluxes.cuh
# ---------------------------------------------------------------------

# name -> (fields read, fields written, the functor's kCode): the
# upwind flux of models.advection.make_uniform_flux_kernel and the
# fleet's twins (fleet._make_diffuse_slotwise, _make_advect_x_slotwise).
# Field 0 is the carried one; the rest are static over a pass.
DEVICE_FLUXES = {
    "diffuse": (("rho",), ("rho",), 0),
    "advect_x": (("rho",), ("rho",), 1),
    "upwind_xy": (("density", "vx", "vy"), ("density",), 2),
}

_STORAGE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SLOTS = 124  # the cube of a neighbourhood of length 2


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


def _flux_slots(flux, offs_cells, offs_const):
    """The slots ``flux`` reads, in the neighbourhood's order, as
    ``[(j, ox, oy, oz, fx, fy)]`` (the predicate each functor of
    csrc/fluxes.cuh states): the upwind flux's face slots
    (:func:`_face_slots`); every slot for ``diffuse``; for ``advect_x``
    the slots whose offset has x < 0, y == 0, z == 0 (the twin's ``up``
    test, on ``offs_const`` as the twin reads it). ``fx`` and ``fy`` are
    0 but for the upwind flux. A slot left out adds an exact +0.0 to a
    sum that is never -0.0."""
    if flux == "upwind_xy":
        return _face_slots(offs_cells, offs_const)
    out = []
    for j, (o, oc) in enumerate(zip(offs_cells, offs_const)):
        if flux == "diffuse" or (oc[0] < 0 and oc[1] == 0 and oc[2] == 0):
            out.append((j, int(o[0]), int(o[1]), int(o[2]), 0, 0))
    return out


def _slot_rows(slots):
    """The kernels' slot table: one ``(ox, oy, oz, code)`` row a slot,
    the code ``(fx + 1) | (fy + 1) << 2`` (read by the upwind flux
    alone)."""
    return [(ox, oy, oz, (fx + 1) | ((fy + 1) << 2))
            for _j, ox, oy, oz, fx, fy in slots]


def _flux_flops(flux, n_read):
    """Float operations a cell of one step of a single-field twin over
    ``n_read`` read slots: ``diffuse`` a subtract and an add a slot, a
    multiply and an add in the finish; ``advect_x`` an add a slot and
    four in the finish."""
    return 2 * n_read + 2 if flux == "diffuse" else n_read + 4


class _SlotTables:
    """A slot table's rows on the host and, made at first use, one int32
    ``[n, 4]`` copy per device (the kernels read it from device memory:
    up to 124 rows do not fit a launch's parameters)."""

    def __init__(self, rows):
        self.rows = [tuple(int(v) for v in r) for r in rows]
        self._dev = {}

    def host(self):
        flat = [v for r in self.rows for v in r]
        return (ctypes.c_int * max(1, len(flat)))(*flat)

    def on(self, device):
        t = self._dev.get(device)
        if t is None:
            t = torch.tensor(self.rows or [(0, 0, 0, 0)], dtype=torch.int32,
                             device=device).contiguous()
            self._dev[device] = t
        return t


# the face neighbourhood's four flux slots as (ox, oy, oz, fx, fy), in
# the order of make_neighborhood(0) (-y, -x, +x, +y): the slot set that
# kernel A's plane-tile route unrolls at compile time
_FACE4 = ((0, -1, 0, 0, -1), (-1, 0, 0, -1, 0), (1, 0, 0, 1, 0),
          (0, 1, 0, 0, 1))
_TILE = (128, 16)  # plane-tile route: cells of x and rows of y per block
_TARGET_BLOCKS = 2048  # z is cut into chunks until about this many blocks

# the k-deep pass (csrc/bulk_pass_k.cu). Its plane route: bands of at
# most _DEEP_BAND interior columns (whole warps), _DEEP_PAD lanes each
# side of a band, _DEEP_STAGE staged halo columns each side, y segments
# of at most _DEEP_SEG rows, cut down to _DEEP_SEG_MIN rows until about
# _DEEP_BLOCKS blocks fill the card. Its bricks: _BRICK_THREADS threads
# a block, at most _BRICK_ELEMS staged elements a thread (a plane's
# fields: three for the upwind flux, one for the fleet twins), a reach
# of at most _BRICK_REACH an axis, two blocks an SM in _BRICK_SMEM
# bytes each (an SM's 228 KB, less the 1 KB the
# system keeps per block, halved), z segments of at least 16 planes
# until about _BRICK_BLOCKS blocks fill the card. A block may opt into
# _MAX_SMEM bytes of shared memory on sm_90.
_DEEP_BAND, _DEEP_PAD, _DEEP_STAGE, _DEEP_SEG = 256, 16, 8, 256
_DEEP_SEG_MIN, _DEEP_BLOCKS = 64, 1024
_MAX_SMEM = 232448
_BRICK_THREADS, _BRICK_ELEMS, _BRICK_REACH = 512, 8, 2
_BRICK_SMEM = (233472 - 2 * 1024) // 2
_BRICK_BLOCKS = 264
# the step loop takes the bricks only where they beat k one-step
# launches of the direct kernel on the card (PERF.md), by flux: the
# depths k taken, at least this many terms a cell and this many blocks;
# None: never. The upwind flux's face terms: 20 and 36 paid, 12 broke
# even, 4 and 5 lost; 128 blocks paid, 54 did not. diffuse's read
# slots: 124 paid at k = 2 from 54 blocks up (1.20-2.89), at k = 3 by
# 1.03-2.21, and lost at k = 4 (its tile cut to 16 x 4); 26 paid at
# 128^3 and lost from 256^3, 6 lost from 192^3. advect_x (1 or 2
# slots) won at 128^3 and lost from 256^3.
_BRICK_PAYS = {
    "upwind_xy": ((2,), 20, 128),
    "diffuse": ((2,), 124, 128),
    "advect_x": None,
}


def _brick_smem(w, h, k, rz, n, fields=3):
    """Shared memory of a brick block (csrc/bulk_pass_k.cu,
    ``brick_smem``): the input ring of ``fields`` fields and the levels'
    rings of a ``w`` x ``h`` window, the slot tables of ``n`` slots,
    the masks."""
    sk = max(rz, 1)
    rings = 4 * w * h * (fields * (k * sk + rz + 2)
                         + (k - 1) * (sk + rz + 1))
    return -(-rings // 16) * 16 + 16 * 2 * k * (n + 1) + 4 * (w + h)


class PassSpec:
    """Static geometry of one bulk step of device flux ``flux`` over a
    single-device closed-form plan: the port's counterpart of
    ``RollPassSpec`` (dccrg_tpu/ops/roll_executor.py:90). ``slots`` are
    the slots the flux reads (:func:`_flux_slots`), ``n_fields`` the
    fields it stages a cell.

    The upwind flux's face set (``face4``: the four x / y face slots in
    ``_FACE4`` order, the main path's) takes kernel A's plane tiles: a
    block owns a ``tile[0]`` x ``tile[1]`` (x, y) tile and marches
    ``tile[2]`` z-planes, each staged with its halo in a shared-memory
    ring of three planes while the next ones load. Any other set takes
    the direct kernel (a column of 8 z-planes a thread over the flux's
    slot table, neighbours read through the cache; ``tile`` is its 32 x
    8 block). :meth:`deep` states the k-deep
    pass's route and blocking, and the rule that declines it."""

    def __init__(self, shifts, dims, periodic, offs_cells, offs_const, n0,
                 L, flux="upwind_xy"):
        self.shifts = tuple(int(s) for s in shifts)
        self.dims = tuple(int(d) for d in dims)
        self.periodic = tuple(bool(p) for p in periodic)
        self.offs_cells = tuple(tuple(int(v) for v in o) for o in offs_cells)
        self.offs_const = tuple(tuple(int(v) for v in o) for o in offs_const)
        self.n0 = int(n0)
        self.L = int(L)
        self.flux = flux
        self.n_fields = len(DEVICE_FLUXES[flux][0])
        self.slots = _flux_slots(flux, self.offs_cells, self.offs_const)
        if len(self.slots) > _MAX_SLOTS:
            raise ValueError(f"{len(self.slots)} slots exceed {_MAX_SLOTS}")
        self.table = _SlotTables(_slot_rows(self.slots))
        self.face4 = (flux == "upwind_xy"
                      and tuple(s[1:] for s in self.slots) == _FACE4)
        nx, ny, nz = self.dims
        if self.face4:
            tiles = -(-nx // _TILE[0]) * -(-ny // _TILE[1])
            chunks = max(1, min(nz, -(-_TARGET_BLOCKS // tiles)))
            self.tile = (*_TILE, -(-nz // chunks))
        else:
            self.tile = (32, 8, 1)

    def reach(self):
        """Cells one step reads away from its cell, per axis, over the
        flux slots."""
        return tuple(max((abs(s[1 + d]) for s in self.slots), default=0)
                     for d in range(3))

    def deep(self, k):
        """The k-deep pass's ``(route, interior)`` for this slot set:
        None for ``k`` < 2 or > 8, and where the kernel declines the
        set. :meth:`deep_pays` says whether the step loop takes it.

        The face set takes ``"planes"``: a block owns one z-plane's band
        of ``bx`` interior columns (x cut into equal bands of at most
        256, rounded up to whole warps) and a y segment of ``by`` rows
        (y cut into equal segments of at most 256 rows, and of at least
        64 while fewer than about 1024 blocks would fill the card),
        ``bz`` = 1, and streams the k sub-steps through it as
        time-skewed levels. Any other set takes ``"bricks"``: a block
        owns a ``bx`` x ``by`` (x, y) tile with a halo of k reaches each
        side and a segment of ``bz`` z-planes, and streams the k
        sub-steps along z as time-skewed levels; the tile starts at 32 x
        32 (clipped to the grid) and is halved (y down to 4, then x down
        to 8) until its rings fit two blocks an SM and a staged plane
        (``n_fields`` fields) fits the threads' elements; z is cut into
        segments of at least 16 planes until about 264 blocks fill the
        card. A set with a
        reach above 2, or whose smallest tile does not fit, is declined.
        The C launcher checks the same bounds."""
        k = int(k)
        if not 2 <= k <= 8:
            return None
        if self.face4:
            nx, ny, nz = self.dims
            bands = -(-nx // _DEEP_BAND)
            band = -(-(-(-nx // bands)) // 32) * 32  # whole warps
            segs = max(-(-ny // _DEEP_SEG),
                       min(-(-ny // _DEEP_SEG_MIN),
                           -(-_DEEP_BLOCKS // (bands * nz))))
            return "planes", (band, -(-ny // segs), 1)
        rx, ry, rz = self.reach()
        if max(rx, ry, rz) > _BRICK_REACH:
            return None
        nx, ny, nz = self.dims
        n, nf = len(self.slots), self.n_fields

        def fits(b):
            w, h = b[0] + 2 * k * rx, b[1] + 2 * k * ry
            return (_brick_smem(w, h, k, rz, n, nf) <= _BRICK_SMEM
                    and nf * w * h <= _BRICK_THREADS * _BRICK_ELEMS)

        b = [min(32, nx), min(32, ny)]
        for axis, floor in ((1, 4), (0, 8)):
            while not fits(b) and b[axis] > floor:
                b[axis] = max(floor, b[axis] // 2)
        if not fits(b):
            return None
        tiles = -(-nx // b[0]) * -(-ny // b[1])
        segs = max(1, min(-(-nz // 16), -(-_BRICK_BLOCKS // tiles)))
        return "bricks", (b[0], b[1], -(-nz // segs))

    def terms(self):
        """Terms a cell of one step: the upwind flux's active face terms
        (a slot's nonzero face sign in x or y), a twin's read slots."""
        if self.flux == "upwind_xy":
            return sum((fx != 0) + (fy != 0) for *_, fx, fy in self.slots)
        return len(self.slots)

    def deep_pays(self, k):
        """Whether the step loop runs ``k``-deep passes: on the plane
        route always; on the bricks where they beat k one-step launches
        of the direct kernel, as measured on the card (PERF.md), by the
        flux's rule in ``_BRICK_PAYS``: the upwind flux at k = 2, with
        at least 20 face terms a cell (the 26-cube has 36) and at least
        128 blocks (from k = 3 the readings won and lost at neighbouring
        sizes, so the loop declines them). Elsewhere ``bulk_pass_k``
        still launches the bricks when called."""
        deep = self.deep(k)
        if deep is None:
            return False
        route, (bx, by, bz) = deep
        if route == "planes":
            return True
        rule = _BRICK_PAYS[self.flux]
        if rule is None:
            return False
        ks, min_terms, min_blocks = rule
        nx, ny, nz = self.dims
        blocks = -(-nx // bx) * -(-ny // by) * -(-nz // bz)
        return (k in ks and self.terms() >= min_terms
                and blocks >= min_blocks)

    def deep_cost(self, k, itemsize=4):
        """``(work, bytes)`` of one k-deep pass over this grid, each as a
        multiple of the least: thread-cells computed (idle lanes and
        recomputed halo included) per useful cell-step, and the device
        memory bytes the blocks read and write (each staged element read
        once a block) per the bound's ``bytes_moved``. None where
        :meth:`deep` is."""
        deep = self.deep(k)
        if deep is None:
            return None
        route, (bx, by, bz) = deep
        nx, ny, nz = self.dims
        nbx, nby, nbz = -(-nx // bx), -(-ny // by), -(-nz // bz)
        if route == "planes":
            # every segment of every band walks its rows plus 2k
            lanes = bx + 2 * _DEEP_PAD
            iters = ny + 2 * k * nby
            work = nbx * lanes * iters * k * nz
            read = 3 * nbx * (bx + 2 * _DEEP_STAGE) * iters * nz
        else:
            # level t computes its window less t reaches each side, over
            # the segment's planes and (k - t) reaches of z each side;
            # every input plane of the segment's halo is read once
            rx, ry, rz = self.reach()
            w, h = bx + 2 * k * rx, by + 2 * k * ry
            planes = nz + 2 * k * rz * nbz
            work = nbx * nby * sum(
                (w - 2 * t * rx) * (h - 2 * t * ry)
                * (planes - 2 * t * rz * nbz) for t in range(1, k + 1))
            read = self.n_fields * nbx * nby * w * h * planes
        cells = nx * ny * nz
        return (work / (cells * k),
                (read + cells) * itemsize / self.bytes_moved(itemsize))

    def bytes_moved(self, itemsize, n_in=None, n_out=1):
        """HBM bytes of one step, or of one k-deep pass, at the bound:
        each input (``n_fields`` by default) read once, each output
        written once."""
        n_in = self.n_fields if n_in is None else n_in
        return (n_in + n_out) * self.n0 * itemsize

    def flops(self, k=1):
        """Float operations of ``k`` steps (one k-deep pass), per cell.
        The upwind flux: each active face term (a slot's nonzero face
        sign in x or y) costs its face velocity and coefficient (add, 2
        multiplies, compare), static over a pass, then in every step its
        upwind product and its accumulate; each step ends in one add
        (the face set: 4 terms, 16 + 9k a cell). A twin: ``k`` times
        :func:`_flux_flops`."""
        if self.flux != "upwind_xy":
            return self.n0 * k * _flux_flops(self.flux, len(self.slots))
        terms = self.terms()
        return self.n0 * (4 * terms + k * (2 * terms + 1))


# ---------------------------------------------------------------------
# kernel A: the bulk pass
# ---------------------------------------------------------------------

_BULK_SIG = {
    "dccrg_bulk_upwind": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "dccrg_bulk_direct": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]),
    "dccrg_bulk_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _flux_coeffs(kernel, dt):
    """The flux's two float32 constants (csrc/fluxes.cuh ``Coef``): for
    the upwind flux ``dt * (1/dx)`` and ``dt * (1/dy)``, rounded as its
    ``dt * inv[d]`` rounds them; for a twin its extra (dt or cfl) in
    float32, and 0."""
    dt32 = np.float32(dt)
    if kernel.device_flux != "upwind_xy":
        return float(dt32), 0.0
    inv = kernel.device_params["inv"]
    return float(dt32 * np.float32(inv[0])), float(dt32 * np.float32(inv[1]))


def _plain_into(res, name, out):
    """A plain version's result, copied into ``out`` where one is
    given."""
    if out is None:
        return res
    out.copy_(res[name])
    return {name: out}


def _flux_inputs(fn, spec, kernel, fields):
    """The flux's input tensors, field 0 first, after checking that
    ``spec`` was built for the kernel's flux."""
    if spec.flux != kernel.device_flux:
        raise ValueError(f"{fn}: the spec is the {spec.flux} flux's, the "
                         f"kernel's is {kernel.device_flux}")
    return [fields[n] for n in DEVICE_FLUXES[spec.flux][0]]


def _cuda_operands(fn, spec, ins, out):
    """Check kernel A's operands for a launch of ``fn``: contiguous
    ``[L]`` CUDA tensors of one storage dtype, and ``out`` like them
    and apart from them (a new one where None). Returns ``(storage
    code, out)``."""
    rho = ins[0]
    if rho.device.type != "cuda":
        raise ValueError(f"{fn} runs on CUDA or CPU, got {rho.device}")
    for t in ins:
        if (t.device != rho.device or t.dtype != rho.dtype
                or t.shape != (spec.L,) or not t.is_contiguous()):
            raise ValueError(f"{fn} needs contiguous [L] tensors of one "
                             f"dtype on one device")
    code = _STORAGE_CODES.get(rho.dtype)
    if code is None:
        raise ValueError(f"{fn} storage must be float32 or bfloat16, got "
                         f"{rho.dtype}")
    if out is None:
        return code, torch.empty_like(rho)
    if (out.device != rho.device or out.dtype != rho.dtype
            or out.shape != (spec.L,) or not out.is_contiguous()
            or any(out.data_ptr() == t.data_ptr() for t in ins)):
        raise ValueError(f"{fn} out must be a contiguous [L] tensor like "
                         f"the fields and apart from them")
    return code, out


def _field_ptrs(ins):
    """The fields' device pointers as the C entry points take them."""
    return (ctypes.c_void_p * 3)(*[t.data_ptr() for t in ins],
                                 *([None] * (3 - len(ins))))


def bulk_pass(spec, kernel, fields, extras, out=None):
    """One step of ``kernel``'s device flux over all ``[L]`` rows of
    ``fields`` (name -> tensor, the flux's input fields; ``spec`` built
    for that flux). Returns ``{out field: [L] tensor}`` in the storage
    dtype; pad rows keep their values. On CUDA tensors it is one launch
    of kernel A (csrc/bulk_pass.cu: the upwind face set's plane tiles,
    every other flux and set the direct kernel over ``spec``'s slot
    table), counted in ``bulk_pass.launches``; on CPU tensors it runs
    :func:`bulk_pass_plain`. ``out``, an ``[L]`` tensor apart from the
    fields, takes the result in place of a new one. ``extras[0]`` (dt,
    or a twin's cfl) is read on the host: the step loop hands it over
    as a CPU tensor, so the launch waits on nothing on the device."""
    names_out = DEVICE_FLUXES[kernel.device_flux][1]
    ins = _flux_inputs("bulk_pass", spec, kernel, fields)
    rho = ins[0]
    if rho.device.type == "cpu":
        return _plain_into(bulk_pass_plain(spec, kernel, fields, extras),
                           names_out[0], out)
    code, out = _cuda_operands("bulk_pass", spec, ins, out)
    lib = _build.load("bulk_pass", _BULK_SIG)
    nx, ny, nz = spec.dims
    # the plane tiles take the tile, the direct kernel the table's reach
    geom = (ctypes.c_int * 9)(nx, ny, nz, *(int(p) for p in spec.periodic),
                              *(spec.tile if spec.face4 else spec.reach()))
    c0, c1 = _flux_coeffs(kernel, float(extras[0]))
    dev = rho.device.index or 0
    stream = torch.cuda.current_stream(rho.device).cuda_stream
    if spec.face4:
        flat = [v for s in spec.slots for v in s[1:]]
        slots = (ctypes.c_int * len(flat))(*flat)
        rc = lib.dccrg_bulk_upwind(
            code, *(t.data_ptr() for t in ins), out.data_ptr(), geom, slots,
            len(spec.slots), c0, c1, dev, stream)
    else:
        rc = lib.dccrg_bulk_direct(
            code, DEVICE_FLUXES[spec.flux][2], _field_ptrs(ins),
            out.data_ptr(), geom, spec.table.on(rho.device).data_ptr(),
            len(spec.slots), c0, c1, dev, stream)
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
    names_out = DEVICE_FLUXES[kernel.device_flux][1]
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
# kernel A's k-deep pass
# ---------------------------------------------------------------------

_BULK_K_SIG = {
    "dccrg_bulk_upwind_k": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "dccrg_bulk_bricks": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "dccrg_bulk_k_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def bulk_pass_k(spec, kernel, fields, extras, k, out=None):
    """``k`` steps of ``kernel``'s device flux in one pass: the same
    contract as :func:`bulk_pass`, the carried field rounded to its
    storage dtype after every sub-step. On CUDA tensors it is one
    launch of kernel A's k-deep pass (csrc/bulk_pass_k.cu) on the route
    ``spec.deep(k)`` names, counted in ``bulk_pass_k.launches``; a
    ``k`` the rule declines raises ValueError, as does a failed build
    or launch (RuntimeError). On CPU tensors it runs
    :func:`bulk_pass_k_plain`. ``out`` must not alias an input."""
    names_out = DEVICE_FLUXES[kernel.device_flux][1]
    ins = _flux_inputs("bulk_pass_k", spec, kernel, fields)
    rho = ins[0]
    if rho.device.type == "cpu":
        return _plain_into(bulk_pass_k_plain(spec, kernel, fields, extras, k),
                           names_out[0], out)
    deep = spec.deep(k)
    if deep is None:
        raise ValueError(f"the k-deep pass declines k={k} for slots "
                         f"{[s[1:4] for s in spec.slots]}")
    code, out = _cuda_operands("bulk_pass_k", spec, ins, out)
    lib = _build.load("bulk_pass_k", _BULK_K_SIG)
    route, interior = deep
    geom = (ctypes.c_int * 13)(*spec.dims, *(int(p) for p in spec.periodic),
                               int(k), *interior, *spec.reach())
    c0, c1 = _flux_coeffs(kernel, float(extras[0]))
    dev = rho.device.index or 0
    stream = torch.cuda.current_stream(rho.device).cuda_stream
    if route == "planes":
        flat = [v for s in spec.slots for v in s[1:]]
        slots = (ctypes.c_int * len(flat))(*flat)
        rc = lib.dccrg_bulk_upwind_k(
            code, *(t.data_ptr() for t in ins), out.data_ptr(), geom, slots,
            len(spec.slots), c0, c1, dev, stream)
    else:
        rc = lib.dccrg_bulk_bricks(
            code, DEVICE_FLUXES[spec.flux][2], _field_ptrs(ins),
            out.data_ptr(), geom, spec.table.host(),
            spec.table.on(rho.device).data_ptr(), len(spec.slots), c0, c1,
            dev, stream)
    _build.check(lib, "dccrg_bulk_k", rc)
    bulk_pass_k.launches += 1
    if spec.L > spec.n0:
        out[spec.n0:] = rho[spec.n0:]
    return {names_out[0]: out}


bulk_pass_k.launches = 0


def bulk_pass_k_plain(spec, kernel, fields, extras, k):
    """The plain PyTorch version of the k-deep pass: ``k`` applications
    of :func:`bulk_pass_plain`, each rounded to the storage dtype."""
    names_out = DEVICE_FLUXES[kernel.device_flux][1]
    cur = dict(fields)
    for _ in range(int(k)):
        cur.update(bulk_pass_plain(spec, kernel, cur, extras))
    return {f: cur[f] for f in names_out}


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

def _grid_spec_for(grid, hood, flux="upwind_xy"):
    """PassSpec of device flux ``flux`` for a grid's hood, or None when
    the bulk executor cannot express the plan (the caller takes the
    plain roll path)."""
    cf = hood.closed_form
    if cf is None or cf.get("multi") or grid.n_dev != 1:
        return None
    roll = hood.roll_plan(grid.plan.L)
    if roll is None:
        return None
    try:
        return PassSpec(roll[0], cf["dims"], cf["periodic"], cf["offsets"],
                        hood.offs_const, cf["n0"], int(grid.plan.L), flux)
    except ValueError:
        return None


def _eligible_fields(grid, kernel, fields_in, fields_out):
    if not isinstance(kernel, SlotwiseKernel):
        return False
    flux = DEVICE_FLUXES.get(getattr(kernel, "device_flux", None))
    if flux is None:
        return False
    names_in, names_out, _code = flux
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
    single-device closed-form plan: with ``k`` = :func:`bulk_steps_per_pass`
    (read here, and part of the program's key), ``n_steps // k``
    k-deep passes and then ``n_steps % k`` one-step launches of kernel
    A (``n_steps`` one-step launches at k = 1, or where
    ``spec.deep_pays(k)`` is false), and nothing else on the device.
    Same ``(fn, tables, static_in)`` contract (no tables),
    ``fn.step_path == "bulk"``; returns None when ineligible."""
    fields_in = tuple(fields_in)
    fields_out = tuple(fields_out)
    if not _eligible_fields(grid, kernel, fields_in, fields_out):
        return None
    hood = grid.plan.hoods[neighborhood_id]
    if hood.offs_const is None:
        return None
    spec = _grid_spec_for(grid, hood, kernel.device_flux)
    if spec is None:
        return None
    k = bulk_steps_per_pass()
    deep = spec.deep_pays(k)
    L, R = grid.plan.L, grid.plan.R
    static_in = tuple(f for f in fields_in if f not in fields_out)
    key = ("bulksteploop", kernel, fields_in, fields_out, n_extra, L, R,
           spec.shifts, spec.dims, spec.periodic, k)
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
        # k-deep passes, then the one-step remainder (the reference's
        # order, dccrg_tpu/ops/roll_executor.py:685-694)
        passes, rem = divmod(n_steps, k) if deep else (0, n_steps)
        # the flux writes one field; the last launch writes the new
        # state's rows in place, and only the rows past L are copied
        (f_out,), (a_out,) = fields_out, outs_full
        new = torch.empty_like(a_out)
        state = {f_out: a_out[0, :L]}
        for i in range(passes + rem):
            full = dict(statics)
            full.update(state)
            ins = {f: full[f] for f in fields_in}
            out = new[0, :L] if i + 1 == passes + rem else None
            if i < passes:
                state = bulk_pass_k(spec, kernel, ins, extras, k, out=out)
            else:
                state = bulk_pass(spec, kernel, ins, extras, out=out)
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

# the device fluxes kernel A' computes: the single-field twins
# fleet._make_diffuse_slotwise / _make_advect_x_slotwise
FLEET_FLUXES = {name: DEVICE_FLUXES[name] for name in ("diffuse", "advect_x")}

_FLEET_SIG = {
    "dccrg_fleet_bulk": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
    "dccrg_fleet_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}

# kernel A''s routes, by the code its entry point takes: on the
# 26-cube the plane route stages z-planes of a y band in shared memory
# (x extents up to 256 that are a whole number of 16-byte chunks) and
# the direct route reads neighbours through the cache; any other
# neighbourhood takes the slot-table route
FLEET_ROUTES = ("planes", "direct", "slots")
_MAX_PLANE_X = 256


# the slots kernel A' unrolls: the 3x3x3 cube without its centre,
# z-major and x fastest, the default neighbourhood of length 1
_CUBE = tuple((x, y, z) for z in (-1, 0, 1) for y in (-1, 0, 1)
              for x in (-1, 0, 1) if (x, y, z) != (0, 0, 0))


class FleetPassSpec:
    """Static geometry of kernel A' over one bucket's single-device
    closed-form plan: grid extents and periodicity and the slots' cell
    offsets in ``offs_const`` order. ``cube``: the 26 slots of the
    default neighbourhood of length 1 in that order, which kernel A'
    unrolls; any other neighbourhood (lengths 0 and 2) takes its
    slot-table route over the slots a flux reads
    (:meth:`slot_table`)."""

    def __init__(self, dims, periodic, offs_cells, offs_const, n0, L):
        self.dims = tuple(int(d) for d in dims)
        self.periodic = tuple(bool(p) for p in periodic)
        self.offs_cells = tuple(tuple(int(v) for v in o) for o in offs_cells)
        self.offs_const = tuple(tuple(int(v) for v in o) for o in offs_const)
        self.n0 = int(n0)
        self.L = int(L)
        self.R = self.L + 1
        signs = tuple(tuple(int(np.sign(v)) for v in o) for o in self.offs_const)
        self.cube = self.offs_cells == _CUBE and signs == _CUBE
        self._tables = {}

    def slot_table(self, flux):
        """The slot-table route's table of ``flux``: the slots it reads
        (:func:`_flux_slots`) in ``offs_const`` order."""
        t = self._tables.get(flux)
        if t is None:
            t = _SlotTables(_slot_rows(
                _flux_slots(flux, self.offs_cells, self.offs_const)))
            self._tables[flux] = t
        return t

    def bytes_moved(self, batch, itemsize):
        """HBM bytes of one pass at the bound: every slot's rows read
        once and written once."""
        return 2 * batch * self.R * itemsize

    def flops(self, batch, flux):
        """Float operations of one pass: :func:`_flux_flops` over the
        slots ``flux`` reads, a cell."""
        return batch * self.n0 * _flux_flops(
            flux, len(self.slot_table(flux).rows))


def fleet_route(spec, state):
    """The route kernel A' takes for ``spec`` over ``state``: off the
    26-cube ``"slots"``; on it ``"planes"`` where the x extent is at
    most 256 and a multiple of 16 bytes' elements (4 float32, 8
    bfloat16), the row stride fits 32 bits and the allocation is
    16-byte aligned, else ``"direct"``. The kernel's entry point checks
    the same rule."""
    if not spec.cube:
        return FLEET_ROUTES[2]
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
    table, n_slots = None, 0
    if route == 2:
        tab = spec.slot_table(kernel.device_flux)
        table, n_slots = tab.on(state.device).data_ptr(), len(tab.rows)
    rc = lib.dccrg_fleet_bulk(
        code, flux, route, state.data_ptr(), out.data_ptr(),
        extras.data_ptr(), None if budget is None else budget.data_ptr(),
        int(i), geom, spec.n0, spec.L, spec.R, table, n_slots,
        state.device.index or 0,
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
    spec = FleetPassSpec(cf["dims"], cf["periodic"], cf["offsets"],
                         hood.offs_const, cf["n0"], grid.plan.L)
    if len(spec.offs_cells) > _MAX_SLOTS:
        return None
    name_out = names_out[0]

    def step(state, extras, budget, i):
        new = dict(state)
        new[name_out] = fleet_bulk_pass(spec, kernel, state[names_in[0]],
                                        extras, budget, i)
        return new

    step.spec = spec
    return step
