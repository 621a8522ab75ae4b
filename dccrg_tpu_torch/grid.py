"""The grid runtime: single-device slice of the PyTorch port.

PyTorch counterpart of ``dccrg_tpu/grid.py`` for one device:

- **Structure is host state**: the sorted cell list, owners and the
  neighbor plan are numpy arrays. A complete level-0 grid gets the
  closed-form plan (uniform.py; ``DCCRG_FORCE_TABLES=1`` gives it dense
  tables instead), a refined grid the hybrid plan (hybrid.py;
  ``DCCRG_FORCE_GENERIC=1`` the generic builder below), with the
  reference's dispatch order and capacity names, so ``L``, ``R``, rows
  and tables come out as the reference's.
- **Data is device state**: each per-cell field is one tensor of shape
  ``[n_dev, R, ...]`` with ``n_dev = 1`` and ``R = L + 1``; rows
  ``n_local..L`` are capacity padding and row ``R - 1`` is the
  permanent zero row.
- **Stencils**: on a closed-form plan an eligible step loop goes
  through the bulk executor (ops/roll_executor.py, a CUDA kernel on the
  card); everything else gathers neighbors slot by slot with exact 3-D
  ``torch.roll``s (closed-form plans) or by index from the dense
  ``[L, S]`` tables (``index_select`` on the field, masked slots read
  the zero row). Hybrid plans run the kernel again over their compact
  hard-row tables and write those rows over the bulk result.
- **AMR**: ``refine_completely`` and friends queue requests,
  ``stop_refining`` resolves them (amr.py), rebuilds the plan and moves
  the surviving cells' rows on the device.

The halo exchange and multi-device plans belong to later slices of the
port.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field as dataclass_field

import numpy as np
import torch

from . import faults, resilience, telemetry
from .geometry import CartesianGeometry, NoGeometry, StretchedCartesianGeometry
from .mapping import Mapping
from .neighbors import (build_neighbor_lists, find_neighbors_of,
                        find_neighbors_to_subset, make_neighborhood,
                        validate_neighborhood, verify_tiling)
from .topology import GridTopology
from .types import ERROR_CELL
from . import uniform as uniform_mod

# Parity with the reference's default neighborhood id (dccrg.hpp:99).
DEFAULT_NEIGHBORHOOD_ID = -0xDCC


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host numpy array (bfloat16 widened to
    float32, which is exact)."""
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    asks for another one. Raises when CUDA is asked for (explicitly or
    by default) and no GPU is present — there is no silent CPU
    fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a name ('float32',
    'bfloat16') or a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a dtype: {dtype!r}")
    return out


def bucket_capacity(n: int) -> int:
    """Round a capacity up to a quarter-power-of-two bucket (16, 20,
    24, 28, 32, 40, ...). Waste is bounded at 25%; the same buckets as
    the reference package, so both lay out ``L`` identically."""
    n = int(n)
    if n <= 16:
        return 16
    step = 1 << max(max(n - 1, 1).bit_length() - 3, 0)
    return ((n + step - 1) // step) * step


def _synth_key(cf):
    """Static cache-key component for a closed-form plan (None when
    the plan has dense tables)."""
    if cf is None:
        return None
    return (cf["dims"], cf["periodic"], cf["n0"],
            tuple(map(tuple, cf["offsets"])), bool(cf.get("multi")))


def _synth_prep(synth, L, device):
    """(grid index, base validity) per row for closed-form mask
    synthesis on a single-device plan (rows ARE grid order)."""
    n0_ = synth[2]
    gidx = torch.arange(L, dtype=torch.int32, device=device)
    if L > n0_:
        base_valid = gidx < n0_
    else:
        base_valid = torch.ones(L, dtype=torch.bool, device=device)
    return gidx, base_valid


def _synth_col(synth, gidx, base_valid, j):
    """One [L] validity column of the closed-form mask (stencil slot
    ``j``): a slot is invalid where it steps across a non-periodic
    edge, and on pad rows."""
    (nx_, ny_, nz_), per_, _n0, offs_cells, *_ = synth
    ox, oy, oz = offs_cells[j]
    v = base_valid
    for axis, o, nd, per in ((0, ox, nx_, per_[0]), (1, oy, ny_, per_[1]),
                             (2, oz, nz_, per_[2])):
        if o != 0 and not per:
            if axis == 0:
                coord = gidx % nx_
            elif axis == 1:
                coord = (gidx // nx_) % ny_
            else:
                coord = gidx // (nx_ * ny_)
            t = coord + o
            v = v & (t >= 0) & (t < nd)
    return v


def _synth_mask(synth, L, device):
    """Closed-form [L, S] validity mask (stack of _synth_col)."""
    gidx, base_valid = _synth_prep(synth, L, device)
    offs_cells = synth[3]
    return torch.stack(
        [_synth_col(synth, gidx, base_valid, j)
         for j in range(len(offs_cells))], dim=1)


def _make_roll3d_gather(synth, L, lead=0):
    """Single-device closed-form slot gather: view the flat field as
    the 3-D grid and ``torch.roll`` it — exact periodic wraps, no
    scatter. Non-periodic wraps carry junk and are zeroed through the
    slot mask. ``lead`` batch dimensions (a fleet's slots) may come
    before the row dimension."""
    (nx, ny, nz), _per, n0, offs_cells, *_ = synth

    def gather(fl, j, mask_j):
        ox, oy, oz = offs_cells[j]
        pre, rest = tuple(fl.shape[:lead]), tuple(fl.shape[lead + 1:])
        g3 = fl[(slice(None),) * lead + (slice(0, n0),)].reshape(
            pre + (nz, ny, nx) + rest)
        g3 = torch.roll(g3, shifts=(-oz, -oy, -ox),
                        dims=(lead, lead + 1, lead + 2))
        col = g3.reshape(pre + (n0,) + rest)
        if L > n0:
            col = torch.cat([col, col.new_zeros(pre + (L - n0,) + rest)],
                            dim=lead)
        mexp = mask_j.reshape(tuple(mask_j.shape) + (1,) * len(rest))
        return torch.where(mexp, col, col.new_zeros(()))

    return gather


class _GatheredNeighbors(dict):
    """``[L, S, ...]`` neighbor stacks of the stencil's input fields,
    gathered on first access: PyTorch runs eagerly, so a field the kernel
    never reads from its neighbors is never gathered (the reference's
    compiler drops those gathers the same way). ``gather_all(fl)`` makes
    one field's stack."""

    def __init__(self, fields, gather_all):
        super().__init__()
        self._fields = fields
        self._gather_all = gather_all

    def __missing__(self, name):
        st = self._gather_all(self._fields[name])
        self[name] = st
        return st

    def __contains__(self, name):
        return name in self._fields


def _roll3d_gather_all(gather, nmask, n_slots):
    """Dense ``[L, S, ...]`` stack from a closed-form slot gather."""
    return lambda fl: torch.stack(
        [gather(fl, j, nmask[:, j]) for j in range(n_slots)], dim=1)


def _table_gather_all(nrows):
    """Dense ``[L, S, ...]`` gather by index from an ``[L, S]`` table
    (masked slots point at the zero row ``R - 1``)."""
    def gather(fl):
        g = fl.index_select(0, nrows.reshape(-1))
        return g.reshape(tuple(nrows.shape) + tuple(fl.shape[1:]))

    return gather


def _table_slot_gather(nrows_t):
    """Column-``j`` gather from a slot-major ``[S, L]`` table: the raw
    gathered values, like the dense table path (masked slots read the
    zero row; kernels gate on the mask either way)."""
    return lambda fl, j, mask_j: fl.index_select(0, nrows_t[j])


def _make_offs_col(uniform_offs, noffs, sc0):
    """Per-slot offsets closure: raw (NOT premasked — kernels gate on
    the mask), ``[3]`` for uniform plans, ``[L, 3]`` when scaled
    (``sc0`` is the per-row size factor) or table-driven."""
    if uniform_offs:
        if sc0 is not None:
            return lambda j: noffs[j][None, :] * sc0[:, None]
        return lambda j: noffs[j]
    return lambda j: noffs[:, j]


def _run_slotwise(kernel, cell_fields, fields, gather, offs_col, mask_col,
                  n_slots, extra):
    """The one slot loop every slot-wise call site shares:
    init -> slot per stencil leg -> finish. ``fields`` maps name ->
    backing tensor, ``gather(arr, j, mask_j)`` produces slot j's
    neighbor column. PyTorch runs eagerly, so each slot's gathered
    columns are freed before the next slot's are made."""
    carry = kernel.init(cell_fields, *extra)
    for j in range(n_slots):
        mj = mask_col(j)
        nbr_j = {n: gather(v, j, mj) for n, v in fields.items()}
        carry = kernel.slot(carry, cell_fields, nbr_j, offs_col(j), mj,
                            *extra)
    return kernel.finish(carry, cell_fields, *extra)


def _as_extra(extra_args):
    """Stencil extras as tensors: Python numbers become float32, as the
    reference's weakly typed scalars do."""
    return tuple(e if isinstance(e, torch.Tensor)
                 else torch.as_tensor(e, dtype=torch.float32)
                 for e in extra_args)


def _make_pass(spec, tabs, L, fields_out):
    """``run(kernel, cell_fields, flat, extra) -> result`` for one
    stencil pass (see Grid._pass_tables for ``spec`` and the order of
    ``tabs``): the bulk pass over the dense or closed-form plan, then
    on a split plan the kernel over the hard rows, their results
    written over the bulk result's rows (the reference's merge order,
    dccrg_tpu/grid.py:2882-2893). Per-call setup (masks, premasked
    offsets) is made here, once per call."""
    kind, synth, uniform_offs, scaled, split, include_to, slotwise = spec
    tabs = list(tabs)
    if kind == "closed":
        offs_dev = tabs.pop(0)
        device = offs_dev.device
        n_slots = len(synth[3])
        roll = _make_roll3d_gather(synth, L)
        if slotwise:
            sgidx, sbase = _synth_prep(synth, L, device)
            masks = [_synth_col(synth, sgidx, sbase, j) for j in range(n_slots)]
            slot_gather, mask_col = roll, masks.__getitem__
        else:
            nmask = _synth_mask(synth, L, device)
            gather_all = _roll3d_gather_all(roll, nmask, n_slots)
        noffs = offs_dev
    else:
        nrows, noffs, nmask = tabs[:3]
        del tabs[:3]
        if slotwise:  # slot-major [S, L] rows and mask
            n_slots = nrows.shape[0]
            slot_gather = _table_slot_gather(nrows)
            mask_col = nmask.__getitem__
        else:
            gather_all = _table_gather_all(nrows)
    sc0 = tabs.pop(0) if scaled else None
    if split:
        hr, hnr, hof, hm = tabs[:4]
        del tabs[:4]
        h_gather = _table_gather_all(hnr)
    if include_to:
        trows, toffs, tmask = tabs[:3]
    if slotwise:
        offs_col = _make_offs_col(uniform_offs, noffs, sc0)
    elif uniform_offs:
        # per-slot constant offsets premasked (and scaled per row)
        noffs = nmask[:, :, None] * noffs[None, :, :]
        if scaled:
            noffs = noffs * sc0[:, None, None]

    def run(kernel, cell_fields, flat, extra):
        if slotwise:
            result = _run_slotwise(kernel, cell_fields, flat, slot_gather,
                                   offs_col, mask_col, n_slots, extra)
        else:
            nbr = _GatheredNeighbors(flat, gather_all)
            if include_to:
                to_nbr = _GatheredNeighbors(flat, _table_gather_all(trows))
                result = kernel(cell_fields, nbr, noffs, nmask, to_nbr,
                                toffs, tmask, *extra)
            else:
                result = kernel(cell_fields, nbr, noffs, nmask, *extra)
        if split:
            # second pass over the hard rows (near refinement) with
            # their own, wider tables; results overwrite those rows
            h_cell = {n: v.index_select(0, hr) for n, v in cell_fields.items()}
            h_nbr = {n: h_gather(v) for n, v in flat.items()}
            h_result = kernel(h_cell, h_nbr, hof, hm, *extra)
            result = dict(result)
            for n in fields_out:
                result[n] = result[n].index_put(
                    (hr,), h_result[n].to(result[n].dtype))
        return result

    return run


class SlotwiseKernel:
    """Memory-lean stencil kernel fed one neighbor slot at a time.
    Three callables:

    - ``init(cell_fields, *extra) -> carry``
    - ``slot(carry, cell_fields, nbr_j, offs_j, mask_j, *extra) ->
      carry`` — ``nbr_j[name]`` is ``[L, ...]`` (slot j's neighbor
      values), ``offs_j`` is ``[3]`` / ``[L, 3]`` and is NOT
      pre-masked (gate on ``mask_j``, shape ``[L]``)
    - ``finish(carry, cell_fields, *extra) -> {name: [L, ...]}``

    ``device_flux`` names the compile-time CUDA flux functor that
    computes the same function (ops/roll_executor.py, csrc/bulk_pass.cu);
    ``device_params`` holds its constants. A kernel without one always
    takes the plain roll path."""

    def __init__(self, init, slot, finish, device_flux=None,
                 device_params=None):
        self.init = init
        self.slot = slot
        self.finish = finish
        self.device_flux = device_flux
        self.device_params = device_params

    def __call__(self, cell_fields, nbr_fields, offs, mask, *extra):
        """The kernel as a plain dense kernel (slots looped over axis
        1), for the surface-sized hard-row pass of a hybrid plan."""
        return _run_slotwise(
            self, cell_fields, nbr_fields,
            lambda v, j, mj: v[:, j],
            (lambda j: offs[:, j]) if offs.dim() == 3 else
            (lambda j: offs[j]),
            lambda j: mask[..., j], mask.shape[-1], extra)


class _HoodPlan:
    """Per-neighborhood static tables (one structure epoch).

    The dense gather tables, the flat neighbor lists and the
    neighbors_to tables may be zero-arg callables, built on first
    access: a closed-form plan's tables are ONE thunk returning
    ``(rows, mask)``, materialized only if a host path asks."""

    def __init__(self, offsets, nbr_rows, nbr_offs, nbr_mask, n_inner=None,
                 offs_const=None, closed_form=None, pair_compact=None,
                 lists=None, to_tables=None, hard_rows=None,
                 hard_nbr_rows=None, hard_offs=None, hard_mask=None,
                 scale_rows=None):
        self.offsets = offsets  # [K, 3] neighborhood items
        self._nbr_rows = nbr_rows  # [n_dev, L, S] int32 (pad: zero row), or thunk
        self._nbr_offs = nbr_offs  # [n_dev, L, S, 3] int32, or thunk
        self._nbr_mask = nbr_mask  # [n_dev, L, S] bool, or thunk
        # closed-form single-device plans: the mask is synthesized from
        # the row index and the roll shifts arithmetically (dict with
        # dims/periodic/offsets/n0)
        self.closed_form = closed_form
        # per-slot constant offsets [S, 3] int32 (index units, or cell
        # units times scale_rows on hybrid plans), or None
        self.offs_const = offs_const
        # hybrid plans: cells near refinement get their own compact
        # tables, and the kernel runs a second pass over just them
        self.hard_rows = hard_rows  # [n_dev, H] int32 (pad: L) or None
        self.hard_nbr_rows = hard_nbr_rows  # [n_dev, H, Sh] int32
        self.hard_offs = hard_offs  # [n_dev, H, Sh, 3] int32
        self.hard_mask = hard_mask  # [n_dev, H, Sh] bool
        # hybrid plans: per-row cell size (index units), far/easy rows
        self.scale_rows = scale_rows  # [n_dev, L] int32 or None
        self._pair_compact = pair_compact
        self._send_rows = self._recv_rows = None
        self._lists = lists  # NeighborLists, or a thunk building them
        self._to = to_tables  # (rows, offs, mask), or a thunk
        self.n_inner = n_inner  # [n_dev] rows [0, n_inner) have no remote deps
        self._roll_plan = None  # computed on demand by roll_plan()
        self._dev = {}  # memoized device uploads

    @property
    def pair_compact(self):
        return self._pair_compact

    def _dense_pairs(self):
        if self._send_rows is None:
            self._send_rows, self._recv_rows = uniform_mod.dense_pair_tables(
                self._pair_compact)
        return self._send_rows, self._recv_rows

    @property
    def send_rows(self):  # [n_dev(src), n_dev(dst), M] int32, -1 pad
        return self._dense_pairs()[0]

    @property
    def recv_rows(self):  # [n_dev(dst), n_dev(src), M] int32, -1 pad
        return self._dense_pairs()[1]

    @property
    def lists(self):
        """The flat neighbors_of / neighbors_to lists of the epoch
        (neighbors.NeighborLists), built on first access."""
        if callable(self._lists):
            self._lists = self._lists()
        return self._lists

    @property
    def nbr_offs(self):
        if callable(self._nbr_offs):
            self._nbr_offs = self._nbr_offs()
        return self._nbr_offs

    @property
    def nbr_rows(self):
        if callable(self._nbr_rows):
            self._nbr_rows, self._nbr_mask = self._nbr_rows()
        return self._nbr_rows

    @property
    def nbr_mask(self):
        if callable(self._nbr_mask):
            self._nbr_rows, self._nbr_mask = self._nbr_mask()
        return self._nbr_mask

    def _to_tables(self):
        if callable(self._to):
            self._to = self._to()
        return self._to

    @property
    def to_rows(self):  # [n_dev, L, T] int32 neighbors_to gather table
        return self._to_tables()[0]

    @property
    def to_offs(self):  # [n_dev, L, T, 3] int32
        return self._to_tables()[1]

    @property
    def to_mask(self):  # [n_dev, L, T] bool
        return self._to_tables()[2]

    def merged_of_tables(self, pad_row):
        """Dense ``[n_dev, L, S]`` (rows, offs, mask) merging the far and
        hard pieces of a split-table plan (the include_to path and the
        introspection view); plain plans return their own arrays.
        ``pad_row`` is the zero row index (``plan.R - 1``)."""
        if self.hard_nbr_rows is None:
            return (np.asarray(self.nbr_rows), np.asarray(self.nbr_offs),
                    np.asarray(self.nbr_mask))
        n_dev, L, k = self.nbr_rows.shape
        Sh = self.hard_nbr_rows.shape[2]
        S = max(k, Sh)
        rows = np.full((n_dev, L, S), pad_row, dtype=np.int32)
        offs = np.zeros((n_dev, L, S, 3), dtype=np.int32)
        mask = np.zeros((n_dev, L, S), dtype=bool)
        rows[:, :, :k] = self.nbr_rows
        mask[:, :, :k] = self.nbr_mask
        offs[:, :, :k] = (self.nbr_mask[..., None]
                          * np.asarray(self.offs_const)[None, None, :, :])
        if self.scale_rows is not None:
            offs[:, :, :k] *= np.asarray(self.scale_rows)[:, :, None, None]
        for d in range(n_dev):
            hr = np.asarray(self.hard_rows[d])
            real = hr < L
            # hard rows have no far entries: overwrite the full row
            rows[d, hr[real]] = pad_row
            mask[d, hr[real]] = False
            offs[d, hr[real]] = 0
            rows[d, hr[real], :Sh] = self.hard_nbr_rows[d, real]
            mask[d, hr[real], :Sh] = self.hard_mask[d, real]
            offs[d, hr[real], :Sh] = self.hard_offs[d, real]
        return rows, offs, mask

    def dev(self, name, host_array, device):
        """Memoized upload of a named host table to ``device`` (a thunk
        is called on a miss)."""
        key = (name, str(device))
        hit = self._dev.get(key)
        if hit is None:
            if callable(host_array):
                host_array = host_array()
            hit = torch.as_tensor(np.ascontiguousarray(host_array),
                                  device=device)
            self._dev[key] = hit
        return hit

    def roll_plan(self, L: int, cap=bucket_capacity):
        """Affine decomposition of the of-gather: ``(shifts [S],
        wrong_rows [n_dev, S, W], wrong_src [n_dev, S, W])`` — every
        masked slot entry satisfies ``row == r + shift_j`` except the
        wrong rows — or None when the tables are not affine enough.
        Closed-form plans have it preset; otherwise computed once from
        the dense tables (cached)."""
        if self._roll_plan is not None:
            return self._roll_plan if self._roll_plan != () else None
        rows = np.asarray(self.nbr_rows, dtype=np.int64)
        mask = np.asarray(self.nbr_mask)
        n_dev, Lr, S = rows.shape
        base = np.arange(Lr, dtype=np.int64)[None, :]
        shifts = np.zeros(S, dtype=np.int64)
        wrong_sets = []
        n_masked = n_wrong = 0
        for j in range(S):
            mj = mask[:, :, j]
            dj = rows[:, :, j] - base
            local = rows[:, :, j] < L  # rolls only cover local rows
            dm = dj[mj & local]
            if len(dm):
                vals, counts = np.unique(dm, return_counts=True)
                shifts[j] = vals[np.argmax(counts)]
            wrong = mj & ((dj != shifts[j]) | ~local)
            n_masked += int(mj.sum())
            n_wrong += int(wrong.sum())
            wrong_sets.append([np.nonzero(wrong[d])[0] for d in range(n_dev)])
        if n_masked == 0 or n_wrong / n_masked > 0.25:
            self._roll_plan = ()
            return None
        W = cap(max(1, max(len(w) for per in wrong_sets for w in per)))
        wrong_rows = np.full((n_dev, S, W), L, dtype=np.int32)  # pad: dropped
        wrong_src = np.zeros((n_dev, S, W), dtype=np.int32)
        for j, per in enumerate(wrong_sets):
            for d, w in enumerate(per):
                wrong_rows[d, j, : len(w)] = w
                wrong_src[d, j, : len(w)] = rows[d, w, j]
        self._roll_plan = (shifts, wrong_rows, wrong_src)
        return self._roll_plan


@dataclass
class _Plan:
    """Full structure epoch: row layout + per-neighborhood tables."""

    cells: np.ndarray  # sorted uint64, all cells
    owner: np.ndarray  # int32 per cell
    n_dev: int
    L: int  # local-row capacity
    R: int  # total rows per device (L + 1 zero row)
    n_local: np.ndarray  # [n_dev]
    local_ids: list  # per device: uint64 ids in row order
    row_of_pos: np.ndarray  # int32 [n_cells]: row on the owner device
    ghost_ids: list  # per device: uint64 ids in ghost-row order (empty)
    hoods: dict = dataclass_field(default_factory=dict)  # hood id -> _HoodPlan
    epoch: int = 0


class Grid:
    """Cartesian cell-refinable grid, one device.

    Mirrors the reference's fluent construction protocol
    (dccrg.hpp:8242-8357):

        grid = (Grid(cell_data={"density": torch.float32})
                .set_initial_length((64, 64, 64))
                .set_periodic(True, True, True)
                .set_neighborhood_length(1)
                .initialize())          # on the card; device="cpu" for the CPU
    """

    def __init__(self, cell_data=None, dtype=None):
        # field spec: name -> (shape tuple, dtype). ``dtype`` is the
        # grid-wide storage override: every FLOATING field is re-typed
        # to it (bfloat16 halves the state's device residency; the flux
        # kernels keep computing in float32). Integer/bool fields keep
        # their declared types.
        self.fields = {}
        self.state_dtype = None if dtype is None else as_torch_dtype(dtype)
        for name, spec in (cell_data or {}).items():
            if isinstance(spec, tuple):
                shape, fdt = spec
            else:
                shape, fdt = (), spec
            fdt = as_torch_dtype(fdt)
            if self.state_dtype is not None and fdt.is_floating_point:
                fdt = self.state_dtype
            self.fields[name] = (tuple(shape), fdt)
        self._length = (1, 1, 1)
        self._max_ref_lvl = 0
        self._periodic = (False, False, False)
        self._hood_len = 1
        self._geometry_kind = ("none", {})
        self.initialized = False
        self._cap_memo = {}  # capacity hysteresis memo (see _sticky_cap)
        self._program_cache = {}  # step loops keyed by static signature
        self.last_step_path = None  # "bulk" | "roll" | "table" after run_steps
        # AMR request sets, committed by stop_refining
        self._refines = set()
        self._unrefines = set()
        self._dont_refines = set()
        self._dont_unrefines = set()
        # what the last commit removed, for the app's data projection
        self._removed_cells = np.empty(0, np.uint64)
        self._removed_data = {}
        self._new_cells = np.empty(0, np.uint64)
        self._unrefined_parents = np.empty(0, np.uint64)
        self._hybrid_reuse = {}  # hard-shell stream cache (hybrid.py)
        self._plan_arena = None  # pooled plan tables (hybrid.PlanArena)
        self._watchdog_accum = 0  # steps since the last DCCRG_WATCHDOG check

    # -- fluent pre-initialize setters (dccrg.hpp:8242-8357) ----------

    def _require_uninitialized(self):
        if self.initialized:
            raise RuntimeError("must be called before initialize()")

    def set_initial_length(self, length):
        self._require_uninitialized()
        self._length = tuple(int(v) for v in length)
        return self

    def set_maximum_refinement_level(self, lvl: int):
        """Negative means the maximum possible (dccrg.hpp:8264)."""
        self._require_uninitialized()
        self._max_ref_lvl = int(lvl)
        return self

    def set_periodic(self, x: bool, y: bool, z: bool):
        self._require_uninitialized()
        self._periodic = (bool(x), bool(y), bool(z))
        return self

    def set_neighborhood_length(self, n: int):
        self._require_uninitialized()
        if n < 0:
            raise ValueError("neighborhood length must be >= 0")
        self._hood_len = int(n)
        return self

    def set_geometry(self, kind="cartesian", **params):
        """kind: 'none' | 'cartesian' (start, level_0_cell_length) |
        'stretched' (coordinates)."""
        self._require_uninitialized()
        if kind not in ("none", "cartesian", "stretched"):
            raise ValueError(f"unknown geometry kind {kind!r}")
        self._geometry_kind = (kind, params)
        return self

    # -- initialization (dccrg.hpp:480-562) ---------------------------

    def initialize(self, device=None):
        """Build the level-0 grid on one device: ``device`` is a device
        or a one-element list of devices, ``"cuda"`` when None. More
        than one device raises NotImplementedError (multi-GPU exchange
        is a later slice of the port)."""
        self._require_uninitialized()
        if isinstance(device, (list, tuple)):
            if len(device) != 1:
                raise NotImplementedError(
                    f"{len(device)} devices: this port runs on one device")
            device = device[0]
        self.device = resolve_device(device)
        self.n_dev = 1

        self.mapping = Mapping(self._length)
        if self._max_ref_lvl < 0:
            self.mapping.set_maximum_refinement_level(
                self.mapping.get_maximum_possible_refinement_level()
            )
        elif not self.mapping.set_maximum_refinement_level(self._max_ref_lvl):
            raise ValueError(
                f"maximum refinement level {self._max_ref_lvl} not possible "
                f"for grid {self._length}"
            )
        self.topology = GridTopology(self._periodic)
        kind, params = self._geometry_kind
        if kind == "none":
            self.geometry = NoGeometry(self.mapping, self.topology)
        elif kind == "cartesian":
            self.geometry = CartesianGeometry(self.mapping, self.topology, **params)
        else:
            self.geometry = StretchedCartesianGeometry(self.mapping, self.topology, **params)

        self.neighborhoods = {DEFAULT_NEIGHBORHOOD_ID: make_neighborhood(self._hood_len)}

        # level-0 cells, all on the one device (create_level_0_cells,
        # dccrg.hpp:8089)
        n0 = self.mapping.length.total_level0_cells
        cells = np.arange(1, n0 + 1, dtype=np.uint64)
        owner = np.zeros(n0, dtype=np.int32)
        self.initialized = True
        self._build_plan(cells, owner)
        self._allocate_fields()
        return self

    # capacities whose arrays are small but whose need varies a lot
    # epoch-to-epoch: give them a 2x band so shapes virtually never change
    _WIDE_CAPS = ("G", "M", "S", "S_hard", "Hmax", "T_hard", "rollW", "removed")

    def _sticky_cap(self, name, needed: int) -> int:
        """Capacity with hysteresis: grow in buckets with headroom,
        keep the previous capacity while the need still fits, shrink
        only once the need drops well below it."""
        needed = int(needed)
        base = name[0] if isinstance(name, tuple) else name
        wide = base in self._WIDE_CAPS
        prev = self._cap_memo.get(name)
        if prev is not None and needed <= prev and base == "removed":
            return prev  # tiny index buffer: never shrink
        if prev is not None and prev // (4 if wide else 2) <= needed <= prev:
            return prev
        if prev is None:
            # first build: exact bucket
            cap = bucket_capacity(needed)
        else:
            cap = bucket_capacity(needed * 2 if wide else needed + needed // 4)
        self._cap_memo[name] = cap
        return cap

    # -- structure plan building --------------------------------------

    def _build_plan(self, cells: np.ndarray, owner: np.ndarray,
                    changed_hint=None):
        """Build and install the structure plan for ``(cells, owner)``
        (the reference's initialize_neighbors + remote-neighbor +
        send/receive-list pipeline, dccrg.hpp:8371-8420).
        ``changed_hint`` is ``(prev_cells, changed_ids)`` from a commit
        that knows its dirty set; only the hybrid builder reads it."""
        self._finish_plan(self._build_plan_impl(cells, owner, changed_hint))

    def _build_plan_impl(self, cells, owner, changed_hint=None):
        """The reference's dispatch (dccrg_tpu/grid.py:964-1077): the
        closed-form (or forced dense-table) plan for a complete level-0
        grid, the hybrid plan for a refined one, and the generic
        builder under ``DCCRG_FORCE_GENERIC=1``."""
        if len(cells) > 1 and not np.all(cells[:-1] < cells[1:]):
            order = np.argsort(cells, kind="stable")
            cells = cells[order]
            owner = np.asarray(owner, dtype=np.int32)[order]
        else:
            owner = np.asarray(owner, dtype=np.int32)
        n0 = self.mapping.length.total_level0_cells
        if uniform_mod.is_uniform(cells, n0) and n0 < 2**31 - 2:
            return self._build_plan_uniform(cells, owner)
        if n0 < 2**31 - 2 and os.environ.get("DCCRG_FORCE_GENERIC") != "1":
            return self._build_plan_hybrid(cells, owner, changed_hint)
        return self._build_plan_generic(cells, owner)

    def _finish_plan(self, plan):
        old = getattr(self, "plan", None)
        plan.epoch = old.epoch + 1 if old is not None else 0
        self.plan = plan

    def _lists_thunk(self, cells, offs):
        mapping, topology = self.mapping, self.topology
        return lambda: build_neighbor_lists(mapping, topology, cells, offs)

    def _build_plan_uniform(self, cells: np.ndarray, owner: np.ndarray):
        """Plan for a complete level-0 grid (uniform.py): closed-form,
        or dense tables under ``DCCRG_FORCE_TABLES=1``."""
        layout, hood_data = uniform_mod.build_uniform_plan(
            self.mapping, self.topology, self.neighborhoods, cells, owner,
            self.n_dev, cap=self._sticky_cap,
        )
        plan = self._new_plan(cells, owner, layout)
        for hid, offs in self.neighborhoods.items():
            hd = hood_data[hid]
            closed = "closed_form" in hd
            hood = _HoodPlan(
                offsets=offs,
                nbr_rows=hd["tables_thunk"] if closed else hd["nbr_rows"],
                nbr_offs=hd["nbr_offs"],
                nbr_mask=hd["tables_thunk"] if closed else hd["nbr_mask"],
                offs_const=hd["offs_const"],
                closed_form=hd.get("closed_form"),
                to_tables=hd["to_thunk"],
                pair_compact=hd["pair_compact"],
                n_inner=(layout["n_inner"]
                         if hid == DEFAULT_NEIGHBORHOOD_ID else None),
                lists=self._lists_thunk(cells, offs),
            )
            if closed:
                # roll shifts + wrap fixups were computed arithmetically
                hood._roll_plan = hd["roll_plan"]
            plan.hoods[hid] = hood
        return plan

    def _new_plan(self, cells, owner, layout):
        return _Plan(
            cells=cells,
            owner=owner,
            n_dev=self.n_dev,
            L=layout["L"],
            R=layout["R"],
            n_local=layout["n_local"],
            local_ids=layout["local_ids"],
            row_of_pos=layout["row_of_pos"],
            ghost_ids=layout["ghost_ids"],
        )

    def _build_plan_hybrid(self, cells, owner, changed_hint=None):
        """Plan for a refined grid (hybrid.py): closed-form tables away
        from refinement, the generic engine on the hard shell near it.
        The plan arena reclaims every table generation but the live
        plan's."""
        from . import hybrid as hybrid_mod

        if self._plan_arena is None:
            self._plan_arena = hybrid_mod.PlanArena()
        arena = self._plan_arena
        arena.begin(protect=(getattr(self, "plan", None),))
        layout, hood_data = hybrid_mod.build_hybrid_plan(
            self.mapping, self.topology, self.neighborhoods, cells, owner,
            self.n_dev, cap=self._sticky_cap, reuse=self._hybrid_reuse,
            arena=arena, changed_hint=changed_hint,
        )
        plan = self._new_plan(cells, owner, layout)
        arena.bind(plan)
        for hid, offs in self.neighborhoods.items():
            hd = hood_data[hid]
            plan.hoods[hid] = _HoodPlan(
                offsets=offs,
                nbr_rows=hd["nbr_rows"],
                nbr_offs=hd["nbr_offs"],
                nbr_mask=hd["nbr_mask"],
                offs_const=hd["offs_const"],
                hard_rows=hd["hard_rows"],
                hard_nbr_rows=hd["hard_nbr_rows"],
                hard_offs=hd["hard_offs"],
                hard_mask=hd["hard_mask"],
                scale_rows=layout["scale_rows"],
                to_tables=hd["to_thunk"],
                pair_compact=hd["pair_compact"],
                n_inner=(layout["n_inner"]
                         if hid == DEFAULT_NEIGHBORHOOD_ID else None),
                lists=self._lists_thunk(cells, offs),
            )
        return plan

    def _build_plan_generic(self, cells, owner):
        """The generic builder (dccrg_tpu/grid.py:990-1077), one
        device: the full neighbor lists of every hood, rows in cell
        order, each cell's entries left-compacted into ``[1, L, S]``
        tables with explicit offsets."""
        n = len(cells)
        hood_lists = {
            hid: build_neighbor_lists(self.mapping, self.topology, cells, offs)
            for hid, offs in self.neighborhoods.items()
        }
        L = self._sticky_cap("L", max(1, n))
        layout = dict(
            L=L, R=L + 1, n_local=np.array([n], dtype=np.int64),
            local_ids=[cells.copy()], row_of_pos=np.arange(n, dtype=np.int32),
            ghost_ids=[np.empty(0, np.uint64)],
        )
        plan = self._new_plan(cells, owner, layout)
        n_inner = np.array([n], dtype=np.int64)
        for hid, offs in self.neighborhoods.items():
            plan.hoods[hid] = self._build_hood_plan(
                plan, hood_lists[hid], offs,
                n_inner if hid == DEFAULT_NEIGHBORHOOD_ID else None, hid)
        return plan

    def _build_hood_plan(self, plan, nl, offsets, n_inner, hid):
        """One hood of the generic plan (dccrg_tpu/grid.py:1220-1306):
        rows of a cell's entries in stream order, slot = rank within the
        cell, ``S`` a sticky capacity."""
        L, R = plan.L, plan.R
        cells = plan.cells

        def build_table(src_pos, nbr_pos, offs_arr):
            # one device: a cell's row is its position in the cell list
            key = np.asarray(src_pos, dtype=np.int64)
            order = np.argsort(key, kind="stable")
            ksort = key[order]
            m = len(ksort)
            if m == 0:
                return (np.full((1, L, 1), R - 1, dtype=np.int32),
                        np.zeros((1, L, 1, 3), dtype=np.int32),
                        np.zeros((1, L, 1), dtype=bool))
            # slot = rank of the entry within its row group
            change = np.empty(m, dtype=bool)
            change[0] = True
            change[1:] = ksort[1:] != ksort[:-1]
            group_start = np.maximum.accumulate(
                np.where(change, np.arange(m), 0))
            slot = np.arange(m) - group_start
            S = self._sticky_cap(("S", hid), max(1, int(slot.max()) + 1))
            rows = np.full((L * S,), R - 1, dtype=np.int32)
            offs = np.zeros((L * S, 3), dtype=np.int32)
            mask = np.zeros((L * S,), dtype=bool)
            flat = ksort * S + slot
            rows[flat] = nbr_pos[order]
            offs[flat] = offs_arr[order]
            mask[flat] = True
            return (rows.reshape(1, L, S), offs.reshape(1, L, S, 3),
                    mask.reshape(1, L, S))

        nbr_rows, nbr_offs, nbr_mask = build_table(
            nl.of_source, np.searchsorted(cells, nl.of_neighbor),
            nl.of_offset)

        def to_tables():
            return build_table(nl.to_source,
                               np.searchsorted(cells, nl.to_neighbor),
                               nl.to_offset)

        pair_compact = uniform_mod.build_pair_tables(
            [np.empty(0, np.int64)], 1, None, None, None,
            lambda needed: self._sticky_cap(("M", hid), needed))
        return _HoodPlan(
            offsets=offsets,
            nbr_rows=nbr_rows,
            nbr_offs=nbr_offs,
            nbr_mask=nbr_mask,
            to_tables=to_tables,
            pair_compact=pair_compact,
            n_inner=n_inner,
            lists=nl,
        )

    def _allocate_fields(self):
        self.data = {}
        for name, (shape, dtype) in self.fields.items():
            self.data[name] = torch.zeros((self.n_dev, self.plan.R) + shape,
                                          dtype=dtype, device=self.device)

    def device_row_ids(self) -> torch.Tensor:
        """``[n_dev, R]`` tensor of ``cell id - 1`` per row (``-1`` on
        pad rows). On a complete level-0 grid it is made on the device
        from an arange (rows are id order, int32); otherwise it is
        uploaded from ``plan.local_ids`` (int64 once ids exceed int32).
        Cached per structure epoch."""
        plan = self.plan
        cached = getattr(plan, "_row_ids_dev", None)
        if cached is not None:
            return cached
        n0 = self.mapping.length.total_level0_cells
        if len(plan.cells) == n0 and int(plan.cells[-1]) == n0:
            idx = torch.arange(plan.R, dtype=torch.int32, device=self.device)
            arr = torch.where(idx < n0, idx, torch.full_like(idx, -1))[None, :]
        else:
            wide = int(plan.cells[-1]) > np.iinfo(np.int32).max
            host = np.full((1, plan.R), -1, dtype=np.int64 if wide else np.int32)
            host[0, :int(plan.n_local[0])] = plan.local_ids[0].astype(np.int64) - 1
            arr = torch.as_tensor(host, device=self.device)
        plan._row_ids_dev = arr
        return arr

    def local_row_mask(self) -> torch.Tensor:
        """``[n_dev, R] float32`` mask: 1 on local rows, 0 on pad rows
        — the device-side reduction mask. Cached per structure epoch."""
        plan = self.plan
        cached = getattr(plan, "_local_mask_dev", None)
        if cached is not None:
            return cached
        rows = torch.arange(plan.R, dtype=torch.int64, device=self.device)
        arr = (rows < int(plan.n_local[0])).to(torch.float32)[None, :]
        plan._local_mask_dev = arr
        return arr

    def _host_rows(self, ids):
        """(device, row) for each cell id (host lookup)."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.uint64))
        cells = self.plan.cells
        pos = np.searchsorted(cells, ids)
        if np.any(pos >= len(cells)) or np.any(
                cells[np.minimum(pos, len(cells) - 1)] != ids):
            raise KeyError("unknown cell id(s)")
        return self.plan.owner[pos], self.plan.row_of_pos[pos].astype(np.int64)

    def get(self, field: str, ids) -> np.ndarray:
        """Host read of per-cell data (reference operator[] access).
        bfloat16 fields come back as float32 (numpy has no bfloat16;
        the widening is exact)."""
        scalar = np.isscalar(ids) or np.asarray(ids).ndim == 0
        _dev, rows = self._host_rows(ids)
        arr = self.data[field]
        out = _host_numpy(arr[0, torch.as_tensor(rows, device=arr.device)])
        return out[0] if scalar else out

    def set(self, field: str, ids, values) -> None:
        """Host write of per-cell data (init / tests / boundary setup)."""
        self.set_many(ids, {field: values})

    def set_many(self, ids, values_by_field) -> None:
        """Host write of several fields for the same cell set; the row
        resolution happens once. Writes into the field tensors in place."""
        _dev, rows = self._host_rows(ids)
        rows_t = torch.as_tensor(rows, device=self.device)
        for name, values in values_by_field.items():
            _shape, dtype = self.fields[name]
            vals = (values if isinstance(values, torch.Tensor)
                    else torch.as_tensor(np.asarray(values)))
            self.data[name][0, rows_t] = vals.to(device=self.device, dtype=dtype)

    # neighbor-type bits (reference dccrg.hpp:2968-3075)
    HAS_NO_NEIGHBOR = 0
    HAS_LOCAL_NEIGHBOR_OF = 1 << 0
    HAS_LOCAL_NEIGHBOR_TO = 1 << 1
    HAS_REMOTE_NEIGHBOR_OF = 1 << 2
    HAS_REMOTE_NEIGHBOR_TO = 1 << 3
    HAS_LOCAL_NEIGHBOR_BOTH = HAS_LOCAL_NEIGHBOR_OF | HAS_LOCAL_NEIGHBOR_TO
    HAS_REMOTE_NEIGHBOR_BOTH = HAS_REMOTE_NEIGHBOR_OF | HAS_REMOTE_NEIGHBOR_TO

    def neighbor_type_masks(self, neighborhood_id=DEFAULT_NEIGHBORHOOD_ID) -> np.ndarray:
        """Per-cell neighbor-type bitmask in plan.cells order: which of
        each cell's neighbors_of / neighbors_to live on its own device
        ("local") or another ("remote"; none on one device)."""
        plan = self.plan
        nl = plan.hoods[neighborhood_id].lists
        masks = np.zeros(len(plan.cells), dtype=np.int32)
        of_nbr_owner = plan.owner[np.searchsorted(plan.cells, nl.of_neighbor)]
        same = plan.owner[nl.of_source] == of_nbr_owner
        np.bitwise_or.at(masks, nl.of_source[same], self.HAS_LOCAL_NEIGHBOR_OF)
        np.bitwise_or.at(masks, nl.of_source[~same], self.HAS_REMOTE_NEIGHBOR_OF)
        to_nbr_owner = plan.owner[np.searchsorted(plan.cells, nl.to_neighbor)]
        same_to = plan.owner[nl.to_source] == to_nbr_owner
        np.bitwise_or.at(masks, nl.to_source[same_to], self.HAS_LOCAL_NEIGHBOR_TO)
        np.bitwise_or.at(masks, nl.to_source[~same_to], self.HAS_REMOTE_NEIGHBOR_TO)
        return masks

    def get_cells(self, criteria=None, exact_match: bool = False,
                  neighborhood_id=DEFAULT_NEIGHBORHOOD_ID) -> np.ndarray:
        """Cell ids, id-sorted (reference get_cells, dccrg.hpp:661-753).
        With ``criteria``: the cells whose neighbor-type bitmask matches
        any criterion — equality under ``exact_match``, else a non-empty
        intersection with the merged criteria."""
        if neighborhood_id not in self.plan.hoods:
            return np.empty(0, np.uint64)
        cells = self.plan.cells.copy()
        if criteria is None:
            return cells
        criteria = [int(c) for c in np.atleast_1d(criteria)]
        masks = self.neighbor_type_masks(neighborhood_id)
        if exact_match:
            keep = np.isin(masks, criteria)
        else:
            merged = 0
            for c in criteria:
                merged |= c
            keep = (masks & merged) > 0
        return cells[keep]

    # -- neighbor queries (dccrg.hpp:831-3236) -------------------------

    def _cell_pos(self, cell):
        """Index of ``cell`` in the sorted cell list, or None for an
        unknown id."""
        pos = int(np.searchsorted(self.plan.cells, np.uint64(cell)))
        if pos >= len(self.plan.cells) or self.plan.cells[pos] != np.uint64(cell):
            return None
        return pos

    def is_local(self, cell, device=None) -> bool:
        """Whether ``cell`` exists (``device=None``) or is owned by
        ``device``; on one device every cell is local."""
        pos = self._cell_pos(cell)
        if pos is None:
            return False
        if device is None:
            return True
        return int(self.plan.owner[pos]) == int(device)

    def _cell_neighbors_of(self, pos, hood):
        """(neighbor ids, offsets) of one cell: the materialized lists
        when there are any, else one single-cell engine query."""
        if callable(hood._lists):
            _src, nbr, off, _item = find_neighbors_of(
                self.mapping, self.topology, self.plan.cells,
                self.plan.cells[pos : pos + 1], hood.offsets,
            )
            return nbr, off
        nl = hood.lists
        m = nl.of_source == pos
        return nl.of_neighbor[m], nl.of_offset[m]

    def _cell_neighbors_to(self, pos, hood):
        """(ids, offsets) of the cells that consider this cell a
        neighbor: the lists when materialized, else a subset query."""
        if callable(hood._lists):
            _qi, src, off = find_neighbors_to_subset(
                self.mapping, self.topology, self.plan.cells,
                self.plan.cells[pos : pos + 1], hood.offsets,
            )
            return src, off
        nl = hood.lists
        m = nl.to_source == pos
        return nl.to_neighbor[m], nl.to_offset[m]

    def get_neighbors_of(self, cell, neighborhood_id=DEFAULT_NEIGHBORHOOD_ID):
        """[(neighbor id, (dx, dy, dz))] in neighborhood-item order."""
        pos = self._cell_pos(cell)
        if pos is None:
            raise ValueError(f"unknown cell {cell}")
        nbrs, offs = self._cell_neighbors_of(pos, self.plan.hoods[neighborhood_id])
        return list(zip(nbrs.tolist(), map(tuple, offs)))

    def get_neighbors_to(self, cell, neighborhood_id=DEFAULT_NEIGHBORHOOD_ID):
        pos = self._cell_pos(cell)
        if pos is None:
            raise ValueError(f"unknown cell {cell}")
        nbrs, offs = self._cell_neighbors_to(pos, self.plan.hoods[neighborhood_id])
        return list(zip(nbrs.tolist(), map(tuple, offs)))

    def get_face_neighbors_of(self, cell):
        """[(neighbor id, direction)] with directions +-1/2/3 as in the
        reference (dccrg.hpp:2828-2955): +-1 = x, +-2 = y, +-3 = z."""
        out = []
        size = int(self.mapping.get_cell_length_in_indices(np.uint64(cell)))
        for nid, off in self.get_neighbors_of(cell):
            nsize = int(self.mapping.get_cell_length_in_indices(np.uint64(nid)))
            for dim in range(3):
                lo, hi = off[dim], off[dim] + nsize
                other = [d for d in range(3) if d != dim]
                if all(off[d] < size and off[d] + nsize > 0 for d in other):
                    if hi == 0:
                        out.append((nid, -(dim + 1)))
                    elif lo == size:
                        out.append((nid, dim + 1))
        return out

    def get_neighbors_of_at_offset(self, cell, x, y, z,
                                   neighborhood_id=DEFAULT_NEIGHBORHOOD_ID):
        """Neighbors of ``cell`` inside the neighborhood window at
        offset (x, y, z) — [(id, (dx, dy, dz))], empty for the zero
        offset, an offset outside the neighborhood, or an unknown cell
        (reference get_neighbors_of_at_offset, dccrg.hpp:3110-3160).
        Matches by window intersection, so a coarser neighbor covering
        several windows is returned at each of them."""
        if (x, y, z) == (0, 0, 0):
            return []
        hood = self.plan.hoods.get(neighborhood_id)
        if hood is None:
            return []
        if not np.any(np.all(hood.offsets == np.array([x, y, z]), axis=1)):
            return []
        pos = self._cell_pos(cell)
        if pos is None:
            return []
        nbrs, offs = self._cell_neighbors_of(pos, hood)
        if len(nbrs) == 0:
            return []
        size = int(self.mapping.get_cell_length_in_indices(np.uint64(cell)))
        win = self.mapping.get_indices(np.uint64(cell)).astype(np.int64)
        win += np.array([x, y, z], dtype=np.int64) * size
        il = self.mapping.get_index_length().astype(np.int64)
        for d in range(3):
            if self.topology.is_periodic(d):
                win[d] %= il[d]
            elif not 0 <= win[d] < il[d]:
                return []
        nidx = self.mapping.get_indices(nbrs).astype(np.int64)
        nsize = self.mapping.get_cell_length_in_indices(nbrs).astype(np.int64)
        hit = np.ones(len(nbrs), dtype=bool)
        for d in range(3):
            if self.topology.is_periodic(d):
                h = np.zeros(len(nbrs), dtype=bool)
                for shift in (-il[d], 0, il[d]):
                    h |= (nidx[:, d] + shift < win[d] + size) & (
                        nidx[:, d] + nsize + shift > win[d]
                    )
                hit &= h
            else:
                hit &= (nidx[:, d] < win[d] + size) & (nidx[:, d] + nsize > win[d])
        return list(zip(nbrs[hit].tolist(), map(tuple, offs[hit])))

    def find_cells(self, indices_min, indices_max,
                   minimum_refinement_level: int = 0,
                   maximum_refinement_level: int | None = None) -> np.ndarray:
        """Existing cells whose index volume overlaps the inclusive box
        [indices_min, indices_max] and whose refinement level is within
        the given range (reference find_cells, dccrg.hpp:4908-5030).
        Indices are in smallest-possible-cell units; result id-sorted."""
        if maximum_refinement_level is None:
            maximum_refinement_level = self.mapping.max_refinement_level
        if minimum_refinement_level > maximum_refinement_level:
            raise ValueError("minimum refinement level > maximum")
        if maximum_refinement_level > self.mapping.max_refinement_level:
            raise ValueError("maximum refinement level too large")
        lo = np.asarray(indices_min, dtype=np.int64)
        hi = np.asarray(indices_max, dtype=np.int64)
        if np.any(lo > hi):
            raise ValueError("minimum index > maximum index")
        cells = self.plan.cells
        lvl = self.mapping.get_refinement_level(cells)
        keep = (lvl >= minimum_refinement_level) & (lvl <= maximum_refinement_level)
        idx = self.mapping.get_indices(cells).astype(np.int64)
        size = self.mapping.get_cell_length_in_indices(cells).astype(np.int64)
        overlap = np.all((idx <= hi) & (idx + size[:, None] - 1 >= lo), axis=1)
        return cells[keep & overlap]

    def get_existing_cell_from_indices(self, indices,
                                       minimum_refinement_level: int = 0,
                                       maximum_refinement_level: int | None = None):
        """Smallest existing cell containing the given smallest-cell
        indices within a refinement-level range (reference
        get_existing_cell, dccrg.hpp:11414-11447)."""
        if maximum_refinement_level is None:
            maximum_refinement_level = self.mapping.max_refinement_level
        idx = np.asarray(indices, dtype=np.uint64)
        if np.any(idx >= self.mapping.get_index_length()):
            return ERROR_CELL
        for lvl in range(maximum_refinement_level,
                         minimum_refinement_level - 1, -1):
            c = self.mapping.get_cell_from_indices(idx, lvl)
            if c != ERROR_CELL and self._cell_pos(c) is not None:
                return np.uint64(c)
        return ERROR_CELL

    def get_existing_cell(self, coordinate):
        """Smallest existing cell containing a coordinate (reference
        get_existing_cell, dccrg.hpp:11414-11447)."""
        for lvl in range(self.mapping.max_refinement_level, -1, -1):
            c = self.geometry.get_cell(lvl, coordinate)
            if c != ERROR_CELL and self._cell_pos(c) is not None:
                return np.uint64(c)
        return ERROR_CELL

    # -- user neighborhoods (dccrg.hpp:6491-6681) ----------------------

    def add_neighborhood(self, neighborhood_id, offsets) -> bool:
        """Register a user neighborhood (offsets validated against the
        default neighborhood length) and rebuild the plan; False when
        the id is taken."""
        if not self.initialized:
            raise RuntimeError("add_neighborhood() requires initialize() first")
        if neighborhood_id in self.neighborhoods:
            return False
        offsets = validate_neighborhood(offsets, self._hood_len)
        self.neighborhoods[neighborhood_id] = offsets
        self._build_plan(self.plan.cells, self.plan.owner)
        return True

    # -- AMR requests and commit (dccrg.hpp:2456-3507) -----------------

    def refine_completely(self, cell) -> bool:
        """Request refinement of a cell into its 8 children
        (dccrg.hpp:2456). Committed by stop_refining()."""
        if not self.is_local(cell):
            return False
        if self.mapping.get_refinement_level(np.uint64(cell)) >= self.mapping.max_refinement_level:
            return False
        self._refines.add(int(cell))
        # a refine overrides a pending unrefine of the same cell
        # (dccrg.hpp:2517-2551); sibling groups are resolved at commit
        self._unrefines.discard(int(cell))
        return True

    def unrefine_completely(self, cell) -> bool:
        """Request removal of the cell's sibling group, replaced by the
        parent (dccrg.hpp:2582)."""
        if not self.is_local(cell):
            return False
        if self.mapping.get_refinement_level(np.uint64(cell)) == 0:
            return False
        if int(cell) in self._refines:
            return False
        self._unrefines.add(int(cell))
        return True

    def dont_refine(self, cell) -> bool:
        """Forbid refinement (induced included) of the cell (dccrg.hpp:2766)."""
        if not self.is_local(cell):
            return False
        self._dont_refines.add(int(cell))
        return True

    def dont_unrefine(self, cell) -> bool:
        """Forbid unrefinement of the cell's sibling group (dccrg.hpp:2701)."""
        if not self.is_local(cell):
            return False
        self._dont_unrefines.add(int(cell))
        return True

    def refine_completely_at(self, coordinate) -> bool:
        """Coordinate variant (dccrg.hpp:3401-3470)."""
        c = self.get_existing_cell(coordinate)
        return bool(c != ERROR_CELL) and self.refine_completely(c)

    def unrefine_completely_at(self, coordinate) -> bool:
        c = self.get_existing_cell(coordinate)
        return bool(c != ERROR_CELL) and self.unrefine_completely(c)

    def dont_refine_at(self, coordinate) -> bool:
        c = self.get_existing_cell(coordinate)
        return bool(c != ERROR_CELL) and self.dont_refine(c)

    def dont_unrefine_at(self, coordinate) -> bool:
        c = self.get_existing_cell(coordinate)
        return bool(c != ERROR_CELL) and self.dont_unrefine(c)

    def stop_refining(self) -> np.ndarray:
        """Commit all refinement requests; returns the created cells
        (dccrg.hpp:3483-3507). Data of refined parents and removed
        cells stays readable through get_old_data() until
        clear_refined_unrefined_data().

        Not transactional yet: the reference rolls a failed commit back
        (its ``txn.grid_transaction``), which the port has not taken. A
        fault before the resolve finishes (the ``adapt.commit``
        ``resolve`` phase, ``adapt.resolve``) leaves the grid and its
        requests unchanged; an exception after it leaves the request
        sets cleared, and one inside the plan rebuild the grid on its
        previous plan."""
        from .amr import resolve_adaptation

        with telemetry.span("grid.adapt"):
            faults.fire("adapt.commit", phase="resolve")
            res = resolve_adaptation(
                self.mapping,
                self.plan.cells,
                self.plan.owner,
                self.neighborhoods[DEFAULT_NEIGHBORHOOD_ID],
                self._refines,
                self._unrefines,
                self._dont_refines,
                self._dont_unrefines,
                topology=self.topology,
                hood_len=self._hood_len,
            )
            faults.fire("adapt.commit", phase="resolved")
            self._refines.clear()
            self._unrefines.clear()
            self._dont_refines.clear()
            self._dont_unrefines.clear()

            # preserve the data of disappearing cells for the app's
            # projection: one device-side gather per field, pulled to host
            old_ids = np.concatenate([res.refined_parents, res.removed_cells])
            self._removed_data = {}
            if len(old_ids):
                _dev, rows = self._host_rows(old_ids)
                rows_t = torch.as_tensor(rows, device=self.device)
                for name in self.fields:
                    vals = self.data[name][0].index_select(0, rows_t)
                    self._removed_data[name] = (old_ids, _host_numpy(vals))
            else:
                self._removed_data = {name: (old_ids, None) for name in self.fields}
            faults.fire("adapt.commit", phase="preserved")
            self._removed_cells = res.removed_cells
            self._new_cells = res.new_cells
            self._unrefined_parents = res.unrefined_parents
            self._restructure(res.cells, res.owner, changed=res.changed_cells)
            return res.new_cells.copy()

    def _restructure(self, new_cells, new_owner, changed=None):
        """Rebuild the plan for a new cell set and carry the surviving
        cells' data over (the reference's rebuild, dccrg.hpp:10642-10690,
        with the data movement folded in). ``changed`` is the commit's
        dirty set of ids, handed to the hybrid builder."""
        with telemetry.span("grid.recommit"):
            self._restructure_impl(new_cells, new_owner, changed)

    def _restructure_impl(self, new_cells, new_owner, changed):
        old_plan = self.plan
        same_cells = (len(new_cells) == len(old_plan.cells)
                      and np.array_equal(new_cells, old_plan.cells))
        if same_cells:
            changed_hint = (old_plan.cells, np.empty(0, dtype=np.uint64))
        elif changed is not None:
            changed_hint = (old_plan.cells, changed)
        else:
            changed_hint = None
        plan = self._build_plan_impl(new_cells, new_owner, changed_hint)
        self._install_plan(plan)

    def _install_plan(self, plan):
        """Install a built plan as the live structure epoch and move
        each surviving cell's row to its new row on the device (one
        gather per field; rows of new cells, pad rows and the zero row
        start at zero)."""
        old_plan = self.plan
        surviving = plan.cells[np.isin(plan.cells, old_plan.cells)]
        _d, old_rows = self._host_rows(surviving)
        self._finish_plan(plan)
        faults.fire("grid.restructure", phase="planned")
        _d, new_rows = self._host_rows(surviving)
        src = torch.as_tensor(old_rows, device=self.device)
        dst = torch.as_tensor(new_rows, device=self.device)
        for name, (shape, dtype) in self.fields.items():
            moved = torch.zeros((self.n_dev, plan.R) + shape, dtype=dtype,
                                device=self.device)
            moved[0].index_copy_(0, dst, self.data[name][0].index_select(0, src))
            self.data[name] = moved
        faults.fire("grid.restructure", phase="moved")

    def get_removed_cells(self) -> np.ndarray:
        """Cells removed by the last stop_refining (dccrg.hpp:3519)."""
        return self._removed_cells.copy()

    def get_old_data(self, field, ids):
        """Data of cells that disappeared in the last stop_refining
        (refined parents and removed children) — the reference keeps
        these reachable until clear (dccrg.hpp:10355)."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.uint64))
        stored_ids, values = self._removed_data[field]
        order = np.argsort(stored_ids, kind="stable")
        sorted_ids = stored_ids[order]
        pos = np.searchsorted(sorted_ids, ids)
        if np.any(pos >= len(sorted_ids)) or np.any(
                sorted_ids[np.minimum(pos, len(sorted_ids) - 1)] != ids):
            raise KeyError("cell not among refined/removed cells")
        return values[order][pos]

    def clear_refined_unrefined_data(self) -> None:
        """Drop the preserved old data (dccrg.hpp:5550)."""
        self._removed_data = {}
        self._removed_cells = np.empty(0, np.uint64)
        self._new_cells = np.empty(0, np.uint64)

    def assign_children_from_parents(self, fields=None) -> None:
        """Copy each new child's value from its refined parent
        (tests/advection/adapter.hpp:229-301)."""
        new = self._new_cells
        if len(new) == 0:
            return
        parents = self.mapping.get_parent(new)
        for name in fields if fields is not None else self.fields:
            self.set(name, new, self.get_old_data(name, parents))

    def average_parents_from_children(self, fields=None) -> None:
        """Set each unrefined parent to the mean of its removed children."""
        if len(self._removed_cells) == 0:
            return
        parents = self._unrefined_parents
        if len(parents) == 0:
            return
        kids = self.mapping.get_all_children(parents)  # [n, 8]
        for name in fields if fields is not None else self.fields:
            vals = self.get_old_data(name, kids.reshape(-1))
            fshape = vals.shape[1:]
            vals = vals.reshape((len(parents), 8) + fshape).mean(axis=1)
            self.set(name, parents, vals)

    def balance_load(self) -> None:
        """Repartition cells over devices (dccrg.hpp:1046). On one
        device every partition puts all cells on device 0, so this is
        what the reference's one-device balance does: the plan is
        rebuilt for the same cells and owners, and every cell keeps its
        row and its data. The reference's ``balance.commit`` fault
        phases fire in its order: ``partition`` and ``stage`` before any
        change of state, ``finish`` before the rebuild and ``land``
        after it."""
        with telemetry.span("grid.balance"):
            owner = self.plan.owner.copy()
            faults.fire("balance.commit", phase="partition")
            faults.fire("balance.commit", phase="stage")
            faults.fire("balance.commit", phase="finish")
            self._restructure(self.plan.cells.copy(), owner)
            faults.fire("balance.commit", phase="land")

    def load_cells(self, cells) -> None:
        """Replace the grid structure with an arbitrary valid cell set
        (the reference's load_cells, dccrg.hpp:3669-3738); the data of
        every cell is reset."""
        cells = np.asarray(cells, dtype=np.uint64)
        if len(cells) > 1 and not np.all(cells[1:] >= cells[:-1]):
            cells = np.sort(cells)
        verify_tiling(self.mapping, cells)
        self._build_plan(cells, np.zeros(len(cells), dtype=np.int32))
        self._allocate_fields()

    # -- checkpoint / restart (dccrg.hpp:1109-2426) --------------------

    def save_grid_data(self, filename: str, header: bytes = b"",
                       variable=None) -> None:
        """Write the ``.dc`` bytes (checkpoint.save_grid_data)."""
        from .checkpoint import save_grid_data

        save_grid_data(self, filename, header, variable=variable)

    def load_grid_data(self, filename: str, header_size: int = 0,
                       variable=None) -> bytes:
        """Load a ``.dc`` file into this grid, whose parameters must
        match the file's; returns the user header."""
        from .checkpoint import load_grid_data

        return load_grid_data(self, filename, header_size, variable=variable)

    @classmethod
    def from_file(cls, filename: str, cell_data, device=None,
                  header_size: int = 0, variable=None):
        """Restart from nothing but a ``.dc`` file: mapping, topology,
        geometry and the AMR cell set come from its metadata, then the
        payloads stream in. Returns ``(grid, header)``."""
        from .checkpoint import load_grid

        return load_grid(filename, cell_data, device=device,
                         header_size=header_size, variable=variable)

    def save_checkpoint(self, filename: str, header: bytes = b"",
                        variable=None) -> str:
        """Atomic, checksummed checkpoint: the ``.dc`` bytes (identical
        to :meth:`save_grid_data`) through temp file + fsync + rename,
        with the CRC32 sidecar ``<file>.crc`` (resilience.save_checkpoint)."""
        return resilience.save_checkpoint(self, filename, header=header,
                                          variable=variable)

    @classmethod
    def load_checkpoint(cls, filename: str, cell_data, device=None,
                        header_size: int = 0, variable=None,
                        strict: bool = True):
        """Restart from a checkpoint with integrity verification:
        ``(grid, header, report)`` (resilience.load_checkpoint)."""
        return resilience.load_checkpoint(
            filename, cell_data, device=device, header_size=header_size,
            variable=variable, strict=strict)

    # -- halo exchange (dccrg.hpp:978-1014) ----------------------------

    def update_copies_of_remote_neighbors(
        self, neighborhood_id=DEFAULT_NEIGHBORHOOD_ID, fields=None
    ) -> None:
        """Refresh ghost copies of remote neighbors (dccrg.hpp:978). One
        device has no ghost rows, so nothing moves; the neighborhood and
        the field names are still checked."""
        if neighborhood_id not in self.plan.hoods:
            raise KeyError(f"unknown neighborhood {neighborhood_id!r}")
        unknown = [n for n in (fields or ()) if n not in self.fields]
        if unknown:
            raise KeyError(f"unknown field(s) {unknown}")

    # -- stencil execution ---------------------------------------------

    def apply_stencil(
        self,
        kernel,
        fields_in,
        fields_out,
        neighborhood_id=DEFAULT_NEIGHBORHOOD_ID,
        include_to=False,
        extra_args=(),
    ):
        """Run a gather-based stencil kernel over all local cells.

        ``kernel(cell_fields, nbr_fields, offs, mask, *extra)`` receives
        ``cell_fields[name]`` ``[L, ...]``, ``nbr_fields[name]``
        ``[L, S, ...]`` (neighbors gathered; masked slots hold zeros or
        the zero row), ``offs`` ``[L, S, 3]`` (zero where the mask is
        off) and ``mask`` ``[L, S]``; with ``include_to=True`` a second
        (nbr_to_fields, to_offs, to_mask) triple follows the mask. It
        returns a dict name -> ``[L, ...]`` for every name in
        ``fields_out``; the updated rows are written into new field
        tensors. A ``SlotwiseKernel`` is fed one slot at a time instead
        (no ``include_to``). Extras that are Python numbers become
        float32 tensors.
        """
        fields_in = tuple(fields_in)
        fields_out = tuple(fields_out)
        extra_args = _as_extra(extra_args)
        fn, tables = self._make_stencil(
            kernel, fields_in, fields_out, neighborhood_id, include_to,
            n_extra=len(extra_args),
        )
        out = fn(*tables, *(self.data[n] for n in fields_in),
                 *(self.data[n] for n in fields_out), *extra_args)
        for n, arr in zip(fields_out, out):
            self.data[n] = arr

    def _pass_tables(self, hood, include_to, slotwise):
        """(spec, host-to-device tables) of one stencil pass over
        ``hood`` — the reference's table selection
        (dccrg_tpu/grid.py:2720-2806) without its roll decomposition:

        - ``closed``: a closed-form plan (no include_to) gathers by exact
          3-D rolls and synthesizes its mask; its one table is
          ``offs_const``;
        - ``table``: the dense ``[L, S]`` rows and mask (slot-major
          ``[S, L]`` for a ``SlotwiseKernel``) with ``offs_const`` or the
          explicit ``nbr_offs``;
        - ``merged``: include_to on a split plan runs over the merged
          far + hard tables.

        Then ``scale_rows`` (hybrid plans), the hard-row tables cut to
        their real rows (``split``) and the to-tables (include_to)."""
        dev = self.device
        split = hood.hard_nbr_rows is not None and not include_to
        merged = include_to and hood.hard_nbr_rows is not None
        cf = hood.closed_form if not include_to else None
        if merged:
            kind, uniform_offs = "merged", False
            if ("m_rows", str(dev)) not in hood._dev:
                m_rows, m_offs, m_mask = hood.merged_of_tables(self.plan.R - 1)
                hood.dev("m_rows", m_rows[0], dev)
                hood.dev("m_offs", m_offs[0], dev)
                hood.dev("m_mask", m_mask[0], dev)
            tables = [hood._dev[(n, str(dev))]
                      for n in ("m_rows", "m_offs", "m_mask")]
        else:
            uniform_offs = hood.offs_const is not None
            if cf is not None:
                kind = "closed"
                tables = [hood.dev("offs_const", hood.offs_const, dev)]
            else:
                kind = "table"
                if slotwise:
                    tables = [hood.dev("nbr_rows_t",
                                       lambda: hood.nbr_rows[0].T, dev)]
                else:
                    tables = [hood.dev("nbr_rows", lambda: hood.nbr_rows[0],
                                       dev)]
                if uniform_offs:
                    tables.append(hood.dev("offs_const", hood.offs_const, dev))
                else:
                    tables.append(hood.dev("nbr_offs", lambda: hood.nbr_offs[0],
                                           dev))
                if slotwise:
                    tables.append(hood.dev("nbr_mask_t",
                                           lambda: hood.nbr_mask[0].T, dev))
                else:
                    tables.append(hood.dev("nbr_mask", lambda: hood.nbr_mask[0],
                                           dev))
        scaled = uniform_offs and hood.scale_rows is not None
        if scaled:
            tables.append(hood.dev("scale_rows", hood.scale_rows[0], dev))
        if split:
            n_hard = int(np.count_nonzero(hood.hard_rows[0] < self.plan.L))
            tables.append(hood.dev(
                "hard_rows", lambda: hood.hard_rows[0, :n_hard].astype(np.int64),
                dev))
            tables.append(hood.dev("hard_nbr_rows",
                                   lambda: hood.hard_nbr_rows[0, :n_hard], dev))
            tables.append(hood.dev("hard_offs",
                                   lambda: hood.hard_offs[0, :n_hard], dev))
            tables.append(hood.dev("hard_mask",
                                   lambda: hood.hard_mask[0, :n_hard], dev))
        if include_to:
            tables.append(hood.dev("to_rows", lambda: hood.to_rows[0], dev))
            tables.append(hood.dev("to_offs", lambda: hood.to_offs[0], dev))
            tables.append(hood.dev("to_mask", lambda: hood.to_mask[0], dev))
        spec = (kind, _synth_key(cf), uniform_offs, scaled, split,
                bool(include_to), slotwise)
        return spec, tables

    def _make_stencil(self, kernel, fields_in, fields_out, neighborhood_id,
                      include_to, n_extra=0):
        """(program, bound tables) for a gather stencil:
        ``program(*tables, *fields_in, *fields_out, *extra) ->
        fields_out`` (``[n_dev, R]`` tensors in and out). The table
        branch of the reference's ``_make_stencil``
        (dccrg_tpu/grid.py:2720-2916): the bulk pass over the dense (or
        closed-form) plan, then, on a split plan, the kernel over the
        hard rows, whose results overwrite the bulk result's rows."""
        fields_in = tuple(fields_in)
        fields_out = tuple(fields_out)
        slotwise = isinstance(kernel, SlotwiseKernel)
        if slotwise and include_to:
            raise ValueError("SlotwiseKernel does not support include_to")
        hood = self.plan.hoods[neighborhood_id]
        L, R = self.plan.L, self.plan.R
        spec, tables = self._pass_tables(hood, include_to, slotwise)
        key = ("stencil", kernel, fields_in, fields_out, n_extra, L, R, spec)
        fn = self._program_cache.get(key)
        if fn is not None:
            return fn, tables

        n_in, n_out, n_tab = len(fields_in), len(fields_out), len(tables)

        def fn(*args):
            ins = args[n_tab:n_tab + n_in]
            outs_cur = args[n_tab + n_in:n_tab + n_in + n_out]
            extra = args[n_tab + n_in + n_out:]
            flat = {n: f[0] for n, f in zip(fields_in, ins)}
            cell_fields = {n: f[:L] for n, f in flat.items()}
            run = _make_pass(spec, args[:n_tab], L, fields_out)
            result = run(kernel, cell_fields, flat, extra)
            outs = []
            for n, cur in zip(fields_out, outs_cur):
                fl = cur[0].clone()
                fl[:L] = result[n].to(fl.dtype)
                outs.append(fl[None])
            return tuple(outs)

        self._program_cache[key] = fn
        return fn, tables

    # -- fused multi-step execution ------------------------------------

    def compile_step_loop(
        self,
        kernel,
        fields_in,
        fields_out,
        exchange_fields=None,
        neighborhood_id=DEFAULT_NEIGHBORHOOD_ID,
        n_extra=0,
        bulk=True,
    ):
        """The step loop running ``n_steps`` time steps on the grid's
        device. Returns ``(fn, tables, static_in)`` where
        ``fn(n_steps, *tables, *static, *out, *extra) -> out tensors``;
        ``fn.step_path`` says which path it runs.

        With ``bulk`` (the default) an eligible loop goes through the
        bulk executor (ops/roll_executor.py): on a CUDA grid every pass
        launches the CUDA bulk kernel. Otherwise a closed-form plan
        takes the plain roll path (``"roll"``: every slot gathers its
        neighbors with an exact 3-D ``torch.roll``) and any other plan
        the table path (``"table"``: gathers by index from the dense
        tables, then the hard-row pass of a split plan), the table
        branch of the reference's loop (dccrg_tpu/grid.py:2976-3068,
        one device). A plain grid kernel (``kernel(cell_fields,
        nbr_fields, offs, mask, *extra)``, not a ``SlotwiseKernel``) gets
        the ``[L, S]`` neighbour stacks, the pre-masked ``[L, S, 3]``
        offsets and the ``[L, S]`` mask.

        ``exchange_fields`` must be a subset of ``fields_out``. On one
        device there are no ghost rows, so nothing is exchanged.
        """
        fields_in = tuple(fields_in)
        fields_out = tuple(fields_out)
        if exchange_fields is None:
            exchange_fields = fields_out
        exchange_fields = tuple(exchange_fields)
        if not set(exchange_fields) <= set(fields_out):
            raise ValueError(
                "exchange_fields must be a subset of fields_out; static "
                "fields' ghosts are refreshed once per structure epoch"
            )
        if bulk:
            from .ops import roll_executor

            built = roll_executor.compile_bulk_step_loop(
                self, kernel, fields_in, fields_out, exchange_fields,
                neighborhood_id, n_extra)
            if built is not None:
                return built
        hood = self.plan.hoods[neighborhood_id]
        slotwise = isinstance(kernel, SlotwiseKernel)
        L, R = self.plan.L, self.plan.R
        static_in = tuple(n for n in fields_in if n not in fields_out)
        spec, tables = self._pass_tables(hood, False, slotwise)
        key = ("steploop", kernel, fields_in, fields_out, n_extra, L, R, spec)
        fn = self._program_cache.get(key)
        if fn is not None:
            return fn, tables, static_in

        n_static, n_out, n_tab = len(static_in), len(fields_out), len(tables)

        def fn(n_steps, *args):
            tabs, args = args[:n_tab], args[n_tab:]
            statics = {n: a[0] for n, a in zip(static_in, args[:n_static])}
            # fresh state tensors: the caller's arrays stay untouched,
            # and the steps then update the copies in place
            state = [a[0].clone() for a in args[n_static:n_static + n_out]]
            extra = args[n_static + n_out:]
            run = _make_pass(spec, tabs, L, fields_out)
            for _ in range(int(n_steps)):
                full = dict(statics)
                full.update(zip(fields_out, state))
                flat = {n: full[n] for n in fields_in}
                cell_fields = {n: f[:L] for n, f in flat.items()}
                result = run(kernel, cell_fields, flat, extra)
                for j, n in enumerate(fields_out):
                    state[j][:L] = result[n].to(state[j].dtype)
            return tuple(s[None] for s in state)

        fn.step_path = "roll" if spec[0] == "closed" else "table"
        self._program_cache[key] = fn
        return fn, tables, static_in

    def run_steps(
        self,
        kernel,
        fields_in,
        fields_out,
        n_steps,
        exchange_fields=None,
        neighborhood_id=DEFAULT_NEIGHBORHOOD_ID,
        extra_args=(),
        bulk=True,
    ) -> None:
        """Run ``n_steps`` stencil steps and install the results (see
        compile_step_loop); ``last_step_path`` records the path that
        ran. Extras become float32 tensors where they are Python
        numbers, as the reference's weakly typed scalars do."""
        fields_in = tuple(fields_in)
        fields_out = tuple(fields_out)
        extra_args = _as_extra(extra_args)
        with telemetry.span("grid.step"):
            fn, tables, static_in = self.compile_step_loop(
                kernel, fields_in, fields_out, exchange_fields,
                neighborhood_id, n_extra=len(extra_args), bulk=bulk,
            )
            out = fn(
                int(n_steps),
                *tables,
                *(self.data[n] for n in static_in),
                *(self.data[n] for n in fields_out),
                *extra_args,
            )
            for n, arr in zip(fields_out, out):
                self.data[n] = arr
        self.last_step_path = fn.step_path
        # DCCRG_WATCHDOG=N: check the stepped fields for NaN/Inf every
        # ~N steps (one device reduction, one host read), so a silent
        # blow-up surfaces as NumericsError
        wd = resilience.watchdog_interval()
        if wd > 0:
            self._watchdog_accum += int(n_steps)
            if self._watchdog_accum >= wd:
                self._watchdog_accum = 0
                resilience.assert_finite(self, fields_out)
