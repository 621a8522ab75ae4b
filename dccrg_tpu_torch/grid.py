"""The grid runtime of the PyTorch port.

PyTorch counterpart of ``dccrg_tpu/grid.py``:

- **Structure is host state**: the sorted cell list, owners and the
  neighbor plan are numpy arrays. A complete level-0 grid gets the
  closed-form plan (uniform.py; ``DCCRG_FORCE_TABLES=1`` gives it dense
  tables instead), a refined grid the hybrid plan (hybrid.py;
  ``DCCRG_FORCE_GENERIC=1`` the generic builder below), with the
  reference's dispatch order and capacity names, so ``L``, ``R``, rows
  and tables come out as the reference's.
- **Data is device state**: each per-cell field is one tensor of shape
  ``[n_dev, R, ...]``, one row block per partition. A partition's rows
  are ``[inner | outer | pad | ghost copies | pad | zero row]``
  (``R = L + G + 1``; one partition has no ghosts, ``R = L + 1``).
- **Partitions**: ``initialize([dev] * n)`` runs the grid on n
  partitions, every one on the same device (a later slice of the port
  puts each on its own card). The partitioner (partition.py) assigns
  owners; the halo exchange (``update_copies_of_remote_neighbors``, the
  split-phase calls and the step loop) moves each partition's send
  rows into the ghost rows of its peers with one ``index_select`` and
  one ``index_copy_`` per peer offset; ``balance_load`` repartitions
  and moves the data with one gather per field. Refined grids run on
  partitions too: the hybrid and generic plans carry ghost rows, and an
  AMR commit moves cells between partitions.
- **Stencils**: on a closed-form plan an eligible step loop goes
  through the bulk executor (ops/roll_executor.py, a CUDA kernel on the
  card); everything else gathers neighbors slot by slot with exact 3-D
  ``torch.roll``s (closed-form plans) or by index from the dense
  ``[L, S]`` tables (``index_select`` on the field, masked slots read
  the zero row). Hybrid plans run the kernel again over their compact
  hard-row tables and write those rows over the bulk result.
- **AMR**: ``refine_completely`` and friends queue requests,
  ``stop_refining`` resolves them (amr.py), rebuilds the plan and moves
  the surviving cells' rows, on any partition, on the device.

With ``n_dev > 1`` a stencil runs partition by partition over the
closed-form plan (a flat roll plus exact fixup rows, a ``block``
partition) or the dense tables, then a hybrid plan's hard rows; the
overlapped step runs the exchange's sends on a side CUDA stream under
the bulk pass, recomputes the outer rows after the receive and runs the
hard rows last, on the received ghosts.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field as dataclass_field

import numpy as np
import torch

from . import background, faults, resilience, telemetry
from .geometry import CartesianGeometry, NoGeometry, StretchedCartesianGeometry
from .mapping import Mapping
from .neighbors import (build_neighbor_lists, find_neighbors_of,
                        find_neighbors_to_subset, make_neighborhood,
                        validate_neighborhood, verify_tiling)
from .partition import (PARTITION_METHODS, partition_cells,
                        partition_cells_hierarchical)
from .topology import GridTopology
from .txn import grid_transaction
from .types import ERROR_CELL
from . import uniform as uniform_mod
from . import verify as verify_mod

logger = logging.getLogger(__name__)

# Parity with the reference's default neighborhood id (dccrg.hpp:99).
DEFAULT_NEIGHBORHOOD_ID = -0xDCC

_allocator_tuned = False
_libc = None  # set by _tune_allocator; None = opted out or unavailable


def _tune_allocator():
    """Raise glibc's mmap and trim thresholds before the first plan
    build (the reference's ``_tune_allocator``, dccrg_tpu/grid.py:74):
    large numpy temporaries otherwise go through mmap and fault in every
    page on every rebuild. Applied once and lazily, so importing the
    package leaves the process's malloc alone; ``DCCRG_NO_MALLOPT=1``
    opts out."""
    global _allocator_tuned, _libc
    if _allocator_tuned:
        return
    _allocator_tuned = True
    if os.environ.get("DCCRG_NO_MALLOPT") == "1":
        return
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
        _libc = libc
    except Exception:
        pass


def _trim_allocator():
    """Hand the freed heap back to the OS after a large plan build
    (``malloc_trim(0)``): with the raised trim threshold ``free`` alone
    never trims. Called once the build's frame is gone."""
    if _libc is None:
        return
    try:
        _libc.malloc_trim(0)
    except Exception:
        pass


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


# What waits for the slice that places partitions on distinct cards:
# the only refusal left in the port.
NEXT_SLICE = "ROADMAP.md queue 1, item 5b.1"


def resolve_partitions(device=None) -> list:
    """The partitions an entry point runs on, one device each: ``device``
    may be None (one partition on the card), a device, or a list of
    devices (one partition each). Every partition lives on the same
    device; a list naming distinct devices raises NotImplementedError
    (``NEXT_SLICE``)."""
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty device list")
        devs = [resolve_device(d) for d in device]
    else:
        devs = [resolve_device(device)]
    if any(d != devs[0] for d in devs[1:]):
        raise NotImplementedError(
            f"partitions on distinct devices {sorted(set(map(str, devs)))}: "
            f"every partition shares one device until {NEXT_SLICE}")
    return devs


def single_device(device, what: str) -> torch.device:
    """``device`` resolved for an entry point that runs on one
    partition; a list of more than one device raises
    NotImplementedError naming ``NEXT_SLICE``."""
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise NotImplementedError(
                f"{what} runs on one device; {len(device)} devices wait "
                f"for {NEXT_SLICE}")
        device = device[0]
    return resolve_device(device)


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


def _synth_prep(synth, L, device, row_gidx=None):
    """(grid index, base validity) per row for closed-form mask
    synthesis: from the row index on a one-partition plan (rows ARE grid
    order), or from one partition's ``[L]`` grid indices
    (``device_row_ids()[p, :L]``, -1 on pad rows) on a partitioned
    closed-form plan, whose rows are ``[inner | outer]``."""
    if row_gidx is not None:
        return torch.clamp(row_gidx, min=0), row_gidx >= 0
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


def _synth_mask(synth, L, device, row_gidx=None):
    """Closed-form [L, S] validity mask (stack of _synth_col)."""
    gidx, base_valid = _synth_prep(synth, L, device, row_gidx)
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


def slot_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a kernel's neighbour slots or a field's
    lanes), one slot after the other: the order is fixed whatever the
    leading shape and however many trailing zero slots a table's
    capacity adds, so a row's sum is the same bits on any plan, batch
    or device (a library reduction picks its order by shape)."""
    s = x[..., 0]
    for j in range(1, x.shape[-1]):
        s = s + x[..., j]
    return s


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

    # iteration covers every input field, gathering each as it is read
    def __iter__(self):
        return iter(self._fields)

    def __len__(self):
        return len(self._fields)

    def keys(self):
        return self._fields.keys()

    def items(self):
        return ((n, self[n]) for n in self._fields)

    def values(self):
        return (self[n] for n in self._fields)

    def get(self, name, default=None):
        return self[name] if name in self._fields else default


def _make_roll_fixup_gather(shifts, L, fixups):
    """Partitioned closed-form slot gather (the reference's
    ``_make_nbr_slot_gather`` in roll mode): roll the partition's local
    rows by the slot's flat shift, then copy the exact source rows into
    the rows the roll gets wrong (partition edges, wraps and every ghost
    read); masked slots read zero. ``fixups[j]`` is ``(rows [W_j],
    src [W_j])``, int64 on the device, pad entries cut off."""
    def gather(fl, j, mask_j):
        col = torch.roll(fl[:L], -int(shifts[j]), dims=0)
        wr, ws = fixups[j]
        if wr.numel():
            col.index_copy_(0, wr, fl.index_select(0, ws))
        mexp = mask_j.reshape(tuple(mask_j.shape) + (1,) * (col.dim() - 1))
        return torch.where(mexp, col, col.new_zeros(()))

    return gather


def _slot_gather_all(gather, nmask, n_slots):
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
    neighbor column, when the slot function first reads it. PyTorch
    runs eagerly, so each slot's gathered columns are freed before the
    next slot's are made."""
    carry = kernel.init(cell_fields, *extra)
    for j in range(n_slots):
        mj = mask_col(j)
        nbr_j = _GatheredNeighbors(
            fields, lambda v, j=j, mj=mj: gather(v, j, mj))
        carry = kernel.slot(carry, cell_fields, nbr_j, offs_col(j), mj,
                            *extra)
    return kernel.finish(carry, cell_fields, *extra)


def _as_extra(extra_args):
    """Stencil extras as tensors: Python numbers become float32, as the
    reference's weakly typed scalars do."""
    return tuple(e if isinstance(e, torch.Tensor)
                 else torch.as_tensor(e, dtype=torch.float32)
                 for e in extra_args)


def _flat_shifts(synth):
    """Flat row shift of each slot of a partitioned closed-form plan
    (``ox + nx * (oy + ny * oz)``, the roll plan's shifts)."""
    (nx, ny, _nz), _per, _n0, offs_cells, *_ = synth
    return [ox + nx * (oy + ny * oz) for ox, oy, oz in offs_cells]


def _make_pass(spec, tabs, L, fields_out):
    """``run(kernel, cell_fields, flat, extra) -> result`` for one
    stencil pass over one partition (see Grid._pass_tables for ``spec``
    and the order of ``tabs``): the bulk pass over the dense or
    closed-form plan, then on a split plan the kernel over the hard
    rows, their results written over the bulk result's rows (the
    reference's merge order, dccrg_tpu/grid.py:2882-2893).
    ``run(..., hard=False)`` leaves the hard rows out, and
    ``run.hard(kernel, cell_fields, flat, extra, result)`` runs them
    alone over ``result`` (the overlapped step runs them after the
    halos land, as the reference's loop does).
    ``run.repass(kernel, flat, extra, rows, nbr_rows, zero_masked)``
    runs the kernel as a dense kernel at a row subset whose ``[k, S]``
    neighbor rows are given (the overlapped step's outer rows).
    Per-call setup (masks, premasked offsets) is made here, once per
    call."""
    kind, synth, uniform_offs, scaled, split, include_to, slotwise = spec
    tabs = list(tabs)
    nmask = None
    if kind in ("closed", "closed_multi"):
        offs_dev = tabs.pop(0)
        device = offs_dev.device
        n_slots = len(synth[3])
        row_gidx = None
        if kind == "closed":
            roll = _make_roll3d_gather(synth, L)
        else:
            row_gidx = tabs.pop(0)
            fixups = [(tabs[2 * j], tabs[2 * j + 1]) for j in range(n_slots)]
            del tabs[:2 * n_slots]
            roll = _make_roll_fixup_gather(_flat_shifts(synth), L, fixups)
        sgidx, sbase = _synth_prep(synth, L, device, row_gidx)
        if slotwise:
            masks = [_synth_col(synth, sgidx, sbase, j) for j in range(n_slots)]
            slot_gather, mask_col = roll, masks.__getitem__
        else:
            nmask = _synth_mask(synth, L, device, row_gidx)
            gather_all = _slot_gather_all(roll, nmask, n_slots)

        def mask_rows(rows):
            g, b = sgidx[rows], sbase[rows]
            return torch.stack([_synth_col(synth, g, b, j)
                                for j in range(n_slots)], dim=1)

        noffs = offs_dev
    else:
        nrows, noffs, nmask = tabs[:3]
        del tabs[:3]
        if slotwise:  # slot-major [S, L] rows and mask
            n_slots = nrows.shape[0]
            slot_gather = _table_slot_gather(nrows)
            mask_col = nmask.__getitem__
            mask_rows = lambda rows: nmask[:, rows].T
        else:
            gather_all = _table_gather_all(nrows)
            mask_rows = lambda rows: nmask[rows]
    raw_offs = noffs
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

    def run(kernel, cell_fields, flat, extra, hard=True):
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
        return run_hard(kernel, cell_fields, flat, extra, result) if hard \
            else result

    def run_hard(kernel, cell_fields, flat, extra, result):
        if not split:
            return result
        # second pass over the hard rows (near refinement) with their
        # own, wider tables; results overwrite those rows
        h_cell = {n: v.index_select(0, hr) for n, v in cell_fields.items()}
        h_nbr = _GatheredNeighbors(flat, h_gather)
        h_result = kernel(h_cell, h_nbr, hof, hm, *extra)
        result = dict(result)
        for n in fields_out:
            result[n] = result[n].index_put(
                (hr,), h_result[n].to(result[n].dtype))
        return result

    def repass(kernel, flat, extra, rows, nbr_rows, zero_masked):
        # the reference's outer re-pass body (dccrg_tpu/grid.py:3247-3265)
        m = mask_rows(rows)
        cell = {n: v.index_select(0, rows) for n, v in flat.items()}

        def gather(v):
            g = v[nbr_rows]
            if zero_masked:  # a roll's masked slots hold junk
                mexp = m.reshape(tuple(m.shape) + (1,) * (g.dim() - 2))
                g = torch.where(mexp, g, g.new_zeros(()))
            return g

        nbr = _GatheredNeighbors(flat, gather)
        if uniform_offs:
            offs = m[:, :, None] * raw_offs[None, :, :]
            if scaled:
                offs = offs * sc0[rows][:, None, None]
        else:
            offs = raw_offs[rows]
        return kernel(cell, nbr, offs, m, *extra)

    run.repass = repass
    run.hard = run_hard
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
    takes the plain roll path.

    ``ghost_deps`` optionally declares per-output ghost dependencies
    (``{out_field: (in_fields whose NEIGHBOR values out_field reads)}``),
    the overlapped step's ghost-split contract (see
    :func:`ghost_split_enabled`); a missing output defaults to all of
    ``fields_in``."""

    def __init__(self, init, slot, finish, device_flux=None,
                 device_params=None, ghost_deps=None):
        self.init = init
        self.slot = slot
        self.finish = finish
        self.device_flux = device_flux
        self.device_params = device_params
        if ghost_deps is not None:
            self.ghost_deps = {k: tuple(v)
                               for k, v in dict(ghost_deps).items()}

    def __call__(self, cell_fields, nbr_fields, offs, mask, *extra):
        """The kernel as a plain dense kernel (slots looped over axis
        1), for the surface-sized hard-row pass of a hybrid plan."""
        return _run_slotwise(
            self, cell_fields, nbr_fields,
            lambda v, j, mj: v[:, j],
            (lambda j: offs[:, j]) if offs.dim() == 3 else
            (lambda j: offs[j]),
            lambda j: mask[..., j], mask.shape[-1], extra)


def ghost_split_enabled(default: bool = True) -> bool:
    """The ``DCCRG_GHOST_SPLIT`` knob (default on): a kernel that
    declares ``ghost_deps`` has the overlapped step re-run only the
    outer rows that read a ghost of an exchanged field, and scatter only
    the outputs whose declared ghost reads meet the exchanged set.
    ``0`` keeps the full re-pass; kernels without a declaration are
    never split."""
    v = os.environ.get("DCCRG_GHOST_SPLIT", "")
    if v == "":
        return default
    return v not in ("0", "off", "false", "no")


def _flat(t: torch.Tensor) -> torch.Tensor:
    """``[n_dev * R, ...]`` view of an ``[n_dev, R, ...]`` field: row
    ``p * R + r`` is partition ``p``'s row ``r``."""
    return t.view((-1,) + tuple(t.shape[2:]))


def _halo_send(flat, src):
    """One peer offset's sends (the reference's ``_halo_send``,
    dccrg_tpu/grid.py:191): the sender rows ``src`` of every partition
    (flat rows of :func:`_flat`), in receiver order."""
    return flat.index_select(0, src)


def _halo_scatter(flat, dst, payload):
    """A received payload into the receivers' ghost rows ``dst`` (the
    reference's ``_halo_scatter``; its ``-1`` slots are not in ``dst``)."""
    flat.index_copy_(0, dst, payload)


def _send_halos(state, exch_idx, groups, stream):
    """The sends of one exchange, every peer offset of every exchanged
    field (``state[j]`` for ``j`` in ``exch_idx``, ``groups`` their
    :meth:`Grid._exchange_groups`); on ``stream`` (the overlapped step's
    side CUDA stream) when given, ordered after the main stream's work
    and handed back to it."""
    if stream is None:
        return [[_halo_send(_flat(state[j]), src) for src, _dst in g]
                for j, g in zip(exch_idx, groups)]
    main = torch.cuda.current_stream(stream.device)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        out = [[_halo_send(_flat(state[j]), src) for src, _dst in g]
               for j, g in zip(exch_idx, groups)]
    for per in out:
        for t in per:
            t.record_stream(main)
    return out


def _land_halos(state, exch_idx, groups, payloads, stream, R):
    """The receives of one exchange into the ghost rows, in place, the
    zero row zeroed again (dccrg_tpu/grid.py:2264), after the side
    stream's sends when there is one."""
    if stream is not None:
        torch.cuda.current_stream(stream.device).wait_stream(stream)
    for j, g, per in zip(exch_idx, groups, payloads):
        fl = _flat(state[j])
        for (_src, dst), payload in zip(g, per):
            _halo_scatter(fl, dst, payload)
        state[j][:, R - 1] = 0


@dataclass
class CellView:
    """A set of cells exposed for iteration (the reference's ``cells`` /
    ``inner_cells()`` views, dccrg.hpp:7547-7718): ids and the owning
    partition of each."""

    ids: np.ndarray  # uint64 cell ids
    owner: np.ndarray  # partition index per cell

    def __len__(self):
        return len(self.ids)

    def __iter__(self):
        return iter(self.ids)


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
        # closed-form plans: the mask is synthesized from the row's grid
        # index and the roll shifts arithmetically (dict with
        # dims/periodic/offsets/n0, and "multi" on several partitions)
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
        self._pair_host = {}  # predicate-filtered and per-offset pair tables

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
    R: int  # total rows per partition (L + ghost capacity + 1 zero row)
    n_local: np.ndarray  # [n_dev]
    local_ids: list  # per partition: uint64 ids in row order [inner|outer]
    row_of_pos: np.ndarray  # int32 [n_cells]: row on the owner partition
    ghost_ids: list  # per partition: uint64 ids in ghost-row order
    hoods: dict = dataclass_field(default_factory=dict)  # hood id -> _HoodPlan
    epoch: int = 0


class Grid:
    """Cartesian cell-refinable grid on one or more partitions.

    Mirrors the reference's fluent construction protocol
    (dccrg.hpp:8242-8357):

        grid = (Grid(cell_data={"density": torch.float32})
                .set_initial_length((64, 64, 64))
                .set_periodic(True, True, True)
                .set_neighborhood_length(1)
                .initialize())          # on the card; device="cpu" for the CPU

    ``initialize([torch.device("cuda")] * 4)`` runs the same grid on
    four partitions of the card (``["cpu"] * n`` on the CPU), the list
    taking the place of the reference's device mesh.
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
        self._lb_method = "morton"
        self.initialized = False
        # load balancing state (dccrg.hpp:5590-6380)
        self._staged_balance = {}
        self._pending_owner = None
        self._pins = {}
        self._weights = {}
        self._partitioning_options = {}
        self._partitioning_levels = []  # hierarchical partitioning
        self._balance_added = {}
        self._balance_removed = {}
        # per-field transfer predicates (receiver-dependent payloads)
        self._transfer_predicates = {}
        self._pending = {}  # in-flight split-phase halo updates
        self.last_overlap = None  # the overlapped step's mode, step loop
        self._cells_epoch = 0  # bumped whenever the cell set changes
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
        self._txn_depth = 0  # reentrancy counter (txn.grid_transaction)
        self._txn_plan = None  # the open transaction's rollback plan
        self._txn_frozen = None  # ids of the snapshot's field tensors
        # delta-checkpoint dirty tracking (the incremental saves of
        # supervise.CheckpointStore): the fields whose SAVED bytes may
        # differ from the last checkpoint baseline (None = every field,
        # the state every wholesale load or rebuild resets to), and the
        # structure epoch a delta chain is valid within (any change of
        # the cell set or the partitions bumps it and forces a keyframe)
        self._ckpt_dirty = None
        self._ckpt_epoch = 0
        # cached per-epoch data items (dccrg.hpp:7404-7518): name -> fn,
        # and their values, recomputed at every structure rebuild
        self._cell_items = {}
        self._cell_item_values = {}
        self._neighbor_items = {}
        self._neighbor_item_values = {}
        # the background plan build awaiting its swap (DCCRG_BG_RECOMMIT)
        self._bg_build = None
        self.last_bg_install = None  # seconds of the last swap, by part
        # DCCRG_DEBUG=1: the verifiers after every rebuild, and verify_all
        # at every transactional mutation boundary (txn.py)
        self._debug = os.environ.get("DCCRG_DEBUG") == "1"

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

    def set_load_balancing_method(self, method: str):
        """The partitioner of ``initialize`` and ``balance_load``
        (partition.PARTITION_METHODS; ``morton`` by default, as the
        reference)."""
        if method not in PARTITION_METHODS:
            raise ValueError(f"unknown method {method!r}, have {PARTITION_METHODS}")
        self._lb_method = method
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

    def initialize(self, device=None, partition: str | None = None):
        """Build the level-0 grid (dccrg.hpp:480-562) on the partitions
        ``device`` names: None is one partition on the card, a device
        one partition there, a list of n devices n partitions (each the
        same device; distinct devices raise NotImplementedError).
        ``partition`` picks the partitioner of the level-0 cells
        (partition.PARTITION_METHODS), the load balancing method when
        None."""
        self._require_uninitialized()
        self.devices = resolve_partitions(device)
        self.device = self.devices[0]
        self.n_dev = len(self.devices)
        # every partition is this process's (the multi-process slice
        # fills this from the process group)
        self._proc_local_dev = np.ones(self.n_dev, dtype=bool)

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

        # level-0 cells, partitioned (create_level_0_cells,
        # dccrg.hpp:8089)
        n0 = self.mapping.length.total_level0_cells
        cells = np.arange(1, n0 + 1, dtype=np.uint64)
        owner = partition_cells(
            self.mapping, cells, self.n_dev, partition or self._lb_method,
            pins=self._pins or None,
        )
        self.initialized = True
        self._build_plan(cells, owner)
        self._allocate_fields()
        if self._debug:
            verify_mod.pin_requests_succeeded(self)
        return self

    def clone(self, cell_data=None) -> "Grid":
        """A new grid with this one's structure (cells, partitions,
        neighbour tables, neighborhoods, pins, weights, partitioning
        options) and its own zero-initialized cell data, optionally of
        another schema: the reference's cross-Cell_Data copy constructor
        (dccrg.hpp:344-446). The clone's plan is built anew, so it
        shares no table, no arena buffer and no tensor with this grid;
        a write to either leaves the other unchanged."""
        if not self.initialized:
            raise RuntimeError("clone() requires an initialized grid")
        spec = cell_data if cell_data is not None else dict(self.fields)
        other = Grid(cell_data=spec)
        other._length = self._length
        other._max_ref_lvl = self._max_ref_lvl
        other._periodic = self._periodic
        other._hood_len = self._hood_len
        other._lb_method = self._lb_method
        other._geometry_kind = self._geometry_kind
        other._pins = dict(self._pins)
        other._weights = dict(self._weights)
        other._partitioning_options = dict(self._partitioning_options)
        other._partitioning_levels = [dict(lv) for lv in
                                      self._partitioning_levels]
        other.devices = list(self.devices)
        other.device = self.device
        other.n_dev = self.n_dev
        other._proc_local_dev = self._proc_local_dev.copy()
        other.mapping = Mapping(
            tuple(int(v) for v in self.mapping.length.get()),
            self.mapping.max_refinement_level,
        )
        other.topology = GridTopology(self._periodic)
        kind, params = self._geometry_kind
        if kind == "none":
            other.geometry = NoGeometry(other.mapping, other.topology)
        elif kind == "cartesian":
            other.geometry = CartesianGeometry(other.mapping, other.topology,
                                               **params)
        else:
            other.geometry = StretchedCartesianGeometry(
                other.mapping, other.topology, **params)
        other.neighborhoods = {hid: offs.copy()
                               for hid, offs in self.neighborhoods.items()}
        other.initialized = True
        other._build_plan(self.plan.cells.copy(), self.plan.owner.copy())
        other._allocate_fields()
        return other

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
        that knows its dirty set; only the hybrid builder reads it. A
        pending background build installs first: builds are serialized
        per grid."""
        self.bg_install(wait=True)
        self._finish_plan(self._construct_plan(cells, owner, changed_hint))

    def _construct_plan(self, cells, owner, changed_hint=None):
        """A plan for ``(cells, owner)``, not installed (the reference's
        ``_construct_plan``, dccrg_tpu/grid.py:944): after a build of
        more than 2^20 cells the allocator is trimmed, once the impl's
        frame and its temporaries are gone."""
        plan = self._build_plan_impl(cells, owner, changed_hint)
        if len(cells) > 1 << 20:
            _trim_allocator()
        return plan

    def _build_plan_impl(self, cells, owner, changed_hint=None):
        """The reference's dispatch (dccrg_tpu/grid.py:964-1077): the
        closed-form (or forced dense-table) plan for a complete level-0
        grid, the hybrid plan for a refined one, and the generic
        builder under ``DCCRG_FORCE_GENERIC=1``."""
        _tune_allocator()
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
        # the forced mode this plan was built under, which the fallback
        # chain (resilience._apply_mode) compares before a rebuild
        self._plan_gather_mode = ("tables" if os.environ.get(
            "DCCRG_FORCE_TABLES") == "1" else None)
        self._update_data_items()
        # continuous self-checking, as the reference's DEBUG builds
        # (dccrg.hpp:12454-13036). Inside a transaction its post-commit
        # verify_all covers these on the final state; user data is still
        # moving here, so _install_plan checks it after the move. Pin
        # placement is checked where pins are applied.
        if self._debug and not self._txn_depth:
            verify_mod.is_consistent(self)
            verify_mod.verify_neighbors(self)
            verify_mod.verify_remote_neighbor_info(self)

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
        # the live plan and the open transaction's rollback plan keep
        # their buffers: an aborted build never scribbles on a plan a
        # rollback restores
        arena.begin(protect=(getattr(self, "plan", None), self._txn_plan))
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
        """The generic builder (dccrg_tpu/grid.py:990-1077): the full
        neighbor lists of every hood; a cell with a neighbor on another
        partition (of- or to-list of the default hood) is outer, its
        partition's rows ``[inner | outer]``; each partition's ghost
        rows hold the remote cells its of- and to-gathers read, in id
        order; each cell's entries left-compacted into ``[n_dev, L, S]``
        tables with explicit offsets."""
        n_dev = self.n_dev
        hood_lists = {
            hid: build_neighbor_lists(self.mapping, self.topology, cells, offs)
            for hid, offs in self.neighborhoods.items()
        }
        hood_gidx = {
            hid: (np.searchsorted(cells, hl.of_neighbor),
                  np.searchsorted(cells, hl.to_neighbor))
            for hid, hl in hood_lists.items()
        }
        nl = hood_lists[DEFAULT_NEIGHBORHOOD_ID]
        nbr_idx, to_nbr_idx = hood_gidx[DEFAULT_NEIGHBORHOOD_ID]
        outer_flag = np.zeros(len(cells), dtype=bool)
        outer_flag[nl.of_source[owner[nl.of_source] != owner[nbr_idx]]] = True
        outer_flag[nl.to_source[owner[nl.to_source] != owner[to_nbr_idx]]] = True

        local_ids, ghost_ids = [], []
        n_inner = np.zeros(n_dev, np.int64)
        for d in range(n_dev):
            mine = owner == d
            inner = cells[mine & ~outer_flag]
            local_ids.append(np.concatenate([inner, cells[mine & outer_flag]]))
            n_inner[d] = len(inner)
            gh = []
            for hid, hl in hood_lists.items():
                of_g, to_g = hood_gidx[hid]
                m = (owner[hl.of_source] == d) & (owner[of_g] != d)
                gh.append(hl.of_neighbor[m])
                m2 = (owner[hl.to_source] == d) & (owner[to_g] != d)
                gh.append(hl.to_neighbor[m2])
            ghost_ids.append(np.unique(np.concatenate(gh)))

        n_local = np.array([len(x) for x in local_ids], dtype=np.int64)
        L = self._sticky_cap("L", max(1, int(n_local.max())))
        G = max(len(x) for x in ghost_ids) if n_dev > 1 else 0
        G = self._sticky_cap("G", G) if G else 0
        # row_by_gidx[d, position] -> row on partition d (-1: none);
        # row_of_pos is the owner's row
        row_by_gidx = np.full((n_dev, len(cells)), -1, dtype=np.int32)
        row_of_pos = np.full(len(cells), -1, dtype=np.int32)
        for d in range(n_dev):
            lpos = np.searchsorted(cells, local_ids[d])
            lrows = np.arange(len(local_ids[d]), dtype=np.int32)
            row_by_gidx[d, lpos] = lrows
            row_of_pos[lpos] = lrows
            if len(ghost_ids[d]):
                row_by_gidx[d, np.searchsorted(cells, ghost_ids[d])] = (
                    L + np.arange(len(ghost_ids[d]), dtype=np.int32))
        layout = dict(L=L, R=L + G + 1, n_local=n_local, local_ids=local_ids,
                      row_of_pos=row_of_pos, ghost_ids=ghost_ids)
        plan = self._new_plan(cells, owner, layout)
        for hid, offs in self.neighborhoods.items():
            plan.hoods[hid] = self._build_hood_plan(
                plan, hood_lists[hid], offs,
                n_inner if hid == DEFAULT_NEIGHBORHOOD_ID else None,
                hood_gidx[hid], row_by_gidx, hid)
        return plan

    def _build_hood_plan(self, plan, nl, offsets, n_inner, gidx, row_by_gidx,
                         hid):
        """One hood of the generic plan (dccrg_tpu/grid.py:1220-1306):
        each entry's row on its source's partition, slot = rank within
        the (partition, row) group in stream order, ``S`` a sticky
        capacity; the send/receive lists from the ghost rows."""
        n_dev, L, R = plan.n_dev, plan.L, plan.R
        cells, owner = plan.cells, plan.owner

        def build_table(src_gidx, nbr_gidx, offs_arr):
            entry_dev = owner[src_gidx].astype(np.int64)
            src_rows = row_by_gidx[entry_dev, src_gidx].astype(np.int64)
            nrows = row_by_gidx[entry_dev, nbr_gidx]
            # a neighbour without a row on its reader's partition would
            # alias the zero row
            if len(nrows) and int(nrows.min()) < 0:
                raise AssertionError(
                    "ghost coverage bug: neighbor without a row on its "
                    "reader's partition")
            key = entry_dev * L + src_rows
            order = np.argsort(key, kind="stable")
            ksort = key[order]
            m = len(ksort)
            if m == 0:
                return (np.full((n_dev, L, 1), R - 1, dtype=np.int32),
                        np.zeros((n_dev, L, 1, 3), dtype=np.int32),
                        np.zeros((n_dev, L, 1), dtype=bool))
            change = np.empty(m, dtype=bool)
            change[0] = True
            change[1:] = ksort[1:] != ksort[:-1]
            group_start = np.maximum.accumulate(
                np.where(change, np.arange(m), 0))
            slot = np.arange(m) - group_start
            S = self._sticky_cap(("S", hid), max(1, int(slot.max()) + 1))
            rows = np.full((n_dev * L * S,), R - 1, dtype=np.int32)
            offs = np.zeros((n_dev * L * S, 3), dtype=np.int32)
            mask = np.zeros((n_dev * L * S,), dtype=bool)
            flat = ksort * S + slot
            rows[flat] = nrows[order]
            offs[flat] = offs_arr[order]
            mask[flat] = True
            return (rows.reshape(n_dev, L, S), offs.reshape(n_dev, L, S, 3),
                    mask.reshape(n_dev, L, S))

        nbr_rows, nbr_offs, nbr_mask = build_table(
            nl.of_source, gidx[0], nl.of_offset)

        def to_tables():
            return build_table(nl.to_source, gidx[1], nl.to_offset)

        ghost_pos = [np.searchsorted(cells, plan.ghost_ids[q])
                     for q in range(n_dev)]
        pair_compact = uniform_mod.build_pair_tables(
            ghost_pos, n_dev,
            lambda keys: owner[keys],
            lambda p_s, keys: row_by_gidx[p_s, keys],
            lambda q_s, keys, gpos: row_by_gidx[q_s, keys],
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

    @property
    def _multiproc(self) -> bool:
        """True when the grid's partitions span processes this one
        cannot address (a process group, or a test faking the split
        through ``_proc_local_dev``)."""
        return not bool(self._proc_local_dev.all())

    def _allocate_fields(self):
        self.data = {}
        for name, (shape, dtype) in self.fields.items():
            self.data[name] = torch.zeros((self.n_dev, self.plan.R) + shape,
                                          dtype=dtype, device=self.device)
        self._mark_ckpt_dirty()

    def _mark_ckpt_dirty(self, fields=None) -> None:
        """Record fields whose saved bytes may have changed since the
        last delta-checkpoint baseline (read by the incremental saves of
        :mod:`dccrg_tpu_torch.supervise`); ``None`` marks every field.
        Ghost-only writes (the halo receives) never call this: a
        checkpoint serializes owned rows only."""
        if fields is None:
            self._ckpt_dirty = None
        elif getattr(self, "_ckpt_dirty", None) is not None:
            self._ckpt_dirty.update(fields)

    def device_row_ids(self) -> torch.Tensor:
        """``[n_dev, R]`` tensor of ``cell id - 1`` per row (``-1`` on
        pad rows), ghost rows included. On a complete level-0 grid on
        one partition it is made on the device from an arange (rows are
        id order, int32); otherwise it is uploaded from
        ``plan.local_ids`` and ``plan.ghost_ids`` (int64 once ids
        exceed int32). Cached per structure epoch."""
        plan = self.plan
        cached = getattr(plan, "_row_ids_dev", None)
        if cached is not None:
            return cached
        n0 = self.mapping.length.total_level0_cells
        if (self.n_dev == 1 and len(plan.cells) == n0
                and int(plan.cells[-1]) == n0):
            idx = torch.arange(plan.R, dtype=torch.int32, device=self.device)
            arr = torch.where(idx < n0, idx, torch.full_like(idx, -1))[None, :]
        else:
            wide = int(plan.cells[-1]) > np.iinfo(np.int32).max
            host = np.full((self.n_dev, plan.R), -1,
                           dtype=np.int64 if wide else np.int32)
            for d in range(self.n_dev):
                host[d, :int(plan.n_local[d])] = \
                    plan.local_ids[d].astype(np.int64) - 1
                ng = len(plan.ghost_ids[d])
                if ng:  # ghost rows sit at [L, L + ng)
                    host[d, plan.L:plan.L + ng] = \
                        plan.ghost_ids[d].astype(np.int64) - 1
            arr = torch.as_tensor(host, device=self.device)
        plan._row_ids_dev = arr
        return arr

    def local_row_mask(self) -> torch.Tensor:
        """``[n_dev, R] float32`` mask: 1 on each partition's local rows,
        0 on ghost and pad rows — the device-side reduction mask.
        Cached per structure epoch."""
        plan = self.plan
        cached = getattr(plan, "_local_mask_dev", None)
        if cached is not None:
            return cached
        rows = torch.arange(plan.R, dtype=torch.int64, device=self.device)
        nl = torch.as_tensor(np.asarray(plan.n_local, dtype=np.int64),
                             device=self.device)
        arr = (rows[None, :] < nl[:, None]).to(torch.float32)
        plan._local_mask_dev = arr
        return arr

    def _host_rows(self, ids):
        """(partition, row) for each cell id (host lookup)."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.uint64))
        cells = self.plan.cells
        pos = np.searchsorted(cells, ids)
        if np.any(pos >= len(cells)) or np.any(
                cells[np.minimum(pos, len(cells) - 1)] != ids):
            if self._bg_build is not None:
                # a deferred recommit may hold the epoch these ids
                # belong to (adapt, then project onto the new
                # children): a data access that needs the new epoch is
                # a swap boundary — install (blocking) and retry
                self.bg_install(wait=True)
                return self._host_rows(ids)
            raise KeyError("unknown cell id(s)")
        return self.plan.owner[pos], self.plan.row_of_pos[pos].astype(np.int64)

    def _flat_rows(self, dev, rows) -> torch.Tensor:
        """Rows of :func:`_flat` views for ``(partition, row)`` pairs."""
        return torch.as_tensor(
            np.asarray(dev, dtype=np.int64) * self.plan.R + rows,
            device=self.device)

    def get(self, field: str, ids) -> np.ndarray:
        """Host read of per-cell data from the owner's row (reference
        operator[] access). bfloat16 fields come back as float32 (numpy
        has no bfloat16; the widening is exact)."""
        scalar = np.isscalar(ids) or np.asarray(ids).ndim == 0
        dev, rows = self._host_rows(ids)
        flat = _flat(self.data[field])
        out = _host_numpy(flat.index_select(0, self._flat_rows(dev, rows)))
        return out[0] if scalar else out

    def set(self, field: str, ids, values) -> None:
        """Host write of per-cell data (init / tests / boundary setup)."""
        self.set_many(ids, {field: values})

    def set_many(self, ids, values_by_field, preserve_ghosts=True) -> None:
        """Host write of several fields for the same cell set into the
        owners' rows; the row resolution happens once. With
        ``preserve_ghosts=False`` and ``ids`` covering every cell, the
        fields start from zero tensors instead of being written in
        place: ghost rows read zero until the next halo exchange. When
        an id repeats, its last value wins."""
        self._mark_ckpt_dirty(values_by_field)
        ids = np.atleast_1d(np.asarray(ids, dtype=np.uint64))
        dev, rows = self._host_rows(ids)
        flat = dev.astype(np.int64) * self.plan.R + rows
        keep = None
        if (len(ids) > 1 and not np.all(ids[1:] > ids[:-1])
                and len(np.unique(flat)) != len(flat)):
            _, last_rev = np.unique(flat[::-1], return_index=True)
            keep = np.sort(len(flat) - 1 - last_rev)
            flat = flat[keep]
        flat_t = torch.as_tensor(flat, device=self.device)
        fresh = not preserve_ghosts and len(ids) == len(self.plan.cells)
        for name, values in values_by_field.items():
            shape, dtype = self.fields[name]
            vals = (values if isinstance(values, torch.Tensor)
                    else torch.as_tensor(np.asarray(values)))
            vals = vals.to(device=self.device, dtype=dtype)
            if keep is not None:
                vals = vals.expand((len(ids),) + tuple(shape))[
                    torch.as_tensor(keep, device=self.device)]
            if fresh:
                self.data[name] = torch.zeros_like(self.data[name])
            _flat(self._own(name))[flat_t] = vals

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

    # -- iteration views by partition (dccrg.hpp:7594-7718) -----------

    def _n_inner(self, d):
        return int(self.plan.hoods[DEFAULT_NEIGHBORHOOD_ID].n_inner[d])

    def _view_of(self, ids):
        ids = np.sort(ids)
        pos = np.searchsorted(self.plan.cells, ids)
        return CellView(ids, self.plan.owner[pos])

    def is_inner(self, cell) -> bool:
        """True when no neighbor relation of the cell crosses a
        partition boundary (dccrg_iterator_support.hpp:33-56)."""
        pos = self._cell_pos(cell)
        if pos is None:
            raise ValueError(f"unknown cell {cell}")
        d = int(self.plan.owner[pos])
        return int(self.plan.row_of_pos[pos]) < self._n_inner(d)

    def is_outer(self, cell) -> bool:
        return not self.is_inner(cell)

    def local_cells(self) -> CellView:
        return CellView(self.plan.cells.copy(), self.plan.owner.copy())

    def all_cells(self) -> CellView:
        return self.local_cells()

    def inner_cells(self) -> CellView:
        return self._view_of(np.concatenate(
            [self.plan.local_ids[d][:self._n_inner(d)]
             for d in range(self.n_dev)]))

    def outer_cells(self) -> CellView:
        return self._view_of(np.concatenate(
            [self.plan.local_ids[d][self._n_inner(d):self.plan.n_local[d]]
             for d in range(self.n_dev)]))

    def remote_cells(self) -> CellView:
        """Cells with copies on a partition that does not own them."""
        ghosts = [g for g in self.plan.ghost_ids if len(g)]
        return self._view_of(np.unique(np.concatenate(ghosts)) if ghosts
                             else np.empty(0, np.uint64))

    def get_process(self, cell) -> int:
        """Owning partition of a cell (the reference's cell_process)."""
        pos = self._cell_pos(cell)
        if pos is None:
            raise ValueError(f"unknown cell {cell}")
        return int(self.plan.owner[pos])

    def get_comm_size(self) -> int:
        """Partition count (the reference's communicator size)."""
        return self.n_dev

    def get_number_of_cells(self) -> int:
        return len(self.plan.cells)

    def neighbor_devices(self, neighborhood_id=DEFAULT_NEIGHBORHOOD_ID) -> np.ndarray:
        """``[n_dev, n_dev]`` bool: ``[q, p]`` true when partition q
        receives halo data from partition p — the peer sets of
        Some_Reduce (dccrg_mpi_support.hpp:285-380)."""
        c = self.plan.hoods[neighborhood_id].pair_compact
        out = np.zeros((self.n_dev, self.n_dev), dtype=bool)
        out[c["q"], c["p"]] = True
        return out

    # -- neighbor queries (dccrg.hpp:831-3236) -------------------------

    def _cell_pos(self, cell):
        """Index of ``cell`` in the sorted cell list, or None for an
        unknown id."""
        pos = int(np.searchsorted(self.plan.cells, np.uint64(cell)))
        if pos >= len(self.plan.cells) or self.plan.cells[pos] != np.uint64(cell):
            return None
        return pos

    def is_local(self, cell, device=None) -> bool:
        """Whether ``cell`` exists (``device=None``: host code sees every
        partition, so every existing cell is local) or is owned by
        partition ``device``."""
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

    def get_remote_neighbors_of(self, cell,
                                neighborhood_id=DEFAULT_NEIGHBORHOOD_ID,
                                sorted: bool = False):
        """Neighbors of ``cell`` owned by another partition than the
        cell (dccrg.hpp:3175-3234)."""
        return self._remote_neighbors(cell, neighborhood_id, sorted, to=False)

    def get_remote_neighbors_to(self, cell,
                                neighborhood_id=DEFAULT_NEIGHBORHOOD_ID,
                                sorted: bool = False):
        """Cells that consider ``cell`` a neighbor and live on another
        partition (dccrg.hpp:3236-3296)."""
        return self._remote_neighbors(cell, neighborhood_id, sorted, to=True)

    def _remote_neighbors(self, cell, neighborhood_id, sorted, to):
        hood = self.plan.hoods.get(neighborhood_id)
        pos = self._cell_pos(cell)
        if hood is None or pos is None:
            return np.empty(0, np.uint64)
        get = self._cell_neighbors_to if to else self._cell_neighbors_of
        nbrs, _ = get(pos, hood)
        own = int(self.plan.owner[pos])
        nbr_owner = self.plan.owner[np.searchsorted(self.plan.cells, nbrs)]
        out = nbrs[nbr_owner != own]
        return np.sort(out) if sorted else out

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

    def get_maximum_refinement_level_difference(self) -> int:
        """Parity with dccrg.hpp:6752: neighbours differ by at most one
        refinement level."""
        return 1

    # -- cached data items (dccrg.hpp:7404-7518: user mixins whose
    # update() runs at cache rebuild, e.g. Is_Local / Center in
    # tests/advection/cell.hpp). An item is a vectorized function over
    # the whole cell (or neighbour-entry) set, evaluated on the host at
    # every structure rebuild: initialize, commit, balance, load and a
    # background plan's install.

    def add_cell_data_item(self, name: str, fn) -> None:
        """Register ``fn(grid, ids) -> array``, recomputed at every
        structure rebuild and cached for the epoch."""
        self._cell_items[name] = fn
        if self.initialized:
            self._cell_item_values[name] = np.asarray(
                fn(self, self.plan.cells))

    def remove_cell_data_item(self, name: str) -> None:
        self._cell_items.pop(name, None)
        self._cell_item_values.pop(name, None)

    def cell_data_item(self, name: str, ids=None) -> np.ndarray:
        """The cached item values, for all cells (plan order) or the
        given ids."""
        vals = self._cell_item_values[name]
        if ids is None:
            return vals.copy()
        scalar = np.isscalar(ids) or np.asarray(ids).ndim == 0
        ids = np.atleast_1d(np.asarray(ids, dtype=np.uint64))
        cells = self.plan.cells
        pos = np.searchsorted(cells, ids)
        if np.any(pos >= len(cells)) or np.any(
                cells[np.minimum(pos, len(cells) - 1)] != ids):
            raise KeyError("unknown cell id(s)")
        out = vals[pos]
        return out[0] if scalar else out

    def add_neighbor_data_item(self, name: str, fn,
                               neighborhood_id=DEFAULT_NEIGHBORHOOD_ID) -> None:
        """Register ``fn(grid, src_ids, nbr_ids, offsets) -> array`` over
        the neighborhood's flat neighbour entries, recomputed at every
        structure rebuild."""
        self._neighbor_items[name] = (fn, neighborhood_id)
        if self.initialized:
            nl = self.plan.hoods[neighborhood_id].lists
            self._neighbor_item_values[name] = np.asarray(
                fn(self, self.plan.cells[nl.of_source], nl.of_neighbor,
                   nl.of_offset))

    def remove_neighbor_data_item(self, name: str) -> None:
        self._neighbor_items.pop(name, None)
        self._neighbor_item_values.pop(name, None)

    def neighbor_data_item(self, name: str, cell=None) -> np.ndarray:
        """Item values for all neighbour entries, or one cell's."""
        vals = self._neighbor_item_values[name]
        if cell is None:
            return vals.copy()
        _, hid = self._neighbor_items[name]
        nl = self.plan.hoods[hid].lists
        pos = self._cell_pos(cell)
        if pos is None:
            raise ValueError(f"unknown cell {cell}")
        return vals[nl.of_source == pos]

    def _update_data_items(self) -> None:
        for name, fn in self._cell_items.items():
            self._cell_item_values[name] = np.asarray(fn(self, self.plan.cells))
        # drop items whose neighborhood has been removed
        for name in [n for n, (_, hid) in self._neighbor_items.items()
                     if hid not in self.plan.hoods]:
            self.remove_neighbor_data_item(name)
        for name, (fn, hid) in self._neighbor_items.items():
            nl = self.plan.hoods[hid].lists
            self._neighbor_item_values[name] = np.asarray(
                fn(self, self.plan.cells[nl.of_source], nl.of_neighbor,
                   nl.of_offset))

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

    def remove_neighborhood(self, neighborhood_id) -> None:
        """Drop a user neighborhood and rebuild the plan."""
        if neighborhood_id == DEFAULT_NEIGHBORHOOD_ID:
            raise ValueError("cannot remove the default neighborhood")
        self.neighborhoods.pop(neighborhood_id, None)
        if self.initialized:
            self._build_plan(self.plan.cells, self.plan.owner)

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

        On n partitions a child takes its refined parent's partition, a
        merged parent its first child's (``amr.resolve_adaptation``;
        pins and weights pass to the children), and every surviving
        cell moves to its new partition and row in one gather per field
        (``_install_plan``).

        Atomic (txn.py): a failure anywhere in the commit rolls the grid
        back bit for bit, request sets, pins and weights included, and
        raises :class:`~dccrg_tpu_torch.txn.MutationAbortedError`; the
        same commit can then be retried."""
        from .amr import resolve_adaptation

        with telemetry.span("grid.adapt"), \
                grid_transaction(self, op="stop_refining"):
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
                pins=self._pins,
                weights=self._weights,
                topology=self.topology,
                hood_len=self._hood_len,
            )
            faults.fire("adapt.commit", phase="resolved")
            self._refines.clear()
            self._unrefines.clear()
            self._dont_refines.clear()
            self._dont_unrefines.clear()

            # preserve the data of disappearing cells for the app's
            # projection: one device-side gather per field over every
            # partition's rows, pulled to host
            old_ids = np.concatenate([res.refined_parents, res.removed_cells])
            self._removed_data = {}
            if len(old_ids):
                rows_t = self._flat_rows(*self._host_rows(old_ids))
                for name in self.fields:
                    vals = _flat(self.data[name]).index_select(0, rows_t)
                    self._removed_data[name] = (old_ids, _host_numpy(vals))
            else:
                self._removed_data = {name: (old_ids, None) for name in self.fields}
            faults.fire("adapt.commit", phase="preserved")
            self._removed_cells = res.removed_cells
            self._new_cells = res.new_cells
            self._unrefined_parents = res.unrefined_parents
            self._restructure(res.cells, res.owner, changed=res.changed_cells,
                              defer_ok=True)
            return res.new_cells.copy()

    def _restructure(self, new_cells, new_owner, changed=None,
                     defer_ok=False):
        """Rebuild the plan for a new cell set and carry the surviving
        cells' data over (the reference's rebuild, dccrg.hpp:10642-10690,
        with the data movement folded in). ``changed`` is the commit's
        dirty set of ids, handed to the hybrid builder.

        With ``DCCRG_BG_RECOMMIT=1`` and ``defer_ok`` (the
        ``stop_refining`` commit; a balance lands its staged data on the
        new plan at once, so it never defers) the plan is built on a
        background worker while stepping continues on the live plan;
        :meth:`run_steps` (and ``GridBatch.step``) installs the finished
        plan at the next step boundary (:meth:`bg_install`). Until the
        swap, queries and checkpoints see the previous epoch."""
        with telemetry.span("grid.recommit"):
            self._restructure_impl(new_cells, new_owner, changed, defer_ok)

    def _restructure_impl(self, new_cells, new_owner, changed,
                          defer_ok=False):
        # builds are serialized per grid: a pending background plan
        # installs (or rebuilds inline) before a new one starts
        self.bg_install(wait=True)
        old_plan = self.plan
        same_cells = (len(new_cells) == len(old_plan.cells)
                      and np.array_equal(new_cells, old_plan.cells))
        if same_cells:
            changed_hint = (old_plan.cells, np.empty(0, dtype=np.uint64))
        elif changed is not None:
            changed_hint = (old_plan.cells, changed)
        else:
            changed_hint = None
        if defer_ok and background.bg_recommit_enabled():
            self._bg_build = background.PlanBuildWorker(
                self, new_cells, new_owner, changed_hint).start()
            return
        plan = self._construct_plan(new_cells, new_owner, changed_hint)
        self._install_plan(plan)

    def _install_plan(self, plan):
        """Install a built plan as the live structure epoch and move
        each surviving cell from its old (partition, row) to its new
        one on the device (one gather per field over the flat rows of
        every partition; rows of new cells, ghost and pad rows and the
        zero row start at zero). Always on the thread that owns the
        grid: the swap point of a background build."""
        old_plan = self.plan
        if not (len(plan.cells) == len(old_plan.cells)
                and np.array_equal(plan.cells, old_plan.cells)):
            # the cell-set epoch (caches keyed on the cell set)
            self._cells_epoch += 1
        # any restructure (cell set OR partitions) ends the delta
        # checkpoint's structure epoch: the offset table derives from
        # the cells, so the next periodic save is a keyframe
        self._ckpt_epoch += 1
        self._mark_ckpt_dirty()
        surviving = plan.cells[np.isin(plan.cells, old_plan.cells)]
        src = self._flat_rows(*self._host_rows(surviving))
        self._finish_plan(plan)
        faults.fire("grid.restructure", phase="planned")
        dst = self._flat_rows(*self._host_rows(surviving))
        for name, (shape, dtype) in self.fields.items():
            moved = torch.zeros((self.n_dev, plan.R) + shape, dtype=dtype,
                                device=self.device)
            _flat(moved).index_copy_(
                0, dst, _flat(self.data[name]).index_select(0, src))
            self.data[name] = moved
        faults.fire("grid.restructure", phase="moved")
        if self._debug and not self._txn_depth:
            verify_mod.verify_user_data(self)

    def _own(self, name) -> torch.Tensor:
        """``data[name]``, safe to write in place: a tensor the open
        transaction's snapshot holds is cloned and installed first, so a
        rollback restores it unchanged (txn.py)."""
        t = self.data[name]
        if self._txn_frozen and id(t) in self._txn_frozen:
            t = self.data[name] = t.clone()
        return t

    # -- background recommit (DCCRG_BG_RECOMMIT; see background.py) ----

    def bg_pending(self) -> bool:
        """True while a background plan build is in flight or awaiting
        its step-boundary swap."""
        return self._bg_build is not None

    def bg_install(self, wait: bool = False) -> bool:
        """The step-boundary swap point: install the background-built
        plan if it is finished (``wait=True`` blocks for it; the
        residual stall lands in ``dccrg_recommit_stall_seconds``) and
        move the surviving cells' data, as the synchronous restructure
        would. A worker failure falls back to the inline rebuild here.
        The install runs in its own transaction, so a failure mid-swap
        (injected faults included) rolls back to the live pre-swap epoch
        and raises MutationAbortedError. Returns True when a plan was
        installed; :attr:`last_bg_install` then holds the seconds of
        the wait, the swap and the build (on the worker)."""
        bg = self._bg_build
        if bg is None:
            return False
        if not bg.ready() and not wait:
            return False
        t0 = time.perf_counter()
        bg.wait()
        t1 = time.perf_counter()
        # consumed before the swap transaction: its entry barrier (and
        # any nested mutation) must not re-enter this install
        self._bg_build = None
        with telemetry.span("grid.recommit.swap"), \
                grid_transaction(self, op="bg_recommit_swap"):
            if bg.error is not None or bg.plan is None:
                logger.warning(
                    "background recommit worker failed (%r); rebuilding "
                    "inline", bg.error)
                plan = self._construct_plan(bg.cells, bg.owner,
                                            bg.changed_hint)
            else:
                plan = bg.plan
            self._install_plan(plan)
        t2 = time.perf_counter()
        telemetry.observe("dccrg_recommit_stall_seconds", t2 - t1,
                          where="swap")
        self.last_bg_install = {"wait": t1 - t0, "swap": t2 - t1,
                                "build": bg.seconds}
        return True

    def bg_discard(self) -> None:
        """Drop a pending background build without installing it (the
        transaction-rollback path: an aborted mutation leaves the live
        plan and the snapshot plan as they were). Blocks until the
        worker has stopped touching the arena; the orphaned
        generation's buffers are reclaimed by the next build."""
        bg = self._bg_build
        if bg is None:
            return
        bg.done.wait()
        self._bg_build = None

    def _prewarm_plan(self, plan) -> None:
        """Derive on the background worker the host tables the first
        post-swap step would otherwise derive on the step loop, memoized
        on the new plan's hoods: on n partitions, the per-peer-offset
        exchange tables of every field without a transfer predicate (one
        shared pair record, so the capacities they take do not depend on
        the order the fields are met in) and, when the overlapped step
        runs, the outer re-pass rows. The reference prewarms its roll
        decomposition of table plans; the port gathers by index and has
        none. Host work only; best-effort (a failure re-surfaces at the
        first step)."""
        if plan.n_dev < 2:
            return
        try:
            names = tuple(n for n in sorted(self.fields)
                          if n not in self._transfer_predicates)
            for hid in plan.hoods:
                self._pair_tables_host(hid, names, plan=plan)
            hid = DEFAULT_NEIGHBORHOOD_ID
            hood = plan.hoods[hid]
            if hood.n_inner is not None and self._use_overlap():
                cf = hood.closed_form
                use_roll = cf is not None and bool(cf.get("multi"))
                roll = hood.roll_plan(plan.L) if use_roll else None
                self._outer_tables(hid, hood, use_roll,
                                   roll[0] if use_roll else None, roll,
                                   plan=plan)
        except Exception:  # noqa: BLE001 - prewarm must never kill a build
            logger.debug("plan prewarm failed", exc_info=True)

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

    # -- load balancing (dccrg.hpp:1046-1064, 3770-4182, 8482-8720) ----

    def balance_load(self, use_zoltan: bool = True) -> None:
        """Repartition cells over the partitions and move their data
        (dccrg.hpp:1046): the three stages in a row.
        ``use_zoltan=False`` keeps the partition but for pin requests
        (the reference's flag). The ``balance.commit`` fault phases fire
        in the reference's order: ``partition`` and ``stage`` before any
        change of state, ``finish`` before the rebuild and ``land``
        after it.

        Atomic (txn.py): the three stages run in one transaction, so a
        failure in any of them rolls the whole balance back
        (:class:`~dccrg_tpu_torch.txn.MutationAbortedError`) and the grid
        keeps its partition, data placement and staging."""
        with telemetry.span("grid.balance"), \
                grid_transaction(self, op="balance_load"):
            self.initialize_balance_load(use_zoltan)
            self.continue_balance_load()
            self.finish_balance_load()

    def initialize_balance_load(self, use_zoltan: bool = True) -> None:
        """Stage 1: compute the new partition (dccrg.hpp:3770-3909):
        the load balancing method (or the hierarchy levels) with the
        cell weights, pin requests merged afterwards
        (dccrg.hpp:8552-8576); the ``cut`` method reads the default
        neighborhood's edges."""
        if self._pending_owner is not None:
            raise RuntimeError("balance_load already initialized")
        with grid_transaction(self, op="initialize_balance_load"):
            self._initialize_balance_load_impl(use_zoltan)

    def _initialize_balance_load_impl(self, use_zoltan: bool) -> None:
        self._staged_balance = {}
        cells = self.plan.cells
        if use_zoltan:
            weights = None
            if self._weights:
                weights = np.ones(len(cells), dtype=np.float64)
                for cid, w in self._weights.items():
                    pos = np.searchsorted(cells, np.uint64(cid))
                    if pos < len(cells) and cells[pos] == np.uint64(cid):
                        weights[pos] = w
            edges = None
            methods = [lv.get("method") for lv in self._partitioning_levels]
            if self._lb_method == "cut" or "cut" in methods:
                # the edges depend on the cell set only: cached until it
                # changes
                cached = getattr(self, "_cut_edges", None)
                if cached is not None and cached[0] == self._cells_epoch:
                    edges = cached[1]
                else:
                    nl = self.plan.hoods[DEFAULT_NEIGHBORHOOD_ID].lists
                    edges = (nl.of_source.astype(np.int64),
                             np.searchsorted(cells, nl.of_neighbor))
                    self._cut_edges = (self._cells_epoch, edges)
            if self._partitioning_levels:
                new_owner = partition_cells_hierarchical(
                    self.mapping, cells, self.n_dev,
                    self._partitioning_levels,
                    weights=weights, pins=self._pins or None, edges=edges,
                )
            else:
                new_owner = partition_cells(
                    self.mapping, cells, self.n_dev, self._lb_method,
                    weights=weights, pins=self._pins or None, edges=edges,
                )
        else:
            new_owner = self.plan.owner.copy()
            for cid, dest in self._pins.items():
                pos = np.searchsorted(cells, np.uint64(cid))
                if pos < len(cells) and cells[pos] == np.uint64(cid):
                    new_owner[pos] = dest
        faults.fire("balance.commit", phase="partition")
        self._pending_owner = new_owner

    def continue_balance_load(self, fields=None) -> None:
        """Stage 2: capture the data of the cells that change owner, for
        the given fields (dccrg.hpp:3932-3964). Callable repeatedly with
        other fields (the reference's multi-stage protocol): what a
        stage captures is what lands at ``finish_balance_load``, even
        if the source changes in between. Fields no stage captured move
        with their current values at finish. The capture is one device
        gather of the moving rows per field."""
        if self._pending_owner is None:
            raise RuntimeError("initialize_balance_load not called")
        names = list(fields) if fields is not None else list(self.fields)
        for n in names:
            if n not in self.fields:
                raise KeyError(f"unknown field {n!r}")
        # validate=False: a stage only captures gathered rows; no
        # structure the verifiers check changes
        with grid_transaction(self, op="continue_balance_load",
                              validate=False):
            faults.fire("balance.commit", phase="stage")
            moving = self.plan.cells[self._pending_owner != self.plan.owner]
            src = (self._flat_rows(*self._host_rows(moving)) if len(moving)
                   else None)
            for n in names:
                self._staged_balance[n] = (
                    moving.copy(),
                    _flat(self.data[n]).index_select(0, src) if len(moving)
                    else None)

    def staged_balance_data(self, field: str):
        """(moving cell ids, values) a stage captured for a field — the
        receiver-side peek between stages."""
        ids, snap = self._staged_balance[field]
        if snap is None:
            return ids.copy(), None
        return ids.copy(), _host_numpy(snap)

    def finish_balance_load(self) -> None:
        """Stage 3: install the new partition, rebuild the structure
        (dccrg.hpp:3980-4182) and land the captured values at the
        moved cells' new rows. Atomic: a failure rolls back to the staged
        state, so finish can be retried."""
        if self._pending_owner is None:
            raise RuntimeError("initialize_balance_load not called")
        with grid_transaction(self, op="finish_balance_load"):
            self._finish_balance_load_impl()

    def _finish_balance_load_impl(self) -> None:
        new_owner = self._pending_owner
        faults.fire("balance.commit", phase="finish")
        cells = self.plan.cells
        moved = cells[new_owner != self.plan.owner]
        pos = np.searchsorted(cells, moved)
        self._balance_added = {d: moved[new_owner[pos] == d]
                               for d in range(self.n_dev)}
        self._balance_removed = {d: moved[self.plan.owner[pos] == d]
                                 for d in range(self.n_dev)}
        self._pending_owner = None
        staged = self._staged_balance
        self._staged_balance = {}
        self._restructure(cells.copy(), new_owner)
        faults.fire("balance.commit", phase="land")
        if self._debug:
            verify_mod.pin_requests_succeeded(self)
        dst = None
        for n, (ids, snap) in staged.items():
            if snap is None or n not in self.fields:
                continue
            if dst is None:
                dst = self._flat_rows(*self._host_rows(ids))
            # the moved rows land in the tensors _restructure made
            _flat(self._own(n)).index_copy_(
                0, dst, snap.to(self.data[n].dtype))

    def get_cells_added_by_balance_load(self, device: int | None = None):
        """Cells the last balance moved ONTO a partition (every moved
        cell when ``device`` is None)."""
        added = self._balance_added
        if device is not None:
            return added.get(int(device), np.empty(0, np.uint64)).copy()
        return (np.sort(np.concatenate(list(added.values())))
                if added else np.empty(0, np.uint64))

    def get_cells_removed_by_balance_load(self, device: int | None = None):
        """Cells the last balance moved OFF a partition."""
        removed = self._balance_removed
        if device is not None:
            return removed.get(int(device), np.empty(0, np.uint64)).copy()
        return (np.sort(np.concatenate(list(removed.values())))
                if removed else np.empty(0, np.uint64))

    def get_pin_requests(self) -> dict:
        """Current pin requests ``{cell id: partition}``."""
        return dict(self._pins)

    # pinning (dccrg.hpp:5913-6139)

    def pin(self, cell, process: int) -> bool:
        """Force a cell onto a partition across future balances."""
        if not self.is_local(cell) or not 0 <= int(process) < self.n_dev:
            return False
        self._pins[int(cell)] = int(process)
        return True

    def unpin(self, cell) -> bool:
        return self._pins.pop(int(cell), None) is not None

    def unpin_local_cells(self, device: int | None = None) -> None:
        """Remove the pins of cells owned by ``device`` (every pin when
        None); pins of cells that no longer exist go too."""
        for cid in list(self._pins):
            if not self.is_local(cid):
                del self._pins[cid]
            elif device is None or self.get_process(cid) == device:
                del self._pins[cid]

    def unpin_all_cells(self) -> None:
        self._pins.clear()

    # cell weights (dccrg.hpp:6318-6380)

    def set_cell_weight(self, cell, weight: float) -> bool:
        if not self.is_local(cell) or weight < 0:
            return False
        self._weights[int(cell)] = float(weight)
        return True

    def get_cell_weight(self, cell) -> float:
        return self._weights.get(int(cell), 1.0)

    # partitioning options (dccrg.hpp:5590-5880): recorded for parity;
    # 'method' / 'LB_METHOD' selects the partitioner

    def set_partitioning_option(self, name: str, value) -> None:
        if name.upper() in ("LB_METHOD", "METHOD"):
            self.set_load_balancing_method(str(value))
        self._partitioning_options[name] = value

    def get_partitioning_options(self, hierarchial_partitioning_level: int | None = None):
        """The options dict, or (with a level) that hierarchy level's
        option names (dccrg.hpp:5814)."""
        if hierarchial_partitioning_level is None:
            return dict(self._partitioning_options)
        lv = self._hierarchy_level(hierarchial_partitioning_level)
        return [k for k in lv if k not in ("processes", "method")]

    # hierarchical partitioning (dccrg.hpp:5629-5880)

    def _hierarchy_level(self, level: int) -> dict:
        if not 0 <= int(level) < len(self._partitioning_levels):
            raise IndexError(
                f"no hierarchial partitioning level {level} "
                f"(have {len(self._partitioning_levels)})")
        return self._partitioning_levels[int(level)]

    def add_partitioning_level(self, processes: int):
        """Append a hierarchy level whose parts hold ``processes``
        partitions each (dccrg.hpp:5634)."""
        if int(processes) < 1:
            raise ValueError("processes per part must be >= 1")
        self._partitioning_levels.append({"processes": int(processes)})
        return self

    def remove_partitioning_level(self, hierarchial_partitioning_level: int):
        self._hierarchy_level(hierarchial_partitioning_level)
        del self._partitioning_levels[int(hierarchial_partitioning_level)]
        return self

    def add_partitioning_option(self, level: int, name: str, value):
        """Set an option on a hierarchy level (dccrg.hpp:5731);
        'LB_METHOD' / 'method' selects that level's partitioner."""
        lv = self._hierarchy_level(level)
        lv[name] = value
        if name.upper() in ("LB_METHOD", "METHOD"):
            method = str(value).lower()
            if method not in PARTITION_METHODS:
                raise ValueError(
                    f"unknown method {value!r} for level {level}, have "
                    f"{PARTITION_METHODS}")
            lv["method"] = method
        return self

    def remove_partitioning_option(self, level: int, name: str):
        lv = self._hierarchy_level(level)
        lv.pop(name, None)
        if name.upper() in ("LB_METHOD", "METHOD"):
            lv.pop("method", None)
        return self

    def get_partitioning_option_value(self, level: int, name: str):
        return self._hierarchy_level(level).get(name)

    def load_cells(self, cells) -> None:
        """Replace the grid structure with an arbitrary valid cell set
        (the reference's load_cells, dccrg.hpp:3669-3738), partitioned
        by the load balancing method and pins; the data of every cell
        is reset."""
        cells = np.asarray(cells, dtype=np.uint64)
        if len(cells) > 1 and not np.all(cells[1:] >= cells[:-1]):
            cells = np.sort(cells)
        verify_tiling(self.mapping, cells)
        with grid_transaction(self, op="load_cells"):
            owner = partition_cells(self.mapping, cells, self.n_dev,
                                    self._lb_method, pins=self._pins or None)
            self._cells_epoch += 1
            self._ckpt_epoch += 1
            self._build_plan(cells, owner)
            self._allocate_fields()
            if self._debug:
                verify_mod.pin_requests_succeeded(self)

    # -- checkpoint / restart (dccrg.hpp:1109-2426) --------------------

    def write_vtk_file(self, filename: str, fields=None) -> None:
        """ASCII VTK dump of the leaf cells (dccrg.hpp:3320-3392), see
        :func:`dccrg_tpu_torch.utils.vtk.write_vtk_file`."""
        from .utils.vtk import write_vtk_file

        write_vtk_file(self, filename, fields=fields)

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

    # -- halo exchange (dccrg.hpp:978-1014, 5046-5413) -----------------

    def set_transfer_predicate(self, field: str, fn) -> None:
        """Per-peer selection of what a cell sends (the reference's
        5-argument ``get_mpi_datatype``, dccrg_get_cell_datatype.hpp:
        48-213): ``fn(cell_ids, sender, receiver, neighborhood_id) ->
        bool array`` is sampled per partition pair when the exchange
        tables are built; a False entry drops that cell's ``field``
        payload for that pair on both sides. ``None`` clears it; a
        closure whose behavior changes must be registered again."""
        if not self.initialized:
            raise RuntimeError(
                "set_transfer_predicate() requires initialize() first "
                "(predicates are sampled against the built plan)")
        if fn is None:
            self._transfer_predicates.pop(field, None)
        else:
            if field not in self.fields:
                raise KeyError(f"unknown field {field!r}")
            self._transfer_predicates[field] = fn
        for hood in self.plan.hoods.values():
            hood._pair_host.clear()
            for k in [k for k in hood._dev
                      if isinstance(k[0], tuple) and k[0][0] == "xg"]:
                del hood._dev[k]
            for attr in ("_split_outer", "_orp"):
                if hasattr(hood, attr):
                    delattr(hood, attr)

    @staticmethod
    def _pair_groups(c):
        """(starts, ends) of the (sender, receiver) groups of a compact
        pair record (entries are sorted by (p, q))."""
        pq = c["p"] * np.int64(c["n_dev"]) + c["q"]
        starts = np.r_[0, np.flatnonzero(np.diff(pq)) + 1] \
            if len(pq) else np.empty(0, np.int64)
        ends = np.r_[starts[1:], len(pq)] if len(pq) else starts
        return starts.astype(np.int64), ends.astype(np.int64)

    def _field_pair_compact(self, neighborhood_id, field, plan=None):
        """The hood's compact pair record, filtered by the field's
        transfer predicate if set (surviving entries keep their slot
        positions, so holes mirror the dense tables' -1 slots).
        ``plan`` defaults to the live plan (a background build passes
        its new one)."""
        plan = self.plan if plan is None else plan
        hood = plan.hoods[neighborhood_id]
        c = hood.pair_compact
        fn = self._transfer_predicates.get(field)
        if fn is None:
            return c
        cached = hood._pair_host.get(("c", field))
        if cached is not None:
            return cached
        keep = np.ones(len(c["p"]), dtype=bool)
        starts, ends = self._pair_groups(c)
        for s, e in zip(starts, ends):
            p0, q0 = int(c["p"][s]), int(c["q"][s])
            ids = plan.local_ids[p0][c["srow"][s:e]]
            k = np.asarray(fn(ids, p0, q0, neighborhood_id), dtype=bool)
            if k.shape != ids.shape:
                raise ValueError(
                    "transfer predicate must return one bool per cell")
            keep[s:e] = k
        out = dict(c)
        for key in ("p", "q", "pos", "srow", "rrow"):
            out[key] = c[key][keep]
        hood._pair_host[("c", field)] = out
        return out

    def _field_pair_tables(self, neighborhood_id, field, plan=None):
        """(send_rows, recv_rows) dense ``[n_dev, n_dev, M]`` views for
        one field: the all-to-all fallback and host introspection."""
        plan = self.plan if plan is None else plan
        hood = plan.hoods[neighborhood_id]
        if self._transfer_predicates.get(field) is None:
            return hood.send_rows, hood.recv_rows
        cached = hood._pair_host.get(field)
        if cached is not None:
            return cached
        out = uniform_mod.dense_pair_tables(self._field_pair_compact(
            neighborhood_id, field, plan))
        hood._pair_host[field] = out
        return out

    # exchanges with at most this many peer offsets move one compact
    # buffer per offset; more fall back to the dense all-to-all tables
    _MAX_PEER_OFFSETS = 8

    def _peer_deltas(self, neighborhood_id, plan=None):
        """Sorted partition-offset set ``{(q - p) mod n_dev}`` with halo
        traffic, or None for the dense all-to-all fallback (more than
        ``_MAX_PEER_OFFSETS`` offsets)."""
        hood = (self.plan if plan is None else plan).hoods[neighborhood_id]
        if ("deltas",) in hood._pair_host:
            return hood._pair_host[("deltas",)]
        c = hood.pair_compact
        deltas = tuple(sorted(set(
            np.unique((c["q"] - c["p"]) % self.n_dev).tolist())))
        if len(deltas) > self._MAX_PEER_OFFSETS:
            deltas = None
        hood._pair_host[("deltas",)] = deltas
        return deltas

    def _pair_tables_host(self, neighborhood_id, field_names, plan=None):
        """Per field and peer offset, the (send, recv) tables of the
        reference's ``_pair_tables_device`` (dccrg_tpu/grid.py:2171),
        as host arrays: ``[n_dev, Md]`` per offset (partition p sends
        its rows to p + d, partition q receives from q - d; ``Md`` a
        sticky ``("Md", hood, d)`` capacity), or the dense
        ``[n_dev, n_dev, M]`` pair on the fallback. Memoized on the
        hood."""
        plan = self.plan if plan is None else plan
        hood = plan.hoods[neighborhood_id]
        deltas = self._peer_deltas(neighborhood_id, plan)
        sends, recvs = [], []
        for n in field_names:
            if deltas is None:
                s, r = self._field_pair_tables(neighborhood_id, n, plan)
                sends.append(s)
                recvs.append(r)
                continue
            fc = dvec = None
            for d in deltas:
                key = ("peer", n, d)
                if key not in hood._pair_host:
                    if fc is None:
                        fc = self._field_pair_compact(neighborhood_id, n,
                                                      plan)
                        dvec = (fc["q"] - fc["p"]) % self.n_dev
                    sel = dvec == d
                    # the last valid slot (predicates may leave holes)
                    need = (int(fc["pos"][sel].max()) + 1
                            if sel.any() else 1)
                    Md = self._sticky_cap(("Md", neighborhood_id, d), need)
                    Md = min(Md, fc["M"])
                    sd = np.full((self.n_dev, Md), -1, dtype=np.int32)
                    rd = np.full((self.n_dev, Md), -1, dtype=np.int32)
                    inw = sel & (fc["pos"] < Md)
                    sd[fc["p"][inw], fc["pos"][inw]] = fc["srow"][inw]
                    rd[fc["q"][inw], fc["pos"][inw]] = fc["rrow"][inw]
                    hood._pair_host[key] = (sd, rd)
                sd, rd = hood._pair_host[key]
                sends.append(sd)
                recvs.append(rd)
        return tuple(sends), tuple(recvs)

    def _exchange_groups(self, neighborhood_id, field_names):
        """Per field, one ``(src, dst)`` pair of int64 device tensors
        per peer offset (one for the dense fallback): the senders' flat
        rows (``p * R + row``) in receiver order and the receivers' ghost
        rows they land in, the -1 slots of the tables left out. A send
        is one ``index_select``, a receive one ``index_copy_``.
        Memoized on the hood."""
        hood = self.plan.hoods[neighborhood_id]
        deltas = self._peer_deltas(neighborhood_id)
        n_dev, R, dev = self.n_dev, self.plan.R, self.device
        sends, recvs = self._pair_tables_host(neighborhood_id, field_names)
        n_t = 1 if deltas is None else len(deltas)
        out = []
        for i, n in enumerate(field_names):
            groups = []
            for t in range(n_t):
                key = (("xg", n, None if deltas is None else deltas[t]),
                       str(dev))
                hit = hood._dev.get(key)
                if hit is None:
                    sd, rd = sends[i * n_t + t], recvs[i * n_t + t]
                    if deltas is None:  # rd [dst q, src p, M]
                        q, p, m = np.nonzero(rd >= 0)
                        src = p * R + sd[p, q, m]
                        dst = q * R + rd[q, p, m]
                    else:
                        q, m = np.nonzero(rd >= 0)
                        p = (q - deltas[t]) % n_dev
                        src = p * R + sd[p, m]
                        dst = q * R + rd[q, m]
                    hit = (torch.as_tensor(src.astype(np.int64), device=dev),
                           torch.as_tensor(dst.astype(np.int64), device=dev))
                    hood._dev[key] = hit
                groups.append(hit)
            out.append(groups)
        return out

    def exchange_bytes(self, neighborhood_id=DEFAULT_NEIGHBORHOOD_ID,
                       fields=None) -> int:
        """Bytes one halo update of ``fields`` (every field when None)
        moves between partitions: each sent cell's row of each field."""
        names = tuple(sorted(fields)) if fields is not None else tuple(sorted(self.fields))
        total = 0
        for n in names:
            shape, dtype = self.fields[n]
            row = int(np.prod(shape, dtype=np.int64)) * \
                torch.empty((), dtype=dtype).element_size()
            total += row * self.get_number_of_update_send_cells(
                neighborhood_id, field=n)
        return total

    def _exchange_names(self, neighborhood_id, fields):
        if neighborhood_id not in self.plan.hoods:
            raise KeyError(f"unknown neighborhood {neighborhood_id!r}")
        unknown = [n for n in (fields or ()) if n not in self.fields]
        if unknown:
            raise KeyError(f"unknown field(s) {unknown}")
        return (tuple(sorted(fields)) if fields is not None
                else tuple(sorted(self.fields)))

    def update_copies_of_remote_neighbors(
        self, neighborhood_id=DEFAULT_NEIGHBORHOOD_ID, fields=None
    ) -> None:
        """Refresh the ghost copies of remote neighbors (dccrg.hpp:978):
        per exchanged field and peer offset, the senders' rows into the
        receivers' ghost rows, in place; ``fields`` selects the fields
        that move. One partition has no ghost rows, so nothing moves."""
        self._check_not_in_flight(neighborhood_id)
        names = self._exchange_names(neighborhood_id, fields)
        if self.n_dev == 1:
            return
        with telemetry.span("grid.exchange"):
            groups = self._exchange_groups(neighborhood_id, names)
            fields = [self._own(n) for n in names]
            idx = range(len(names))
            _land_halos(fields, idx, groups,
                        _send_halos(fields, idx, groups, None), None,
                        self.plan.R)

    def _check_not_in_flight(self, neighborhood_id):
        entry = self._pending.get(neighborhood_id)
        if entry is not None and entry[0] == self.plan.epoch:
            raise RuntimeError(
                f"neighborhood {neighborhood_id} already has an in-flight halo "
                "update; call wait_remote_neighbor_copy_updates first"
            )
        if entry is not None:
            # orphaned by a structure rebuild: superseded
            del self._pending[neighborhood_id]

    # split phase (dccrg.hpp:5046-5413): start takes the sends' copies;
    # wait writes ONLY the received ghost rows of the then-current
    # tensors, so local-row writes made in between survive (the
    # reference's receives touch remote neighbors only,
    # dccrg.hpp:10726-10935)
    def start_remote_neighbor_copy_updates(self, neighborhood_id=DEFAULT_NEIGHBORHOOD_ID,
                                           fields=None) -> None:
        self._check_not_in_flight(neighborhood_id)
        names = self._exchange_names(neighborhood_id, fields)
        if self.n_dev == 1:
            self._pending[neighborhood_id] = (self.plan.epoch, names, None)
            return
        with telemetry.span("grid.exchange.start"):
            groups = self._exchange_groups(neighborhood_id, names)
            payloads = _send_halos([self.data[n] for n in names],
                                   range(len(names)), groups, None)
        self._pending[neighborhood_id] = (self.plan.epoch, names,
                                          (groups, payloads))

    def wait_remote_neighbor_copy_updates(self, neighborhood_id=DEFAULT_NEIGHBORHOOD_ID) -> None:
        if neighborhood_id not in self._pending:
            return
        epoch, names, payloads = self._pending.pop(neighborhood_id)
        if epoch != self.plan.epoch:
            raise RuntimeError(
                "grid structure changed between start_remote_neighbor_copy_updates "
                "and wait_remote_neighbor_copy_updates; the in-flight halo payload "
                "is stale"
            )
        if payloads is None:  # one partition: nothing was sent
            return
        with telemetry.span("grid.exchange.wait"):
            groups, sent = payloads
            _land_halos([self._own(n) for n in names], range(len(names)),
                        groups, sent, None, self.plan.R)

    def wait_remote_neighbor_copy_update_receives(self, neighborhood_id=DEFAULT_NEIGHBORHOOD_ID) -> None:
        self.wait_remote_neighbor_copy_updates(neighborhood_id)

    def wait_remote_neighbor_copy_update_sends(self, neighborhood_id=DEFAULT_NEIGHBORHOOD_ID) -> None:
        pass

    def get_number_of_update_send_cells(
        self, neighborhood_id=DEFAULT_NEIGHBORHOOD_ID, field: str | None = None
    ) -> int:
        """Cells sent per halo update (dccrg.hpp:5428); with ``field``,
        after that field's transfer predicate."""
        if field is None:
            return len(self.plan.hoods[neighborhood_id].pair_compact["p"])
        return len(self._field_pair_compact(neighborhood_id, field)["p"])

    def get_number_of_update_receive_cells(
        self, neighborhood_id=DEFAULT_NEIGHBORHOOD_ID, field: str | None = None
    ) -> int:
        if field is None:
            return len(self.plan.hoods[neighborhood_id].pair_compact["q"])
        return len(self._field_pair_compact(neighborhood_id, field)["q"])

    def get_cells_to_send(self, neighborhood_id=DEFAULT_NEIGHBORHOOD_ID):
        """``{(sender, receiver): cell ids}`` of one halo update, from
        the senders' rows."""
        c = self.plan.hoods[neighborhood_id].pair_compact
        starts, ends = self._pair_groups(c)
        out = {}
        for s, e in zip(starts, ends):
            p0, q0 = int(c["p"][s]), int(c["q"][s])
            out[(p0, q0)] = self.plan.local_ids[p0][c["srow"][s:e]]
        return out

    def get_cells_to_receive(self, neighborhood_id=DEFAULT_NEIGHBORHOOD_ID):
        """``{(sender, receiver): cell ids}`` from the receivers' ghost
        rows, independently of :meth:`get_cells_to_send`."""
        c = self.plan.hoods[neighborhood_id].pair_compact
        starts, ends = self._pair_groups(c)
        L = self.plan.L
        out = {}
        for s, e in zip(starts, ends):
            p0, q0 = int(c["p"][s]), int(c["q"][s])
            out[(p0, q0)] = self.plan.ghost_ids[q0][c["rrow"][s:e] - L]
        return out

    def get_neighborhood_of(self, neighborhood_id=DEFAULT_NEIGHBORHOOD_ID):
        """The neighborhood's offset list."""
        return np.asarray(self.neighborhoods[neighborhood_id]).copy()

    def get_neighborhood_to(self, neighborhood_id=DEFAULT_NEIGHBORHOOD_ID):
        """Negated offsets (the to-direction items)."""
        return -self.get_neighborhood_of(neighborhood_id)

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
        """Run a gather-based stencil kernel over all local cells, one
        partition at a time.

        ``kernel(cell_fields, nbr_fields, offs, mask, *extra)`` receives
        one partition's ``cell_fields[name]`` ``[L, ...]``,
        ``nbr_fields[name]`` ``[L, S, ...]`` (neighbors gathered, ghost
        copies included; masked slots hold zeros or the zero row),
        ``offs`` ``[L, S, 3]`` (zero where the mask is off) and ``mask``
        ``[L, S]``; with ``include_to=True`` a second (nbr_to_fields,
        to_offs, to_mask) triple follows the mask. It returns a dict
        name -> ``[L, ...]`` for every name in ``fields_out``; the
        updated rows are written into new field tensors, ghost copies
        unchanged (call update_copies_of_remote_neighbors). A
        ``SlotwiseKernel`` is fed one slot at a time instead (no
        ``include_to``). Extras that are Python numbers become float32
        tensors.
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
        self._mark_ckpt_dirty(fields_out)

    def _use_overlap(self) -> bool:
        """The overlapped step (DCCRG_OVERLAP=0/1): the exchange's sends
        run on a side CUDA stream while the bulk pass runs on pre-exchange
        state, then the outer rows are recomputed after the receive (the
        reference's solve-inner-while-messages-fly, dccrg.hpp:5046-5413).
        It costs a surface-sized second pass, so it is on by default on
        the card and off on the CPU, as the reference's default is on
        accelerators only."""
        env = os.environ.get("DCCRG_OVERLAP")
        if env in ("0", "1"):
            return env == "1"
        return self.device.type == "cuda"

    def _side_stream(self):
        """The CUDA stream the overlapped step's sends run on."""
        s = getattr(self, "_side", None)
        if s is None:
            s = self._side = torch.cuda.Stream(device=self.device)
        return s

    def _roll_fixups(self, hood, p):
        """Partition ``p``'s fixup rows and source rows per slot of a
        partitioned closed-form plan's roll plan, the pad entries cut
        off: int64 device tensors, memoized on the hood."""
        L = self.plan.L
        _shifts, wr, ws = hood.roll_plan(L)
        out = []
        for j in range(wr.shape[1]):
            real = wr[p, j] < L
            out.append(hood.dev(("roll_wr", p, j),
                                lambda: wr[p, j][real].astype(np.int64),
                                self.device))
            out.append(hood.dev(("roll_ws", p, j),
                                lambda: ws[p, j][real].astype(np.int64),
                                self.device))
        return out

    def _pass_tables(self, hood, include_to, slotwise, part=0):
        """(spec, host-to-device tables) of one stencil pass over
        ``hood`` on partition ``part`` — the reference's table selection
        (dccrg_tpu/grid.py:2720-2806) without the roll decomposition of
        dense tables:

        - ``closed``: a one-partition closed-form plan (no include_to)
          gathers by exact 3-D rolls and synthesizes its mask; its one
          table is ``offs_const``;
        - ``closed_multi``: a partitioned closed-form plan rolls the
          partition's rows by each slot's flat shift and copies the
          roll plan's fixup rows (``_make_nbr_slot_gather``); its tables
          are ``offs_const``, the partition's ``[L]`` grid indices (the
          mask's source) and each slot's fixup rows and sources;
        - ``table``: the dense ``[L, S]`` rows and mask (slot-major
          ``[S, L]`` for a ``SlotwiseKernel``) with ``offs_const`` or the
          explicit ``nbr_offs``;
        - ``merged``: include_to on a split plan runs over the merged
          far + hard tables.

        Then ``scale_rows`` (hybrid plans), the hard-row tables cut to
        their real rows (``split``) and the to-tables (include_to)."""
        dev, p = self.device, int(part)
        split = hood.hard_nbr_rows is not None and not include_to
        merged = include_to and hood.hard_nbr_rows is not None
        cf = hood.closed_form if not include_to else None

        def up(name, host):
            return hood.dev((name, p), host, dev)

        if merged:
            kind, uniform_offs = "merged", False
            if (("m_rows", p), str(dev)) not in hood._dev:
                m_rows, m_offs, m_mask = hood.merged_of_tables(self.plan.R - 1)
                for q in range(self.n_dev):
                    hood.dev(("m_rows", q), m_rows[q], dev)
                    hood.dev(("m_offs", q), m_offs[q], dev)
                    hood.dev(("m_mask", q), m_mask[q], dev)
            tables = [hood._dev[((n, p), str(dev))]
                      for n in ("m_rows", "m_offs", "m_mask")]
        else:
            uniform_offs = hood.offs_const is not None
            if cf is not None:
                kind = "closed_multi" if cf.get("multi") else "closed"
                tables = [hood.dev("offs_const", hood.offs_const, dev)]
                if kind == "closed_multi":
                    tables.append(self.device_row_ids()[p, :self.plan.L])
                    tables.extend(self._roll_fixups(hood, p))
            else:
                kind = "table"
                if slotwise:
                    tables = [up("nbr_rows_t", lambda: hood.nbr_rows[p].T)]
                else:
                    tables = [up("nbr_rows", lambda: hood.nbr_rows[p])]
                if uniform_offs:
                    tables.append(hood.dev("offs_const", hood.offs_const, dev))
                else:
                    tables.append(up("nbr_offs", lambda: hood.nbr_offs[p]))
                if slotwise:
                    tables.append(up("nbr_mask_t", lambda: hood.nbr_mask[p].T))
                else:
                    tables.append(up("nbr_mask", lambda: hood.nbr_mask[p]))
        scaled = uniform_offs and hood.scale_rows is not None
        if scaled:
            tables.append(up("scale_rows", lambda: hood.scale_rows[p]))
        if split:
            n_hard = int(np.count_nonzero(hood.hard_rows[p] < self.plan.L))
            tables.append(up(
                "hard_rows", lambda: hood.hard_rows[p, :n_hard].astype(np.int64)))
            tables.append(up("hard_nbr_rows",
                             lambda: hood.hard_nbr_rows[p, :n_hard]))
            tables.append(up("hard_offs", lambda: hood.hard_offs[p, :n_hard]))
            tables.append(up("hard_mask", lambda: hood.hard_mask[p, :n_hard]))
        if include_to:
            tables.append(up("to_rows", lambda: hood.to_rows[p]))
            tables.append(up("to_offs", lambda: hood.to_offs[p]))
            tables.append(up("to_mask", lambda: hood.to_mask[p]))
        spec = (kind, _synth_key(cf), uniform_offs, scaled, split,
                bool(include_to), slotwise)
        return spec, tables

    def _partition_tables(self, hood, include_to, slotwise):
        """``(spec, tables, n_tab)``: every partition's pass tables, in
        partition order, ``n_tab`` each."""
        per = [self._pass_tables(hood, include_to, slotwise, p)
               for p in range(self.n_dev)]
        return per[0][0], [t for _spec, tabs in per for t in tabs], len(per[0][1])

    def _make_stencil(self, kernel, fields_in, fields_out, neighborhood_id,
                      include_to, n_extra=0):
        """(program, bound tables) for a gather stencil:
        ``program(*tables, *fields_in, *fields_out, *extra) ->
        fields_out`` (``[n_dev, R]`` tensors in and out), the table
        branch of the reference's ``_make_stencil``
        (dccrg_tpu/grid.py:2720-2916) run partition by partition: the
        bulk pass over the dense or closed-form plan, then, on a split
        plan, the kernel over the hard rows, whose results overwrite the
        bulk result's rows."""
        fields_in = tuple(fields_in)
        fields_out = tuple(fields_out)
        slotwise = isinstance(kernel, SlotwiseKernel)
        if slotwise and include_to:
            raise ValueError("SlotwiseKernel does not support include_to")
        hood = self.plan.hoods[neighborhood_id]
        L, R, n_dev = self.plan.L, self.plan.R, self.n_dev
        spec, tables, n_tab = self._partition_tables(hood, include_to, slotwise)
        key = ("stencil", kernel, fields_in, fields_out, n_extra, L, R, spec,
               n_dev)
        fn = self._program_cache.get(key)
        if fn is not None:
            return fn, tables

        n_in, n_out, n_all = len(fields_in), len(fields_out), n_dev * n_tab

        def fn(*args):
            ins = args[n_all:n_all + n_in]
            outs = [cur.clone() for cur in args[n_all + n_in:n_all + n_in + n_out]]
            extra = args[n_all + n_in + n_out:]
            for p in range(n_dev):
                flat = {n: f[p] for n, f in zip(fields_in, ins)}
                cell_fields = {n: f[:L] for n, f in flat.items()}
                run = _make_pass(spec, args[p * n_tab:(p + 1) * n_tab], L,
                                 fields_out)
                result = run(kernel, cell_fields, flat, extra)
                for n, o in zip(fields_out, outs):
                    o[p, :L] = result[n].to(o.dtype)
            return tuple(outs)

        self._program_cache[key] = fn
        return fn, tables

    # -- the overlapped step's outer re-pass (dccrg_tpu/grid.py:2473-2718)

    def _outer_tables(self, neighborhood_id, hood, use_roll, r_shifts, roll,
                      plan=None):
        """Host tables of the overlapped step's outer re-pass:
        ``(outer_rows [n_dev, Wo] int32, pad R-1; outer_nbr_rows
        [n_dev, Wo, S] int32)`` — the rows ``[n_inner, n_local)`` of each
        partition and their neighbor rows in the full (local + ghost)
        rows. None when the overlap cannot pay: no outer rows, or outer
        rows are the majority. ``use_roll``: the neighbor rows come from
        the roll plan (row + shift, the fixups over it; masked slots may
        hold junk, which the re-pass zeroes). Memoized on the hood."""
        if getattr(hood, "_outer_skip", False):
            return None
        cached = getattr(hood, "_outer_host", None)
        if cached is not None:
            return cached
        plan = self.plan if plan is None else plan
        R = plan.R
        n_inner = np.asarray(hood.n_inner, dtype=np.int64)
        n_local = np.asarray(plan.n_local, dtype=np.int64)
        n_out_d = n_local - n_inner
        if int(n_out_d.max(initial=0)) == 0 or (
                2 * int(n_out_d.sum()) > int(n_local.sum())):
            hood._outer_skip = True
            return None
        W = self._sticky_cap(("outerW", neighborhood_id), int(n_out_d.max()))
        orow = np.full((self.n_dev, W), R - 1, dtype=np.int32)
        for d in range(self.n_dev):
            k = int(n_out_d[d])
            orow[d, :k] = np.arange(n_inner[d], n_local[d], dtype=np.int32)
        if use_roll:
            shifts = np.asarray(r_shifts, dtype=np.int64)
            S = len(shifts)
            onr64 = orow.astype(np.int64)[:, :, None] + shifts[None, None, :]
            wr = np.asarray(roll[1])
            ws = np.asarray(roll[2])
            for d in range(self.n_dev):
                lo, hi = int(n_inner[d]), int(n_local[d])
                for j in range(S):
                    wrow = wr[d, j]
                    sel = (wrow >= lo) & (wrow < hi)
                    onr64[d, wrow[sel] - lo, j] = ws[d, j][sel]
            onr = np.clip(onr64, 0, R - 1).astype(np.int32)
            for d in range(self.n_dev):
                onr[d, int(n_out_d[d]):] = R - 1
        else:
            nbr = np.asarray(hood.nbr_rows)
            S = nbr.shape[2]
            onr = np.full((self.n_dev, W, S), R - 1, dtype=np.int32)
            for d in range(self.n_dev):
                k = int(n_out_d[d])
                onr[d, :k] = nbr[d, orow[d, :k]]
        hood._outer_host = (orow, onr)
        return hood._outer_host

    def _refreshed_ghost_mask(self, neighborhood_id, names):
        """``[n_dev, R]`` bool: the ghost rows that receive fresh bytes
        when ``names`` exchange (after the transfer predicates); the
        zero row excluded."""
        R = self.plan.R
        m = np.zeros((self.n_dev, R), dtype=bool)
        for n in names:
            c = self._field_pair_compact(neighborhood_id, n)
            m[c["q"], c["rrow"]] = True
        m[:, R - 1] = False
        return m

    def _split_outer_tables(self, neighborhood_id, hood, use_roll,
                            r_shifts, roll, relevant):
        """Ghost-split outer tables: like :meth:`_outer_tables`, but only
        the local rows whose gather reads a ghost row refreshed by
        exchanging ``relevant``. Returns ``(orow [n_dev, W], onr
        [n_dev, W, S], rows_total)`` or None when no row qualifies;
        memoized per ``(use_roll, relevant)`` on the hood."""
        cache = getattr(hood, "_split_outer", None)
        if cache is None:
            cache = hood._split_outer = {}
        key = (bool(use_roll), tuple(relevant))
        if key in cache:
            return cache[key]
        plan = self.plan
        R = plan.R
        n_local = np.asarray(plan.n_local, dtype=np.int64)
        refreshed = self._refreshed_ghost_mask(neighborhood_id, relevant)
        row_sets = []
        if use_roll:
            # ghost reads are always roll-plan fixups; pad fixups are
            # (0, 0) and row 0 is never a refreshed ghost
            wr = np.asarray(roll[1])
            ws = np.asarray(roll[2])
            for d in range(self.n_dev):
                sel = refreshed[d][ws[d]]
                rows = np.unique(wr[d][sel]).astype(np.int64)
                row_sets.append(rows[rows < n_local[d]])
        else:
            nbr = np.asarray(hood.nbr_rows)
            msk = np.asarray(hood.nbr_mask)
            for d in range(self.n_dev):
                k = int(n_local[d])
                hit = (msk[d, :k] & refreshed[d][nbr[d, :k]]).any(axis=1)
                row_sets.append(np.nonzero(hit)[0].astype(np.int64))
        rows_total = int(sum(len(r) for r in row_sets))
        if rows_total == 0:
            cache[key] = None
            return None
        W = self._sticky_cap(("gsplitW", neighborhood_id, key),
                             int(max(len(r) for r in row_sets)))
        orow = np.full((self.n_dev, W), R - 1, dtype=np.int32)
        for d, rows in enumerate(row_sets):
            orow[d, :len(rows)] = rows
        if use_roll:
            shifts = np.asarray(r_shifts, dtype=np.int64)
            S = len(shifts)
            onr64 = orow.astype(np.int64)[:, :, None] + shifts[None, None, :]
            wr = np.asarray(roll[1])
            ws = np.asarray(roll[2])
            for d, rows in enumerate(row_sets):
                if not len(rows):
                    continue
                for j in range(S):
                    wrow = wr[d, j]
                    pos = np.searchsorted(rows, wrow)
                    sel = (pos < len(rows)) & (
                        rows[np.minimum(pos, len(rows) - 1)] == wrow)
                    onr64[d, pos[sel], j] = ws[d, j][sel]
            onr = np.clip(onr64, 0, R - 1).astype(np.int32)
            for d, rows in enumerate(row_sets):
                onr[d, len(rows):] = R - 1
        else:
            nbr = np.asarray(hood.nbr_rows)
            S = nbr.shape[2]
            onr = np.full((self.n_dev, W, S), R - 1, dtype=np.int32)
            for d, rows in enumerate(row_sets):
                onr[d, :len(rows)] = nbr[d, rows]
        cache[key] = (orow, onr, rows_total)
        return cache[key]

    def _make_outer_repass(self, kernel, fields_in, fields_out,
                           neighborhood_id, exchange_names):
        """A fix-the-refreshed-rows pass for split-overlap treatments of
        stencils outside the step loop: recomputes the plain ``kernel``
        at exactly the local rows whose gather reads a ghost row
        refreshed by exchanging ``exchange_names``, writing the results
        into already-computed bulk outputs (the caller ran the bulk
        stencil on pre-exchange state and landed the halos). Returns
        ``(fn, tables)`` with ``out = fn(*tables, *fields_in tensors,
        *bulk_out tensors)`` (``[n_dev, R, ...]`` in and out), or None
        on a split (hybrid) plan or when no row qualifies."""
        hood = self.plan.hoods[neighborhood_id]
        if hood.hard_nbr_rows is not None:
            return None
        msk = np.asarray(hood.nbr_mask)
        if getattr(msk, "ndim", 0) != 3:
            return None
        exch = tuple(sorted(exchange_names))
        st = self._split_outer_tables(neighborhood_id, hood, False,
                                      None, None, exch)
        if st is None:
            return None
        orow_h, onr_h, _rows = st
        L, R, n_dev = self.plan.L, self.plan.R, self.n_dev
        n_local = np.asarray(self.plan.n_local, dtype=np.int64)
        dev = self.device
        tables = []
        for d in range(n_dev):
            rows = orow_h[d][orow_h[d] < n_local[d]].astype(np.int64)
            k = len(rows)
            om = msk[d, rows]
            if hood.offs_const is not None:
                oo = (om[..., None] * np.asarray(hood.offs_const)[None, :, :]
                      ).astype(np.int32)
                if hood.scale_rows is not None:
                    oo = oo * np.asarray(hood.scale_rows)[d, rows][:, None, None]
            else:
                oo = np.asarray(hood.nbr_offs)[d, rows]
            for name, host in (("rows", rows), ("nbr", onr_h[d, :k]),
                               ("mask", om), ("offs", oo)):
                tables.append(hood.dev(("orp", exch, name, d), host, dev))
        fields_in = tuple(fields_in)
        fields_out = tuple(fields_out)
        key = ("outer_repass", kernel, fields_in, fields_out,
               neighborhood_id, exch, L, R, n_dev)
        fn = self._program_cache.get(key)
        if fn is not None:
            return fn, tables
        nin, nout = len(fields_in), len(fields_out)

        def fn(*args):
            tabs, args = args[:4 * n_dev], args[4 * n_dev:]
            ins = args[:nin]
            outs = [b.clone() for b in args[nin:nin + nout]]
            for d in range(n_dev):
                rows, onr, om, oo = tabs[4 * d:4 * d + 4]
                if not rows.numel():
                    continue
                cell = {n: f[d].index_select(0, rows)
                        for n, f in zip(fields_in, ins)}
                nbr = {n: f[d][onr] for n, f in zip(fields_in, ins)}
                res = kernel(cell, nbr, oo, om)
                for n, o in zip(fields_out, outs):
                    o[d].index_copy_(0, rows, res[n].to(o.dtype))
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
        launches the CUDA bulk kernel (one partition only, as the
        reference's executor). Otherwise a closed-form plan takes the
        plain roll path (``"roll"``: an exact 3-D ``torch.roll`` per
        slot on one partition, a flat roll plus the fixup rows on
        several) and any other plan the table path (``"table"``: gathers
        by index from the dense tables, then the hard-row pass of a
        split plan), the reference's loop (dccrg_tpu/grid.py:2920-3313)
        partition by partition. A plain grid kernel
        (``kernel(cell_fields, nbr_fields, offs, mask, *extra)``, not a
        ``SlotwiseKernel``) gets the ``[L, S]`` neighbour stacks, the
        pre-masked ``[L, S, 3]`` offsets and the ``[L, S]`` mask.

        Each step first refreshes the ghost rows of ``exchange_fields``
        (a subset of ``fields_out``; static fields' ghosts are refreshed
        once per structure epoch by the caller). With the overlap on
        (:meth:`_use_overlap`) the exchange's sends start on a side
        stream, the bulk pass runs on pre-exchange state, the receives
        land and the outer rows (or, for a kernel declaring
        ``ghost_deps``, just the rows reading a refreshed ghost) are
        recomputed before the step's results are written;
        ``last_overlap`` says which mode was compiled.
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
        L, R, n_dev = self.plan.L, self.plan.R, self.n_dev
        static_in = tuple(n for n in fields_in if n not in fields_out)
        spec, tables, n_tab = self._partition_tables(hood, False, slotwise)
        exch_idx = tuple(fields_out.index(n) for n in exchange_fields)
        xnames = tuple(fields_out[j] for j in exch_idx)
        groups = (self._exchange_groups(neighborhood_id, xnames)
                  if n_dev > 1 and exch_idx else [])
        n_groups = tuple(len(g) for g in groups)
        for g in groups:
            for src, dst in g:
                tables += [src, dst]
        n_x = len(tables) - n_dev * n_tab

        # the overlap and its ghost split (dccrg_tpu/grid.py:3032-3107)
        use_roll = spec[0] == "closed_multi"
        roll = hood.roll_plan(L) if use_roll else None
        r_shifts = roll[0] if use_roll else None
        overlap = (n_dev > 1 and hood.n_inner is not None and bool(exch_idx)
                   and self._use_overlap())
        deps = getattr(kernel, "ghost_deps", None)
        o_mode, repass, ot, okey = None, fields_out, None, ("outer",)
        rows_full = rows_split = 0
        if overlap:
            rows_full = int((np.asarray(self.plan.n_local)
                             - np.asarray(hood.n_inner)).sum())
        if overlap and deps is not None and ghost_split_enabled():
            repass = tuple(F for F in fields_out
                           if set(deps.get(F, fields_in)) & set(xnames))
            relevant = tuple(sorted(set().union(set(), *(
                set(deps.get(F, fields_in)) & set(xnames)
                for F in repass))))
            st = (self._split_outer_tables(
                neighborhood_id, hood, use_roll, r_shifts, roll, relevant)
                if repass else None)
            if st is None:
                # no output reads an exchanged ghost: no re-pass at all
                o_mode, repass = "none", ()
            elif repass == fields_out and st[2] >= rows_full:
                o_mode, repass = None, fields_out  # the split saves nothing
            elif 2 * st[2] > int(np.asarray(self.plan.n_local).sum()):
                overlap, repass = False, fields_out
            else:
                o_mode, rows_split, ot = "split", st[2], st[:2]
                okey = ("gsplit",) + relevant
        if overlap and o_mode is None:
            ot = self._outer_tables(neighborhood_id, hood, use_roll,
                                    r_shifts, roll)
            if ot is None:
                overlap = False
            else:
                o_mode, rows_split = "full", rows_full
        o_tabs = o_mode in ("full", "split")
        if o_tabs:
            orow, onr = ot
            for p in range(n_dev):
                k = int(np.count_nonzero(orow[p] < L))
                tables.append(hood.dev(okey + ("rows", p),
                                       orow[p, :k].astype(np.int64),
                                       self.device))
                tables.append(hood.dev(okey + ("nbr", p),
                                       onr[p, :k].astype(np.int64),
                                       self.device))
        self.last_overlap = {
            "mode": o_mode or "off",
            "rows_full": rows_full * len(fields_out) if overlap else 0,
            "rows_split": (rows_split * len(repass) if o_tabs else 0)
            if overlap else 0,
            "repass_fields": repass if overlap else fields_out,
        }

        key = ("steploop", kernel, fields_in, fields_out, exch_idx, n_extra,
               L, R, spec, n_dev, n_groups, overlap, o_mode, repass)
        fn = self._program_cache.get(key)
        if fn is not None:
            return fn, tables, static_in

        n_static, n_out = len(static_in), len(fields_out)
        split = spec[4]
        n_part = n_dev * n_tab
        n_all = len(tables)
        side = (self._side_stream()
                if overlap and self.device.type == "cuda" else None)

        def fn(n_steps, *args):
            tabs, args = args[:n_all], args[n_all:]
            xt = tabs[n_part:n_part + n_x]
            xg, i = [], 0
            for cnt in n_groups:
                xg.append([(xt[i + 2 * t], xt[i + 2 * t + 1])
                           for t in range(cnt)])
                i += 2 * cnt
            otab = tabs[n_part + n_x:]
            statics = dict(zip(static_in, args[:n_static]))
            # fresh state tensors: the caller's tensors stay untouched,
            # and the steps then update the copies in place
            state = [a.clone() for a in args[n_static:n_static + n_out]]
            extra = args[n_static + n_out:]
            runs = [_make_pass(spec, tabs[p * n_tab:(p + 1) * n_tab], L,
                               fields_out) for p in range(n_dev)]

            def bulk_pass(full, p, hard=True):
                flat = {n: full[n][p] for n in fields_in}
                return runs[p](kernel, {n: f[:L] for n, f in flat.items()},
                               flat, extra, hard)

            def write(p, result):
                for j, n in enumerate(fields_out):
                    state[j][p, :L] = result[n].to(state[j].dtype)

            for _ in range(int(n_steps)):
                full = dict(statics)
                full.update(zip(fields_out, state))
                if not overlap:
                    if xg:
                        _land_halos(state, exch_idx, xg,
                                    _send_halos(state, exch_idx, xg, None),
                                    None, R)
                    for p in range(n_dev):
                        write(p, bulk_pass(full, p))
                    continue
                # sends read local rows only, so they start before the
                # bulk pass with no dependency on it; the bulk pass reads
                # pre-exchange ghosts, so rows [0, n_inner) come out
                # final and the outer rows are redone once the halos
                # land (the state is updated in place, so ``full`` then
                # reads the fresh ghosts); the hard rows of a split plan
                # run last, on the fresh ghosts, over the re-pass
                payloads = _send_halos(state, exch_idx, xg, side)
                results = [bulk_pass(full, p, hard=not split)
                           for p in range(n_dev)]
                _land_halos(state, exch_idx, xg, payloads, side, R)
                for p in range(n_dev):
                    rows, nbr = (otab[2 * p], otab[2 * p + 1]) if o_tabs \
                        else (None, None)
                    flat = {n: full[n][p] for n in fields_in}
                    if rows is not None and rows.numel():
                        o_res = runs[p].repass(kernel, flat, extra, rows,
                                               nbr, use_roll)
                        res = dict(results[p])
                        for n in repass:
                            res[n] = res[n].index_copy(
                                0, rows, o_res[n].to(res[n].dtype))
                        results[p] = res
                    if split:
                        results[p] = runs[p].hard(
                            kernel, {n: f[:L] for n, f in flat.items()},
                            flat, extra, results[p])
                for p, res in enumerate(results):
                    write(p, res)
            return tuple(state)

        fn.step_path = "roll" if spec[0] in ("closed", "closed_multi") else "table"
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
        # the background-recommit swap point: a finished plan installs
        # here, at a step boundary; an unfinished build keeps the loop
        # on the live plan (DCCRG_BG_RECOMMIT)
        if self._bg_build is not None:
            self.bg_install()
        fields_in = tuple(fields_in)
        fields_out = tuple(fields_out)
        extra_args = _as_extra(extra_args)
        with telemetry.span("grid.step"):
            fn, tables, static_in = self.compile_step_loop(
                kernel, fields_in, fields_out, exchange_fields,
                neighborhood_id, n_extra=len(extra_args), bulk=bulk,
            )
            ov = self.last_overlap
            if fn.step_path != "bulk" and ov is not None and ov["mode"] != "off":
                # the ghost split's measuring stick: re-pass row slots
                # recomputed against the full re-pass's
                telemetry.inc("dccrg_outer_repass_rows_total",
                              ov["rows_split"] * int(n_steps), mode=ov["mode"])
                telemetry.inc("dccrg_outer_repass_rows_full_total",
                              ov["rows_full"] * int(n_steps))
            out = fn(
                int(n_steps),
                *tables,
                *(self.data[n] for n in static_in),
                *(self.data[n] for n in fields_out),
                *extra_args,
            )
            for n, arr in zip(fields_out, out):
                self.data[n] = arr
        self._mark_ckpt_dirty(fields_out)
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

    def run_steps_guarded(
        self,
        kernel,
        fields_in,
        fields_out,
        n_steps,
        exchange_fields=None,
        neighborhood_id=DEFAULT_NEIGHBORHOOD_ID,
        extra_args=(),
    ) -> str:
        """:meth:`run_steps` with graceful OOM degradation: on a device
        OOM the dispatch walks the fallback chain (current -> plain path
        on the grid's plan -> dense tables), logging each downgrade.
        Returns the mode that completed (see resilience.guarded_step)."""
        return resilience.guarded_step(
            self, kernel, fields_in, fields_out, n_steps,
            exchange_fields=exchange_fields,
            neighborhood_id=neighborhood_id, extra_args=extra_args,
        )
