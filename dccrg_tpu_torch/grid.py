"""The grid runtime: single-device slice of the PyTorch port.

PyTorch counterpart of ``dccrg_tpu/grid.py`` for one device:

- **Structure is host state**: the sorted cell list, owners and the
  closed-form neighbor plan are numpy arrays built at ``initialize``.
- **Data is device state**: each per-cell field is one tensor of shape
  ``[n_dev, R, ...]`` with ``n_dev = 1`` and ``R = L + 1``; rows are
  grid order (``flat = x + nx*(y + ny*z)``), rows ``n0..L`` are
  capacity padding (``L = bucket_capacity(n0)``) and row ``R - 1`` is
  the permanent zero row.
- **Stencils run slot by slot**: ``run_steps`` feeds a
  ``SlotwiseKernel`` one neighbor slot at a time. An eligible step loop
  goes through the bulk executor (ops/roll_executor.py, a CUDA kernel on
  the card); everything else takes the plain roll path, which gathers
  each slot with an exact 3-D ``torch.roll`` (a plain grid kernel gets
  the slots stacked as ``[L, S]``).

Only all-level-0 grids on one device are handled; AMR, the halo
exchange and multi-device plans belong to later slices of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dataclass_field

import numpy as np
import torch

from .geometry import CartesianGeometry, NoGeometry, StretchedCartesianGeometry
from .mapping import Mapping
from .neighbors import build_neighbor_lists, make_neighborhood, validate_neighborhood
from .topology import GridTopology
from . import uniform as uniform_mod

# Parity with the reference's default neighborhood id (dccrg.hpp:99).
DEFAULT_NEIGHBORHOOD_ID = -0xDCC


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
    compiler drops those gathers the same way)."""

    def __init__(self, fields, gather, nmask, n_slots):
        super().__init__()
        self._fields = fields
        self._gather = gather
        self._nmask = nmask
        self._n_slots = n_slots

    def __missing__(self, name):
        fl = self._fields[name]
        st = torch.stack([self._gather(fl, j, self._nmask[:, j])
                          for j in range(self._n_slots)], dim=1)
        self[name] = st
        return st

    def __contains__(self, name):
        return name in self._fields


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


class _HoodPlan:
    """Per-neighborhood static tables (one structure epoch), closed-form
    subset: the dense gather tables are one thunk returning
    ``(rows, mask)``, materialized only if a host path asks."""

    def __init__(self, offsets, nbr_rows, nbr_offs, nbr_mask, n_inner=None,
                 offs_const=None, closed_form=None, pair_compact=None,
                 lists=None):
        self.offsets = offsets  # [K, 3] neighborhood items
        self._nbr_rows = nbr_rows  # [n_dev, L, S] int32 (pad: zero row), or thunk
        self._nbr_offs = nbr_offs  # [n_dev, L, S, 3] int32, or thunk
        self._nbr_mask = nbr_mask  # [n_dev, L, S] bool, or thunk
        # closed-form single-device plans: the mask is synthesized from
        # the row index and the roll shifts arithmetically (dict with
        # dims/periodic/offsets/n0)
        self.closed_form = closed_form
        self.offs_const = offs_const  # [S, 3] int32 per-slot offsets
        self._pair_compact = pair_compact
        self._lists = lists  # NeighborLists, or a thunk building them
        self.n_inner = n_inner  # [n_dev] rows [0, n_inner) have no remote deps
        self._roll_plan = None  # computed on demand by roll_plan()
        self._dev = {}  # memoized device uploads

    @property
    def pair_compact(self):
        return self._pair_compact

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

    def dev(self, name, host_array, device):
        """Memoized upload of a named host table to ``device``."""
        key = (name, str(device))
        hit = self._dev.get(key)
        if hit is None:
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
        self.last_step_path = None  # "bulk" | "roll" after run_steps

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

    def _build_plan(self, cells: np.ndarray, owner: np.ndarray):
        n0 = self.mapping.length.total_level0_cells
        if not (uniform_mod.is_uniform(cells, n0) and n0 < 2**31 - 2):
            raise NotImplementedError(
                "only complete level-0 grids below 2^31 cells are ported")
        plan = self._build_plan_uniform(cells, owner)
        old = getattr(self, "plan", None)
        plan.epoch = old.epoch + 1 if old is not None else 0
        self.plan = plan

    def _build_plan_uniform(self, cells: np.ndarray, owner: np.ndarray):
        """Closed-form plan construction for all-level-0 grids
        (uniform.py)."""
        layout, hood_data = uniform_mod.build_uniform_plan(
            self.mapping, self.topology, self.neighborhoods, cells, owner,
            self.n_dev, cap=self._sticky_cap,
        )
        plan = _Plan(
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
        mapping, topology = self.mapping, self.topology
        for hid, offs in self.neighborhoods.items():
            hd = hood_data[hid]

            def lists_thunk(offs=offs):
                return build_neighbor_lists(mapping, topology, cells, offs)

            hood = _HoodPlan(
                offsets=offs,
                nbr_rows=hd["tables_thunk"],
                nbr_offs=hd["nbr_offs"],
                nbr_mask=hd["tables_thunk"],
                offs_const=hd["offs_const"],
                closed_form=hd["closed_form"],
                pair_compact=hd["pair_compact"],
                n_inner=(layout["n_inner"]
                         if hid == DEFAULT_NEIGHBORHOOD_ID else None),
                lists=lists_thunk,
            )
            # roll shifts + wrap fixups were computed arithmetically
            hood._roll_plan = hd["roll_plan"]
            plan.hoods[hid] = hood
        return plan

    def _allocate_fields(self):
        self.data = {}
        for name, (shape, dtype) in self.fields.items():
            self.data[name] = torch.zeros((self.n_dev, self.plan.R) + shape,
                                          dtype=dtype, device=self.device)

    def device_row_ids(self) -> torch.Tensor:
        """``[n_dev, R] int32`` tensor of ``cell id - 1`` per row (``-1``
        on pad rows), made on the device from an arange (rows are id
        order on a complete level-0 grid). Cached per structure epoch."""
        plan = self.plan
        cached = getattr(plan, "_row_ids_dev", None)
        if cached is not None:
            return cached
        n0 = self.mapping.length.total_level0_cells
        idx = torch.arange(plan.R, dtype=torch.int32, device=self.device)
        arr = torch.where(idx < n0, idx, torch.full_like(idx, -1))[None, :]
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
        out = arr[0, torch.as_tensor(rows, device=arr.device)]
        if out.dtype == torch.bfloat16:
            out = out.to(torch.float32)
        out = out.cpu().numpy()
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

    def get_cells(self, criteria=None, exact_match: bool = False,
                  neighborhood_id=DEFAULT_NEIGHBORHOOD_ID) -> np.ndarray:
        """Cell ids, id-sorted (reference get_cells, dccrg.hpp:661-753).
        On one device every cell is local. The neighbor-type
        ``criteria`` filter is not ported and raises."""
        del exact_match
        if criteria is not None:
            raise NotImplementedError(
                "get_cells criteria (neighbor-type masks) are not ported")
        if neighborhood_id not in self.plan.hoods:
            return np.empty(0, np.uint64)
        return self.plan.cells.copy()

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

        ``kernel(cell_fields, nbr_fields, offs, mask)`` receives
        ``cell_fields[name]`` ``[L, ...]``, ``nbr_fields[name]``
        ``[L, S, ...]`` (neighbors gathered, zeros where the mask is
        off), ``offs`` ``[L, S, 3]`` and ``mask`` ``[L, S]``, and returns
        a dict name -> ``[L, ...]`` for every name in ``fields_out``. The
        updated rows are written into new field tensors. Only the
        closed-form single-device branch is ported: ``include_to``,
        ``extra_args`` and plans with dense tables raise
        ``NotImplementedError``.
        """
        fields_in = tuple(fields_in)
        fields_out = tuple(fields_out)
        fn, tables = self._make_stencil(
            kernel, fields_in, fields_out, neighborhood_id, include_to,
            n_extra=len(extra_args),
        )
        out = fn(*tables, *(self.data[n] for n in fields_in),
                 *(self.data[n] for n in fields_out))
        for n, arr in zip(fields_out, out):
            self.data[n] = arr

    def _make_stencil(self, kernel, fields_in, fields_out, neighborhood_id,
                      include_to, n_extra=0):
        """(program, bound tables) for a gather stencil on a closed-form
        single-device plan: ``program(*tables, *fields_in, *fields_out)
        -> fields_out`` (``[n_dev, R]`` tensors in and out). The mask is
        synthesized from the row index, the neighbors are gathered by
        exact 3-D rolls, ``offs = mask * offs_const`` (grid.py:2720-2916
        of the reference, its plain-kernel branch)."""
        if include_to:
            raise NotImplementedError("apply_stencil include_to is not ported")
        if n_extra:
            raise NotImplementedError("apply_stencil extra_args are not ported")
        if isinstance(kernel, SlotwiseKernel):
            raise NotImplementedError(
                "apply_stencil with a SlotwiseKernel is not ported")
        hood = self.plan.hoods[neighborhood_id]
        cf = hood.closed_form
        if cf is None:
            raise NotImplementedError(
                "apply_stencil needs a closed-form plan (dense tables are "
                "not ported)")
        L, R = self.plan.L, self.plan.R
        tables = [hood.dev("offs_const", hood.offs_const, self.device)]
        synth = _synth_key(cf)
        key = ("stencil", kernel, fields_in, fields_out, L, R, synth)
        fn = self._program_cache.get(key)
        if fn is not None:
            return fn, tables

        n_in = len(fields_in)
        n_slots = len(synth[3])
        gather = _make_roll3d_gather(synth, L)

        def fn(offs_dev, *args):
            ins = args[:n_in]
            outs_cur = args[n_in:]
            cell_fields = {n: f[0][:L] for n, f in zip(fields_in, ins)}
            nmask = _synth_mask(synth, L, offs_dev.device)
            noffs = nmask[:, :, None] * offs_dev[None, :, :]
            nbr_fields = _GatheredNeighbors(
                {n: f[0] for n, f in zip(fields_in, ins)}, gather, nmask,
                n_slots)
            result = kernel(cell_fields, nbr_fields, noffs, nmask)
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
        launches the CUDA bulk kernel. An ineligible loop, or
        ``bulk=False``, takes the plain roll path: per step, every slot
        gathers its neighbors with an exact 3-D ``torch.roll`` and the
        kernel's slot function runs on them. A plain grid kernel
        (``kernel(cell_fields, nbr_fields, offs, mask, *extra)``, not a
        ``SlotwiseKernel``) gets the ``[L, S]`` neighbour stacks, the
        pre-masked ``[L, S, 3]`` offsets and the ``[L, S]`` mask.

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
        cf = hood.closed_form
        if cf is None:
            raise NotImplementedError(
                "the port's step loop needs a closed-form plan (dense "
                "tables are not ported)")
        slotwise = isinstance(kernel, SlotwiseKernel)
        L, R = self.plan.L, self.plan.R
        static_in = tuple(n for n in fields_in if n not in fields_out)
        tables = [hood.dev("offs_const", hood.offs_const, self.device)]
        synth = _synth_key(cf)
        key = ("steploop", kernel, fields_in, fields_out, n_extra, L, R,
               synth)
        fn = self._program_cache.get(key)
        if fn is not None:
            return fn, tables, static_in

        n_static, n_out = len(static_in), len(fields_out)
        n_slots = len(synth[3])
        gather = _make_roll3d_gather(synth, L)

        def fn(n_steps, offs_dev, *args):
            statics = {n: a[0] for n, a in zip(static_in, args[:n_static])}
            # fresh state tensors: the caller's arrays stay untouched,
            # and the steps then update the copies in place
            state = [a[0].clone() for a in args[n_static:n_static + n_out]]
            extra = args[n_static + n_out:]
            if slotwise:
                sgidx, sbase = _synth_prep(synth, L, offs_dev.device)
                masks = [_synth_col(synth, sgidx, sbase, j)
                         for j in range(n_slots)]
                offs_col = _make_offs_col(True, offs_dev, None)
            else:
                # the plain-kernel branch (grid.py:3187-3197 of the
                # reference): the [L, S] mask, offsets pre-masked, and
                # every input field's [L, S] neighbour stack
                nmask = _synth_mask(synth, L, offs_dev.device)
                noffs = nmask[:, :, None] * offs_dev[None, :, :]
            for _ in range(int(n_steps)):
                full = dict(statics)
                full.update(zip(fields_out, state))
                cell_fields = {n: full[n][:L] for n in fields_in}
                if slotwise:
                    result = _run_slotwise(
                        kernel, cell_fields, {n: full[n] for n in fields_in},
                        gather, offs_col, masks.__getitem__, n_slots, extra)
                else:
                    nbr_fields = _GatheredNeighbors(
                        {n: full[n] for n in fields_in}, gather, nmask,
                        n_slots)
                    result = kernel(cell_fields, nbr_fields, noffs, nmask,
                                    *extra)
                for j, n in enumerate(fields_out):
                    state[j][:L] = result[n].to(state[j].dtype)
            return tuple(s[None] for s in state)

        fn.step_path = "roll"
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
        extra_args = tuple(e if isinstance(e, torch.Tensor)
                           else torch.as_tensor(e, dtype=torch.float32)
                           for e in extra_args)
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
