"""Fleet execution layer: many same-shape grids stacked along a batch axis.

Port of ``dccrg_tpu/fleet.py`` (its single-device execution layer). A
fleet is thousands of small and medium scenario runs per device; N
independent uniform grids with the same bucket key (shape,
periodicity, field schema, step kernel, number of parameters) are
stacked along a leading batch dimension, so they share one program,
one launch sequence and one pass over device memory per step, with
per-job parameters (dt, cfl) riding as a ``[B, E]`` float32 tensor.

:class:`GridBatch` runs one bucket. Its quantum program is one of two:

- the **table program**, the reference's ``vmap(step_one)`` written
  out: ``state[:, rows]`` with the template plan's ``[L, S]`` rows
  table feeds the job's plain grid kernel, whose operations broadcast
  over the batch dimension. Every kernel operation is elementwise per
  slot and the neighbour sums run slot by slot in a fixed order, so a
  job's bytes equal its solo run's (:func:`run_solo`) bit for bit;
- the **bulk program**: on a CUDA bucket whose job names a registry
  kernel with a slot-wise twin known to kernel A'
  (ops/roll_executor.py, csrc/fleet_bulk_pass.cu), every step is one
  kernel A' launch, the budget freeze included. Its sums run in slot
  order too, so it matches the table program to float re-association.

Per-job isolation: slot ``k`` advances ``budget[k]`` steps per quantum
and is frozen afterwards: its old bytes are kept exactly, by kernel A'
itself on the card and by a per-slot ``torch.where`` everywhere else,
and no operation mixes slots. With ``DCCRG_INTEGRITY`` on
(the default) each quantum also measures, per slot, the exact
fingerprints and the conservation sums of its input and output state,
read to the host once per quantum (:attr:`GridBatch.last_inv`).

The job queue, admission, drain/backfill, per-job checkpoint stems,
preemption and retention GC live in
:class:`dccrg_tpu_torch.scheduler.FleetScheduler`, which keeps its job
state on :class:`FleetJob` (priority, retries, SLO, save cadence);
``python -m dccrg_tpu_torch.fleet`` runs a job file through it (see
:func:`_main`), on the card unless ``--device cpu`` says otherwise. Env
knobs: ``DCCRG_FLEET_MAX_BATCH`` (slots per bucket, default 128),
``DCCRG_FLEET_QUANTUM`` (steps per batched quantum between scheduler
polls, default 8).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from . import checkpoint as checkpoint_mod
from . import faults, integrity, warmstart
from .convert import _to_numpy, _to_tensor
from .grid import (DEFAULT_NEIGHBORHOOD_ID, Grid, SlotwiseKernel,
                   _GatheredNeighbors, as_torch_dtype, single_device,
                   slot_sum)

_F32 = torch.float32

#: slot sentinel: a DMR shadow replica of the job in
#: ``GridBatch.shadow_of[slot]``; it occupies a slot without being a
#: schedulable job itself
SHADOW = type("_ShadowSlot", (), {"__repr__": lambda s: "<shadow>"})()


def max_batch_default(default: int = 128) -> int:
    """The ``DCCRG_FLEET_MAX_BATCH`` env knob: maximum batch slots per
    bucket (one bucket = one batched program)."""
    try:
        return max(1, int(os.environ.get("DCCRG_FLEET_MAX_BATCH", "")
                          or default))
    except ValueError:
        return default


def quantum_default(default: int = 8) -> int:
    """The ``DCCRG_FLEET_QUANTUM`` env knob: steps per batched quantum
    between scheduler polls. Longer quanta spread the per-quantum host
    work over more steps; shorter ones tighten the watchdog, checkpoint
    and preempt poll cadence (all run at quantum boundaries)."""
    try:
        return max(1, int(os.environ.get("DCCRG_FLEET_QUANTUM", "")
                          or default))
    except ValueError:
        return default


# ---------------------------------------------------------------------
# the step-kernel registry (the job files' serializable kernel names)
# ---------------------------------------------------------------------

FLEET_KERNELS: dict = {}


class JobSpecError(ValueError):
    """A job record that can never become a valid :class:`FleetJob`
    (missing name, malformed lengths, ...)."""


class UnknownKernelError(KeyError):
    """A job names a kernel the registry does not know."""

    def __init__(self, job: str, kernel, registered):
        self.job = str(job)
        self.kernel = kernel
        self.registered = sorted(registered)
        super().__init__(
            f"job {self.job!r}: unknown kernel {kernel!r} "
            f"(registered: {self.registered})")

    def __str__(self) -> str:  # KeyError quotes its arg; keep prose
        return self.args[0]


def register_kernel(name: str, fn) -> None:
    """Register a grid step kernel under a name job files can
    reference: ``kernel(cell_fields, nbr_fields, offs, mask, *params)
    -> {field: new_values}``. In a batch, ``cell_fields`` are
    ``[B, L]``, ``nbr_fields`` ``[B, L, S]`` and ``params`` ``[B, 1]``
    float32 columns, while ``offs`` and ``mask`` are the shared
    ``[L, S, 3]`` / ``[L, S]`` tables; alone, the batch dimension is
    absent and ``params`` are 0-dim. The kernel must broadcast over
    it."""
    FLEET_KERNELS[str(name)] = fn


# per-kernel job defaults: schema, field lists, params and a seeded
# default init (the reference's model zoo registers its kernels here)
FLEET_KERNEL_SPECS: dict = {}


def register_kernel_spec(name: str, *, cell_data, fields_in,
                         fields_out, params=(0.1,), init=None) -> None:
    """Register the job defaults of a named kernel: its ``cell_data``
    schema, ``fields_in``/``fields_out`` lists, default ``params`` and
    an optional seeded init ``fn(grid, seed)`` used in place of
    :func:`seeded_random_init`."""
    FLEET_KERNEL_SPECS[str(name)] = {
        "cell_data": dict(cell_data),
        "fields_in": tuple(fields_in),
        "fields_out": tuple(fields_out),
        "params": tuple(float(p) for p in params),
        "init": init,
    }


def _kernel_spec(name: str):
    """The registered spec for a kernel name, importing the model zoo
    once on a miss (importing ``dccrg_tpu_torch.models`` registers the
    zoo kernels)."""
    spec = FLEET_KERNEL_SPECS.get(name)
    if spec is None and name not in FLEET_KERNELS:
        from . import models  # noqa: F401 - registers the zoo

        spec = FLEET_KERNEL_SPECS.get(name)
    return spec


def _masked_sum(nbr, mask):
    """``sum_j where(mask_j, nbr_j, 0)`` over the last axis, in float32
    and slot order, rounded once to ``nbr``'s dtype (the reference's
    ``jnp.sum`` accumulates bfloat16 in float32). Slot by slot, so a
    slot of a batch adds in the same order as a solo grid."""
    return slot_sum(torch.where(mask, nbr, nbr.new_zeros(())).to(_F32)
                    ).to(nbr.dtype)


def _diffuse_kernel(c, nbr, offs, mask, dt):
    """Explicit neighbour-coupling relaxation of ``rho``:
    ``rho += dt * sum_nbr (rho_nbr - rho)``. The product with the
    float32 ``dt`` and the sum run in float32 (JAX promotes
    ``bfloat16 * float32`` there; PyTorch would keep bfloat16 for a
    0-dim ``dt``), rounded once at the store."""
    rho = c["rho"]
    s = _masked_sum(nbr["rho"], mask)
    deg = mask.sum(dim=-1).to(rho.dtype)
    return {"rho": rho.to(_F32) + dt * (s - deg * rho).to(_F32)}


def _advect_x_kernel(c, nbr, offs, mask, cfl):
    """First-order upwind advection of ``rho`` along +x, selecting the
    upwind neighbour through the slot offsets; the blend runs in
    float32."""
    up = (offs[..., 0] < 0) & (offs[..., 1] == 0) & (offs[..., 2] == 0)
    upv = _masked_sum(nbr["rho"], up & mask)
    return {"rho": (1.0 - cfl) * c["rho"].to(_F32) + cfl * upv.to(_F32)}


register_kernel("diffuse", _diffuse_kernel)
register_kernel("advect_x", _advect_x_kernel)


# Slot-wise twins of registry kernels, for the bulk program: kernel A'
# computes a twin's ``device_flux``. Slot accumulation re-associates
# the neighbour sum, so a bulk bucket matches its table twin to float
# re-association.
FLEET_BULK_KERNELS: dict = {}


def register_bulk_kernel(name: str, slotwise) -> None:
    """Register the ``SlotwiseKernel`` twin of a named step kernel; a
    ``GridBatch`` bucket whose job names this kernel runs the bulk
    program: kernel A' over the twin's ``device_flux`` where it is one
    kernel A' knows, else over the functor ``ops/flux_gen.py`` generates
    from the twin's slot functions (the table program where the
    lowering declines them)."""
    FLEET_BULK_KERNELS[str(name)] = slotwise


def _make_diffuse_slotwise():
    def init(c, dt):
        return torch.zeros_like(c["rho"])

    def slot(acc, c, nbr, offs, mask, dt):
        return acc + torch.where(mask, nbr["rho"] - c["rho"],
                                 acc.new_zeros(()))

    def finish(acc, c, dt):
        return {"rho": c["rho"].to(_F32) + dt * acc.to(_F32)}

    return SlotwiseKernel(init, slot, finish, device_flux="diffuse")


def _make_advect_x_slotwise():
    def init(c, cfl):
        return torch.zeros_like(c["rho"])

    def slot(acc, c, nbr, offs, mask, cfl):
        up = (offs[..., 0] < 0) & (offs[..., 1] == 0) & (offs[..., 2] == 0)
        return acc + torch.where(up & mask, nbr["rho"], acc.new_zeros(()))

    def finish(acc, c, cfl):
        return {"rho": (1.0 - cfl) * c["rho"].to(_F32) + cfl * acc.to(_F32)}

    return SlotwiseKernel(init, slot, finish, device_flux="advect_x")


register_bulk_kernel("diffuse", _make_diffuse_slotwise())
register_bulk_kernel("advect_x", _make_advect_x_slotwise())


# ---------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------

class FleetJob:
    """One scenario run: an independent uniform grid with its own
    schema, kernel, parameters, step count, priority, seed and
    checkpoint stem. Jobs whose :meth:`bucket_key` matches share one
    batched program.

    ``kernel`` is a registry name (:data:`FLEET_KERNELS`) or a grid
    kernel callable; ``params`` are per-job float scalars passed to it
    as batched extras. ``init`` is a ``fn(grid)`` that fills the fields
    (default: a seeded uniform-random fill, the same bytes a solo run
    starts from). The ``name`` is also the job's
    :class:`~dccrg_tpu_torch.supervise.CheckpointStore` stem, so it is
    unique within a scheduler."""

    def __init__(self, name, *, length=(16, 16, 16), kernel="diffuse",
                 n_steps=10, cell_data=None, fields_in=None,
                 fields_out=None, params=None, priority=0,
                 periodic=(True, True, True), hood_len=1,
                 checkpoint_every=8, max_retries=3, seed=0, init=None,
                 redundancy=1, slo_ms=None):
        self.name = str(name)
        self.length = tuple(int(v) for v in length)
        self.kernel = kernel
        self.n_steps = int(n_steps)
        spec = None if callable(kernel) else _kernel_spec(str(kernel))
        if cell_data is None:
            cell_data = (spec["cell_data"] if spec is not None
                         else {"rho": torch.float32})
        if fields_in is None:
            fields_in = spec["fields_in"] if spec is not None else ("rho",)
        if fields_out is None:
            fields_out = (spec["fields_out"] if spec is not None
                          else ("rho",))
        if params is None:
            params = spec["params"] if spec is not None else (0.1,)
        self.cell_data = {}
        for fname, fspec in cell_data.items():
            if isinstance(fspec, tuple):
                shape, dtype = fspec
            else:
                shape, dtype = (), fspec
            self.cell_data[fname] = (tuple(shape), as_torch_dtype(dtype))
        self.fields_in = tuple(fields_in)
        self.fields_out = tuple(fields_out)
        self.params = tuple(float(p) for p in params)
        self.priority = int(priority)
        self.periodic = tuple(bool(p) for p in periodic)
        self.hood_len = int(hood_len)
        self.checkpoint_every = int(checkpoint_every)
        self.max_retries = int(max_retries)
        self.seed = int(seed)
        self.init = init
        # redundancy=2: dual modular redundancy (DMR), the scheduler
        # steps the job in two slots and compares their digests at
        # every quantum boundary; a mismatch is a CORRUPT trip
        self.redundancy = max(1, int(redundancy))
        # latency SLO: a completion deadline in milliseconds from the
        # job's first enqueue (None = best-effort); the scheduler's
        # SLOPolicy admits projected violators first and sheds
        # best-effort cohabitants of a bucket that blows it
        self.slo_ms = None if slo_ms is None else float(slo_ms)
        self.slo_t0 = None  # policy-clock time of the first add()
        # scheduler-owned runtime state
        self.steps_done = 0
        self.retries = 0
        self.requeues = 0
        self.rollbacks = 0
        self.transient_retries = 0
        self.trips = []  # [(kind, at_step)]
        self.status = "queued"
        self.digest = None
        self.last_save_step = None
        self._last_trip_step = -1
        # the slot fingerprint recorded at the end of the last quantum
        # ({field: (s1, s2)}), reset by every sanctioned slot rewrite
        # (admission, restore)
        self._fp = None

    def resolved_kernel(self):
        if callable(self.kernel):
            return self.kernel
        fn = FLEET_KERNELS.get(str(self.kernel))
        if fn is None:
            _kernel_spec(str(self.kernel))  # zoo registration on a miss
            fn = FLEET_KERNELS.get(str(self.kernel))
        if fn is None:
            raise UnknownKernelError(self.name, self.kernel, FLEET_KERNELS)
        return fn

    def bucket_key(self):
        """The program-sharing key: jobs with equal keys stack into one
        batched program. Parameters, seeds and step counts are not part
        of it; every field's dtype is (by name, as the
        reference prints it), so a bfloat16 job never shares a program
        or a state allocation with a float32 bucket."""
        schema = tuple(sorted(
            (n, tuple(shape), checkpoint_mod.dtype_name(dtype))
            for n, (shape, dtype) in self.cell_data.items()))
        return (self.length, self.periodic, self.hood_len, schema,
                self.kernel, self.fields_in, self.fields_out,
                len(self.params))

    def apply_init(self, grid) -> None:
        """Fill ``grid``'s fields with this job's initial state, the
        same bytes whether the grid is a fleet scratch grid or a solo
        run's own."""
        if self.init is not None:
            self.init(grid)
        else:
            spec = (None if callable(self.kernel)
                    else FLEET_KERNEL_SPECS.get(str(self.kernel)))
            fn = spec.get("init") if spec is not None else None
            (fn if fn is not None else seeded_random_init)(grid, self.seed)
        grid.update_copies_of_remote_neighbors()


def float64_to_bfloat16(x: np.ndarray) -> torch.Tensor:
    """bfloat16 tensor of float64 values with the bits of numpy's
    ``astype`` to ``ml_dtypes.bfloat16``, without ``ml_dtypes``: that
    cast rounds to float32 first and then to bfloat16, both to nearest
    even, so this does the same, the second rounding in numpy integer
    arithmetic (NaN stays a quiet NaN)."""
    with np.errstate(over="ignore", invalid="ignore"):
        u = np.ascontiguousarray(x, dtype=np.float64).astype(
            np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        >> np.uint32(16)
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    r = np.where(nan, (u >> np.uint32(16)) | np.uint32(0x40), r)
    return torch.from_numpy(r.astype(np.uint16).view(np.int16)).view(
        torch.bfloat16)


def seeded_random_init(grid, seed: int) -> None:
    """The default job init: a seeded uniform-random fill of every
    field (deterministic in (schema, cell count, seed)): numpy float64
    draws times 100, cast to the field's dtype as the reference casts
    them."""
    rng = np.random.default_rng(seed)
    cells = grid.plan.cells
    for name in sorted(grid.fields):
        shape, dtype = grid.fields[name]
        vals = rng.random((len(cells),) + shape) * 100.0
        if dtype == torch.bfloat16:
            vals = float64_to_bfloat16(vals)
        else:
            vals = torch.from_numpy(
                vals.astype(checkpoint_mod.dtype_name(dtype)))
        grid.set(name, cells, vals)


def template_grid(job: FleetJob, device=None) -> Grid:
    """The single-device uniform grid a job describes: the bucket's
    template/scratch grid and the solo baseline's grid. On the card
    unless ``device`` says otherwise."""
    return (Grid(cell_data=dict(job.cell_data))
            .set_initial_length(job.length)
            .set_maximum_refinement_level(0)
            .set_neighborhood_length(job.hood_len)
            .set_periodic(*job.periodic)
            .initialize(single_device(device, "a fleet template grid")))


def run_solo(job: FleetJob, device=None) -> str:
    """Run ``job`` alone through ``Grid.run_steps`` and return its
    final-state digest (:func:`checkpoint.state_digest`): the
    one-grid-at-a-time baseline. A job run by a table-program batch
    digests equal to it."""
    g = template_grid(job, device)
    job.apply_init(g)
    extras = tuple(torch.tensor(p, dtype=_F32, device=g.device)
                   for p in job.params)
    if job.n_steps:
        g.run_steps(job.resolved_kernel(), job.fields_in, job.fields_out,
                    job.n_steps, extra_args=extras)
    return checkpoint_mod.state_digest(g)


# ---------------------------------------------------------------------
# the batched execution layer
# ---------------------------------------------------------------------

# fleet programs, shared across GridBatch instances (and so across
# drained and recreated buckets) by (bucket key, capacity, integrity,
# bulk, device); FIFO-bounded, since the cache outlives batches
_FLEET_PROGRAMS: dict = {}
_FLEET_PROGRAMS_MAX = 64


def _pack_host(parts):
    """One device-to-host read of int64 ``[..]`` fingerprint stacks
    and float32 sum stacks: the sums travel as their int32 bits."""
    flat = [p.reshape(-1) if p.dtype == torch.int64
            else p.contiguous().view(torch.int32).to(torch.int64).reshape(-1)
            for p in parts]
    host = torch.cat(flat).cpu().numpy() if flat else np.zeros(0, np.int64)
    out, at = [], 0
    for p in parts:
        n = p.numel()
        chunk = host[at:at + n].reshape(tuple(p.shape))
        at += n
        if p.dtype == torch.int64:
            out.append(chunk.astype(np.uint32))
        else:
            out.append(chunk.astype(np.int32).view(np.float32))
    return out


class GridBatch:
    """N independent same-shape uniform grids stacked along a leading
    batch axis into one program.

    The batch owns one template grid (also its scratch grid), whose
    plan supplies the neighbour tables, and per-field state tensors of
    shape ``[capacity, R, *field_shape]`` on the template grid's
    device (the card unless ``device="cpu"``). A quantum advances slot
    ``k`` by ``budget[k]`` steps; exhausted slots keep their bytes
    exactly. ``bulk=True`` (the default) lets an eligible bucket step
    through kernel A' (:meth:`bulk_active`); ``bulk=False`` keeps the
    table program. State updates are in place where that saves a copy
    (admission, restore, poison); a step writes new tensors."""

    def __init__(self, proto: FleetJob, capacity: int, device=None,
                 skeleton=False, bulk=True):
        self.key = proto.bucket_key()
        self.capacity = int(capacity)
        # one device, as the reference's GridBatch
        self.device = single_device(device, "GridBatch")
        # a skeleton's template grid stays on the host: its plan tables
        # are host arrays either way, and the warm pool's prewarm thread
        # must put nothing on the device
        self.grid = template_grid(proto, "cpu" if skeleton else self.device)
        plan = self.grid.plan
        self.L = int(plan.L)
        self.R = int(plan.R)
        self.n_own = int(plan.n_local[0])
        self.fields_in = proto.fields_in
        self.fields_out = proto.fields_out
        self.kernel = proto.resolved_kernel()
        # the slot-wise twin when the job names a registry kernel that
        # has one; callables have no twin
        self.bulk_kernel = (None if callable(proto.kernel)
                            else FLEET_BULK_KERNELS.get(str(proto.kernel)))
        self.bulk = bool(bulk)
        self.n_extra = len(proto.params)
        self.schema = dict(self.grid.fields)
        # the fields the device fingerprints: 32-bit element types, and
        # scalar 16-bit ones (one element per row, so one word per row,
        # as the host packer pads it); and the fields the kernel
        # provably conserves under this bucket's periodicity
        self.fp_fields = tuple(
            n for n in sorted(self.schema)
            if self.schema[n][1].itemsize == 4
            or (self.schema[n][1].itemsize == 2 and self.schema[n][0] == ()))
        self.conserved = integrity.conserved_fields(
            proto.kernel, proto.periodic, proto.fields_out)
        # DMR shadow replicas: shadow slot -> primary slot
        self.shadow_of: dict = {}
        #: host invariants of the last integrity-on quantum
        #: ({"fp_in"/"fp_out": {field: uint32 [B, 2]}, "cs_in"/"cs_out":
        #: {field: float32 [B]}}), None with DCCRG_INTEGRITY=0
        self.last_inv = None
        self.slots: list = [None] * self.capacity
        self._extras = np.zeros((self.capacity, self.n_extra),
                                dtype=np.float32)
        self.state = {}
        # a skeleton batch carries only the program inputs (plan
        # tables, schema, kernel), no [capacity, R, ...] state
        if not skeleton:
            for name, (shape, dtype) in self.schema.items():
                self.state[name] = torch.zeros(
                    (self.capacity, self.R) + shape, dtype=dtype,
                    device=self.device)
        self.dispatches = 0

    # -- program construction (shared per bucket key) -----------------

    def _program_key(self):
        # with DCCRG_INTEGRITY=0 the quantum runs no invariant
        # operation; bulk and table programs never alias
        int_on = integrity.integrity_enabled()
        want_bulk = self.bulk and self.bulk_kernel is not None
        return (self.key, self.capacity, int_on, want_bulk, str(self.device))

    def _programs(self):
        key = self._program_key()
        hit = _FLEET_PROGRAMS.get(key)
        if hit is not None:
            return hit
        # a prewarmed program from the warm-start pool is the tuple
        # _build_programs returns, built (and its kernel library loaded)
        # on the pool's thread; None when no DCCRG_COMPILE_CACHE pool is
        # active (the negative pin)
        hit = warmstart.take_prewarmed(key, device=self.device)
        if hit is None:
            hit = self._build_programs(key)
        if len(_FLEET_PROGRAMS) >= _FLEET_PROGRAMS_MAX:
            _FLEET_PROGRAMS.pop(next(iter(_FLEET_PROGRAMS)))
        _FLEET_PROGRAMS[key] = hit
        return hit

    def _build_programs(self, key):
        """The bucket's ``(run_quantum, finite, fp_now, bulk)``. Building
        them launches nothing on the device, so the warm pool's thread
        may build them: a bulk bucket on the card loads (or builds)
        kernel A' here, and a table program uploads its neighbour tables
        at its first dispatch."""
        int_on, want_bulk = key[2], key[3]
        from .ops import roll_executor

        vstep = None
        if want_bulk:
            vstep = roll_executor.make_fleet_bulk_step(
                self.grid, self.bulk_kernel, self.fields_in,
                self.fields_out, self.n_extra)
        bulk = vstep is not None
        L, fin, fout = self.L, self.fields_in, self.fields_out
        kernel, n_extra, cap = self.kernel, self.n_extra, self.capacity
        dev = self.device
        if bulk and dev.type == "cuda":
            roll_executor.fleet_library()
        if not bulk:
            hood = self.grid.plan.hoods[DEFAULT_NEIGHBORHOOD_ID]
            # [L, S] rows / mask and the mask-zeroed [L, S, 3] offsets:
            # invalid slots point at the permanent zero row
            host = (np.asarray(hood.nbr_rows[0]).astype(np.int64),
                    np.asarray(hood.nbr_mask[0]), np.asarray(hood.nbr_offs[0]))
            tables = []  # uploaded at the first dispatch

            def vstep(state, extras):
                if not tables:
                    tables.extend(torch.as_tensor(a, device=dev) for a in host)
                rows, mask, offs = tables
                cell = {n: state[n][:, :L] for n in fin}
                # a field's neighbour stack is gathered when the kernel
                # first reads it: a vlasov job never gathers its wide f
                nbr = _GatheredNeighbors({n: state[n] for n in fin},
                                         lambda t: t[:, rows])
                ex = tuple(extras[:, i:i + 1] for i in range(n_extra))
                out = kernel(cell, nbr, offs, mask, *ex)
                new = dict(state)
                for n in fout:
                    a = state[n].clone()
                    a[:, :L] = out[n].to(a.dtype)
                    new[n] = a
                return new

        def loop(state, extras, budget, q):
            for i in range(q):
                if bulk:
                    # the bulk step freezes spent slots itself (inside
                    # kernel A' on the card)
                    state = vstep(state, extras, budget, i)
                else:
                    new = vstep(state, extras)
                    # exhausted or masked slots keep their old bytes: the
                    # per-slot freeze the isolation contract rests on
                    state = {n: (roll_executor.fleet_freeze(
                        new[n], a, budget, i) if new[n] is not a else a)
                        for n, a in state.items()}
            return state

        # locals only: a `self` capture would pin every batch (its
        # [capacity, R] device tensors included) in the module-global
        # program cache
        schema, dev = self.schema, self.device
        watched = [n for n in sorted(schema) if schema[n][1].is_floating_point]
        fp_fields, conserved = self.fp_fields, self.conserved

        def finite(state):
            ok = torch.ones((cap,), dtype=torch.bool, device=dev)
            for n in watched:
                v = state[n][:, :L]
                ok = ok & torch.isfinite(v).reshape(v.shape[0], -1).all(dim=1)
            return ok

        def measure(state):
            # per-slot invariants over rows [0, L): int64 fingerprint
            # pairs [F, B, 2] in fp_fields order, float32 conservation
            # sums [C, B] in conserved order
            fp = (torch.stack([integrity.slot_fingerprints(state[n], L)
                               for n in fp_fields]) if fp_fields
                  else torch.zeros((0, cap, 2), dtype=torch.int64, device=dev))
            cs = (torch.stack([
                state[n][:, :L].reshape(state[n].shape[0], -1).sum(
                    dim=1, dtype=_F32) for n in conserved]) if conserved
                else torch.zeros((0, cap), dtype=_F32, device=dev))
            return fp, cs

        if int_on:
            def run_quantum(state, extras, budget, q):
                fp_in, cs_in = measure(state)
                out = loop(state, extras, budget, q)
                fp_out, cs_out = measure(out)
                return out, (fp_in, fp_out, cs_in, cs_out)

            def fp_now(state):
                return measure(state)[0]
        else:
            run_quantum, fp_now = loop, None
        return run_quantum, finite, fp_now, bulk

    # -- slot management ----------------------------------------------

    def free_slot(self):
        """Lowest free slot index, or None when the batch is full."""
        try:
            return self.slots.index(None)
        except ValueError:
            return None

    @property
    def jobs(self):
        """``[(slot, job)]`` of the occupied slots (DMR shadows
        excluded)."""
        return [(i, j) for i, j in enumerate(self.slots)
                if j is not None and j is not SHADOW]

    def admit(self, job: FleetJob, from_grid: bool = True):
        """Place ``job`` into the lowest free slot. With ``from_grid``
        (default) the scratch grid's current field data is copied into
        the slot."""
        slot = self.free_slot()
        if slot is None:
            raise RuntimeError("batch is full")
        self.slots[slot] = job
        self._extras[slot] = np.asarray(job.params, dtype=np.float32)
        if from_grid:
            self.read_grid(slot)
        return slot

    def clear(self, slot: int) -> None:
        """Free a slot together with its DMR shadows. The bytes stay:
        budget 0 freezes them and the next occupant overwrites every
        row."""
        self.slots[slot] = None
        for sh, primary in list(self.shadow_of.items()):
            if primary == slot:
                self.slots[sh] = None
                del self.shadow_of[sh]

    # -- DMR shadow replicas ------------------------------------------

    def admit_shadow(self, primary: int):
        """Occupy a free slot with a shadow replica of ``primary``
        (same bytes, same extras); None when the batch has no room."""
        slot = self.free_slot()
        if slot is None:
            return None
        self.slots[slot] = SHADOW
        self.shadow_of[slot] = primary
        self._extras[slot] = self._extras[primary]
        self.sync_shadow(primary)
        return slot

    def shadows(self, primary: int) -> list:
        """The shadow slots replicating ``primary``."""
        return [sh for sh, pr in self.shadow_of.items() if pr == primary]

    def sync_shadow(self, primary: int) -> None:
        """Copy ``primary``'s rows into its shadow slots exactly."""
        for sh in self.shadows(primary):
            for n in self.schema:
                self.state[n][sh] = self.state[n][primary]

    def read_grid(self, slot: int) -> None:
        """Copy the scratch grid's field data into ``slot`` (admission
        and per-slot restore); every other slot's bytes stay."""
        for n in self.schema:
            self.state[n][slot] = self.grid.data[n][0]

    def write_grid(self, slot: int) -> Grid:
        """Copy ``slot``'s field data into the scratch grid and return
        it."""
        for n in self.schema:
            self.grid.data[n] = self.state[n][slot][None].clone()
        return self.grid

    def extract(self, slot: int) -> dict:
        """Host copies of ``slot``'s field arrays (``[R, *shape]``
        numpy; bfloat16 as ``ml_dtypes.bfloat16``, as the reference
        returns it)."""
        return {n: _to_numpy(self.state[n][slot]) for n in self.schema}

    def insert(self, slot: int, host_state: dict) -> None:
        """Write :meth:`extract`-shaped host arrays (numpy, or tensors on
        any device) into ``slot`` exactly, copied into the batch's own
        storage on its device (a quarantine's migration between lanes);
        only that slot's rows change."""
        for n, arr in host_state.items():
            dtype = self.schema[n][1]
            t = (arr if isinstance(arr, torch.Tensor)
                 else _to_tensor(np.array(arr, order="C"), dtype))
            self.state[n][slot].copy_(t)

    # -- the batched quantum ------------------------------------------

    def step(self, budget) -> int:
        """Advance slot ``k`` by ``budget[k]`` steps in one quantum;
        returns the quantum length (max budget). Slots with budget 0
        are frozen exactly. With integrity on, the quantum also
        measures the per-slot invariants of its input and output state,
        read to the host once and published on :attr:`last_inv`."""
        # quantum boundaries are the fleet's step boundaries: a plan a
        # background recommit finished for the scratch grid installs
        # here, never mid-quantum (DCCRG_BG_RECOMMIT, as Grid.run_steps).
        # A distributed-AMR grid never reaches this site with a deferred
        # build: its install is an epoch-fenced collective (distamr), and
        # one host swapping while a peer steps the old plan is the
        # divergence the fenced protocol exists to prevent
        if self.grid.bg_pending():
            if getattr(self.grid, "_amr_group", None) is not None:
                raise RuntimeError(
                    "distributed-AMR grid reached a per-host swap site "
                    "with a deferred plan build; the fenced collective "
                    "install (distamr) must commit it instead")
            self.grid.bg_install()
        budget = np.asarray(budget, dtype=np.int32)
        q = int(budget.max()) if len(budget) else 0
        if q <= 0:
            return 0
        fn, _finite, fp_now, _bulk = self._programs()
        extras = torch.as_tensor(self._extras, device=self.device)
        budget_dev = torch.as_tensor(budget, device=self.device)
        out = fn(self.state, extras, budget_dev, q)
        if fp_now is None:
            self.state, self.last_inv = out, None
        else:
            self.state, inv = out
            fp_in, fp_out, cs_in, cs_out = _pack_host(inv)
            self.last_inv = {
                "fp_in": {n: fp_in[i] for i, n in enumerate(self.fp_fields)},
                "fp_out": {n: fp_out[i]
                           for i, n in enumerate(self.fp_fields)},
                "cs_in": {n: cs_in[i] for i, n in enumerate(self.conserved)},
                "cs_out": {n: cs_out[i]
                           for i, n in enumerate(self.conserved)},
            }
        self.dispatches += 1
        return q

    def bulk_active(self) -> bool:
        """Whether this bucket's quantum steps through kernel A' (the
        bulk program). Its arithmetic matches the table program only to
        float re-association, so bitwise comparisons against a solo run
        must not span the two."""
        return self._programs()[3]

    def finite_slots(self) -> np.ndarray:
        """Per-slot numerics watchdog: ``[capacity]`` bool, True where
        every floating element of the slot's rows ``[0, L)`` is finite.
        One device read for the whole fleet."""
        _fn, finite, _fp, _bulk = self._programs()
        return finite(self.state).cpu().numpy()

    def fingerprint_slots(self) -> dict:
        """Per-slot fingerprints of the current state:
        ``{field: uint32[capacity, 2]}``, bitwise comparable with the
        quantum's (:attr:`last_inv`). Raises RuntimeError with
        integrity off."""
        _fn, _finite, fp_now, _bulk = self._programs()
        if fp_now is None:
            raise RuntimeError(
                "fingerprint_slots needs DCCRG_INTEGRITY enabled")
        stack = fp_now(self.state).cpu().numpy().astype(np.uint32)
        return {n: stack[i] for i, n in enumerate(self.fp_fields)}

    def slot_fingerprint(self, slot: int) -> dict:
        """One slot's ``{field: (s1, s2)}``."""
        return {n: (int(v[slot, 0]), int(v[slot, 1]))
                for n, v in self.fingerprint_slots().items()}

    def poison(self, slot: int, fld: str, cells, value) -> None:
        """Write ``value`` into ``fld`` at ``cells`` of one slot (the
        fault-injection landing pad)."""
        _dev, rows = self.grid._host_rows(cells)
        self.state[fld][slot, torch.as_tensor(rows, device=self.device)] = \
            value

    def flip(self, slot: int, fld: str, cells, bit: int) -> None:
        """Land a finite bit flip in ``fld`` at ``cells`` of one slot:
        invisible to :meth:`finite_slots`, visible to the
        fingerprints. A bfloat16 element's bit ``k`` is bit ``k + 16``
        of its float32 widening, so bfloat16 flips go through float32
        and round back exactly (a finite fallback value rounds once)."""
        _dev, rows = self.grid._host_rows(cells)
        rows_t = torch.as_tensor(rows, device=self.device)
        cur = self.state[fld][slot, rows_t].cpu()
        if cur.dtype == torch.bfloat16:
            flipped = torch.from_numpy(
                faults.flip_values(cur.to(_F32).numpy(), int(bit) + 16))
        else:
            flipped = torch.from_numpy(faults.flip_values(cur.numpy(), bit))
        self.state[fld][slot, rows_t] = flipped.to(self.device, cur.dtype)

    def digest(self, slot: int) -> str:
        """SHA-256 over the slot's owned cell bytes: equals
        :func:`checkpoint.state_digest` of a solo grid holding the same
        state."""
        h = hashlib.sha256()
        for name in sorted(self.schema):
            shape, dtype = self.schema[name]
            checkpoint_mod.digest_update(
                h, name, shape, dtype, self.state[name][slot][:self.n_own])
        return h.hexdigest()


# ---------------------------------------------------------------------
# job records
# ---------------------------------------------------------------------

def job_from_row(row: dict, *, validate_kernel: bool = False) -> FleetJob:
    """Parse one job record into a :class:`FleetJob`. Keys: ``name``
    (required, unique), ``n`` (cube edge) or ``length`` [x, y, z],
    ``kernel`` (registry name), ``steps``, ``params`` (list of floats;
    ``dt`` is shorthand for one), ``priority``, ``seed``,
    ``checkpoint_every``, ``periodic`` [bool, bool, bool],
    ``redundancy`` (2 = DMR: two slots step the job and their digests
    are compared every quantum), ``slo_ms`` (completion deadline in
    milliseconds for the scheduler's SLO admission; absent =
    best-effort). Malformed records raise :class:`JobSpecError`;
    ``validate_kernel=True`` resolves the kernel name at once, so an
    unknown kernel raises :class:`UnknownKernelError` here."""
    if not isinstance(row, dict):
        raise JobSpecError(f"job row is not a mapping: {row!r}")
    if "name" not in row:
        raise JobSpecError(f"job row without a name: {row}")
    try:
        length = (tuple(int(v) for v in row["length"])
                  if "length" in row else (int(row.get("n", 16)),) * 3)
        if len(length) != 3 or any(v < 1 for v in length):
            raise JobSpecError(
                f"job {row['name']!r}: bad length {length}")
        params = row.get("params")
        if params is None and "dt" in row:
            params = [float(row["dt"])]
        job = FleetJob(
            row["name"], length=length,
            kernel=row.get("kernel", "diffuse"),
            n_steps=int(row.get("steps", 10)), params=params,
            priority=int(row.get("priority", 0)),
            seed=int(row.get("seed", 0)),
            periodic=tuple(row.get("periodic", (True, True, True))),
            checkpoint_every=int(row.get("checkpoint_every", 8)),
            redundancy=int(row.get("redundancy", 1)),
            slo_ms=row.get("slo_ms"),
        )
    except JobSpecError:
        raise
    except (TypeError, ValueError, KeyError) as e:
        raise JobSpecError(
            f"job {row.get('name')!r}: malformed record: {e}") from e
    if validate_kernel and not callable(job.kernel):
        job.resolved_kernel()
    return job


def _jobs_from_spec(spec: dict) -> list:
    """Parse a job-file dict (``{"jobs": [{...}]}``) into
    :class:`FleetJob` objects through :func:`job_from_row`."""
    return [job_from_row(row) for row in spec.get("jobs", [])]


# ---------------------------------------------------------------------
# CLI: python -m dccrg_tpu_torch.fleet <jobs.json> | --demo N
# ---------------------------------------------------------------------

def _main(argv=None) -> int:
    """``python -m dccrg_tpu_torch.fleet jobs.json [--workdir DIR]``:
    run a fleet job file through :class:`~dccrg_tpu_torch.scheduler
    .FleetScheduler` (``--demo N`` makes N diffuse jobs instead). Prints
    one JSON row per finished job plus a summary; exits 75 (resumable)
    when preempted mid-fleet, and a rerun with the same workdir resumes
    every requeued job from its emergency checkpoint. Runs on the card;
    ``--device cpu`` (or ``DCCRG_FLEET_BACKEND=cpu``) asks for the CPU,
    and without a card and without that choice the run stops with exit
    code 2."""
    import argparse
    import json
    import sys
    import tempfile
    import time

    ap = argparse.ArgumentParser(prog="python -m dccrg_tpu_torch.fleet",
                                 description=_main.__doc__)
    ap.add_argument("jobs_file", nargs="?", default=None,
                    help="JSON job file ({'jobs': [{...}]})")
    ap.add_argument("--demo", type=int, default=None, metavar="N",
                    help="make N diffuse jobs instead of reading a file")
    ap.add_argument("--n", type=int, default=16,
                    help="--demo grid edge length (default 16)")
    ap.add_argument("--steps", type=int, default=20,
                    help="--demo steps per job (default 20)")
    ap.add_argument("--workdir", default=None,
                    help="checkpoint directory (default: a temp dir)")
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--quantum", type=int, default=None)
    ap.add_argument("--keep-last", type=int, default=None)
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore existing checkpoints in the workdir")
    ap.add_argument("--autopilot", action="store_true",
                    help="enable the telemetry-driven self-tuning "
                         "controller (same as DCCRG_AUTOPILOT=1; "
                         "decisions journal to DCCRG_DECISION_FILE)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; DCCRG_FLEET_BACKEND "
                         "sets the default")
    args = ap.parse_args(argv)
    device = args.device or os.environ.get("DCCRG_FLEET_BACKEND") or "cuda"
    if device.startswith("cuda") and not torch.cuda.is_available():
        print("python -m dccrg_tpu_torch.fleet: no CUDA device is "
              "available; pass --device cpu (or DCCRG_FLEET_BACKEND=cpu) "
              "to run on the CPU", file=sys.stderr)
        return 2
    if args.autopilot:
        os.environ["DCCRG_AUTOPILOT"] = "1"

    from .scheduler import FleetPreemptedError, FleetScheduler

    if args.demo is not None:
        jobs = [FleetJob(f"demo{i:04d}", length=(args.n,) * 3,
                         n_steps=args.steps, params=(0.05,), seed=i,
                         priority=i % 3)
                for i in range(args.demo)]
    elif args.jobs_file:
        with open(args.jobs_file) as f:
            jobs = _jobs_from_spec(json.load(f))
    else:
        ap.error("either a jobs file or --demo N is required")

    workdir = args.workdir or tempfile.mkdtemp(prefix="dccrg_fleet_")
    sched = FleetScheduler(
        workdir, jobs, max_batch=args.max_batch, quantum=args.quantum,
        keep_last=args.keep_last, resume=not args.no_resume,
        devices=[torch.device(device)], install_signal_handlers=True)
    t0 = time.perf_counter()
    try:
        report = sched.run()
    except FleetPreemptedError as e:
        print(json.dumps({"preempted": True,
                          "requeued": e.requeued,
                          "workdir": workdir}), flush=True)
        return e.exit_code
    wall = time.perf_counter() - t0
    from . import telemetry

    reg = telemetry.registry()
    done = failed = steps = 0
    for name in sorted(report):
        row = dict(report[name], name=name)
        # the per-job summary comes from the telemetry registry (the
        # series dump_prometheus exposes): quantum-latency quantiles,
        # trip and rollback counters, throughput over the fleet wall
        h = reg.histogram("dccrg_fleet_quantum_seconds", job=name)
        row.update({
            "quantum_p50_ms": (round(h.quantile(0.5) * 1e3, 3)
                               if h is not None and h.total else None),
            "quantum_p99_ms": (round(h.quantile(0.99) * 1e3, 3)
                               if h is not None and h.total else None),
            "trips_total": int(reg.counter_total(
                "dccrg_fleet_trips_total", job=name)),
            "rollbacks_total": int(reg.counter_total(
                "dccrg_fleet_rollbacks_total", job=name)),
            "steps_per_s": (round(row["steps"] / wall, 3)
                            if wall > 0 else None),
        })
        print(json.dumps(row), flush=True)
        done += row["status"] == "done"
        failed += row["status"] == "failed"
        steps += row["steps"]
    summary = {
        "jobs": len(report), "done": done, "failed": failed,
        "steps_total": steps, "wall_s": round(wall, 3),
        "runs_per_s": round(done / wall, 3) if wall > 0 else None,
        "workdir": workdir, "device": str(device)}
    if sched.autopilot is not None:
        ap_state = sched.autopilot
        summary["autopilot"] = {
            "decisions": ap_state.seq,
            "quantum": ap_state.quantum,
            "audit_every": ap_state.audit_every,
            "learned_capacities": dict(ap_state.capacity),
        }
    print(json.dumps({"summary": summary}), flush=True)
    return 0 if failed == 0 else 1


if __name__ == "__main__":  # pragma: no cover - exercised via the CLI
    import sys

    # `python -m dccrg_tpu_torch.fleet` loads this file as __main__, a
    # second module instance with its own registries; the model zoo
    # registers into the canonical `dccrg_tpu_torch.fleet`, so the CLI
    # runs through that instance or a zoo kernel a job file names would
    # be unknown here
    from dccrg_tpu_torch import fleet as _canonical

    sys.exit(_canonical._main())
