"""Deterministic fault injection of the port (counterpart of
``dccrg_tpu/faults.py``, whole).

A :class:`FaultPlan` is a seedable, deterministic schedule of faults,
installed as the process-wide active plan via context manager::

    plan = FaultPlan(seed=7)
    plan.io_error(times=1)                   # first checkpoint write fails
    plan.nan_poison("density", step=13)      # NaN lands after step 13
    with plan:
        ...
    assert plan.fired("step.poison")

Instrumented call sites consult the active plan through the module
hooks: :func:`fire` raises a scheduled exception at a named site
(``checkpoint.write``, ``checkpoint.chunk``, ``adapt.commit``,
``adapt.resolve``, ``grid.restructure``, ``balance.commit``,
``hybrid.recommit``, ``telemetry.export``, ...); the ``take_*``
queries turn a scheduled rule into a non-raising decision at sites
that must act on it themselves; :func:`corrupt_file`,
:func:`poison_step` and :func:`flip_step` mutate a just-written file or
a grid's fields. The builders for sites the port has not reached yet
(spool, warm start, host death, multi-process phases) are plain data.

When no plan is installed every hook is a no-op, so the hooks cost one
``is None`` check on hot paths. All randomness (which byte, cell or
bit) comes from the plan's seeded numpy generator, drawn in the
reference's order, so a plan with the same seed injects the same
faults as the reference's plan.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch


class SimulatedResourceExhausted(RuntimeError):
    """Injected stand-in for a device OOM. The message carries the
    literal ``RESOURCE_EXHAUSTED`` marker so handlers that match real
    XlaRuntimeError text treat both identically."""

    def __init__(self, detail: str = ""):
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected device OOM {detail}".rstrip()
        )


class InjectedIOError(OSError):
    """Injected transient I/O failure (checkpoint writes)."""


class InjectedProbeHang(TimeoutError):
    """Injected device-probe timeout (a dead accelerator tunnel)."""


class InjectedDispatchError(RuntimeError):
    """Injected TRANSIENT step-dispatch failure — the ``UNAVAILABLE`` /
    ``DEADLINE_EXCEEDED`` class of XLA runtime errors a flaky
    host-to-accelerator link produces. The message carries the literal
    ``UNAVAILABLE`` marker so handlers that match real XlaRuntimeError
    text treat both identically; the supervision layer must retry it
    with backoff instead of tripping a rollback."""

    def __init__(self, detail: str = ""):
        super().__init__(
            f"UNAVAILABLE: injected transient dispatch error {detail}".rstrip()
        )


class InjectedMutationError(RuntimeError):
    """Injected failure inside a structural mutation (AMR commit, load
    balance, plan rebuild). The transactional layer in txn.py must
    catch it, roll the grid back to the pre-mutation snapshot and
    re-raise as MutationAbortedError — the atomicity tests pin that."""


class InjectedRankDeath(RuntimeError):
    """Injected death of this rank at an instrumented multi-process
    point (the two-phase checkpoint phases, coord barriers). The faked
    test harness catches it at the per-rank pass boundary and asserts
    the surviving protocol state (old checkpoint intact, commit
    aborted); the REAL harness (tests/mp_harness.py) lets it propagate
    out of the child's main and exits the OS process — an actual dead
    rank, whose peers must then hit their barrier timeouts."""


@dataclass
class _Rule:
    site: str
    kind: str
    times: float  # math.inf = every time
    params: dict = field(default_factory=dict)
    fired: int = 0

    def matches(self, site: str, ctx: dict) -> bool:
        if self.site != site or self.fired >= self.times:
            return False
        for key in ("mode", "step", "phase", "tag", "rank", "job",
                    "tick", "key", "op"):
            want = self.params.get(key)
            if want is None:
                continue
            have = ctx.get(key)
            if key == "tag":
                # barrier tags carry protocol suffixes (the two-phase
                # save appends `#<attempt>`): a rule tag is a PREFIX
                if not (isinstance(have, str) and have.startswith(want)):
                    return False
            elif have != want:
                return False
        return True


# Canonical (site, phase) fault points of the transactional mutation
# paths, grouped by the mutation that reaches them — THE single table
# the fuzzer (fuzz._FAULT_SITES) and the per-point atomicity tests
# (tests/test_txn.py) both consume, so a newly instrumented
# ``fire(site, phase=...)`` call only needs registering here to be
# exercised everywhere.
MUTATION_FAULT_SITES = {
    "adapt": (
        ("adapt.commit", "resolve"), ("adapt.commit", "resolved"),
        ("adapt.commit", "preserved"), ("adapt.resolve", "pins"),
        ("grid.restructure", "planned"), ("grid.restructure", "moved"),
        ("hybrid.recommit", "classified"), ("hybrid.recommit", "cached"),
        ("hybrid.recommit", "tables"),
    ),
    "balance": (
        ("partition.compute", None), ("balance.commit", "partition"),
        ("balance.commit", "stage"), ("balance.commit", "finish"),
        ("balance.commit", "land"), ("grid.restructure", "planned"),
        ("grid.restructure", "moved"),
        # a balance on a REFINED grid rebuilds through the hybrid
        # builder too — its fault points are reachable from both paths
        ("hybrid.recommit", "classified"), ("hybrid.recommit", "cached"),
        ("hybrid.recommit", "tables"),
    ),
}

# Canonical (site, phase) fault points of the DISTRIBUTED AMR commit
# (dccrg_tpu_torch/distamr.py), one per protocol phase — consumed by the
# distributed fuzz leg (fuzz.distributed_amr_case) and
# tests/test_distamr.py. Deliberately NOT in MUTATION_FAULT_SITES:
# these fire only when an AmrCommitGroup drives the commit, so the
# single-grid fuzzer would wait forever for them.
DIST_AMR_FAULT_SITES = (
    ("amr.propose", None),
    ("amr.resolve", None),
    ("amr.install", "prepare"),
    ("amr.install", "commit"),
)

# streaming-intake fault sites (dccrg_tpu_torch/intake.py): the spool
# submission/scan/read points plus the claim->add exactly-once
# admission window. Fire only when a StreamIntake drives admission,
# so — like DIST_AMR_FAULT_SITES — they are deliberately NOT in
# MUTATION_FAULT_SITES (the single-grid fuzzer would wait forever).
INTAKE_FAULT_SITES = (
    ("intake.spool.write.torn", None),
    ("intake.spool.rename.torn", None),
    ("intake.spool.scan", None),
    ("intake.spool.read", None),
    ("intake.claim", None),
)

# warm-start cache fault sites (dccrg_tpu_torch/warmstart.py): the persisted
# compile-cache manifest's torn/corrupt/stale-version write faults,
# cache-dir I/O errors and a rank death mid-prewarm. Each must degrade
# to a COLD compile with a typed error + quarantined entry — never a
# wrong program. Fire only when a WarmPool drives a cache, so — like
# DIST_AMR_FAULT_SITES / INTAKE_FAULT_SITES — they are deliberately
# NOT in MUTATION_FAULT_SITES (the single-grid fuzzer would wait
# forever for them).
WARMSTART_FAULT_SITES = (
    ("warm.manifest.write.torn", None),
    ("warm.manifest.write.corrupt", None),
    ("warm.manifest.write.stale", None),
    ("warm.cache.io", None),
    ("warm.prewarm", None),
)

_active: "FaultPlan | None" = None


class FaultPlan:
    """A deterministic, seedable schedule of injected faults.

    Rules are added with the ``*_`` convenience methods below and fire
    at the instrumented sites while the plan is installed (``with
    plan:``). Each rule fires at most ``times`` times (default once);
    ``times=math.inf`` fires forever. ``plan.log`` records every
    firing as ``(site, kind, detail)`` for test assertions."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.rules: list[_Rule] = []
        self.log: list[tuple[str, str, dict]] = []

    # -- schedule builders --------------------------------------------

    def _add(self, site, kind, times, **params):
        self.rules.append(_Rule(site, kind, times, params))
        return self

    def io_error(self, times=1, site="checkpoint.write", phase=None,
                 rank=None):
        """Transient I/O error during a checkpoint write (before the
        atomic rename — the previous checkpoint must survive).
        ``phase``/``rank`` narrow multi-phase sites (e.g. the two-phase
        save's ``checkpoint.mp``) to one instrumented point."""
        return self._add(site, "io", times, phase=phase, rank=rank)

    def chunk_io_error(self, times=1):
        """I/O error mid payload stream (a torn temp file)."""
        return self._add("checkpoint.chunk", "io", times)

    def truncate(self, times=1, drop_bytes=None):
        """Truncate a just-written checkpoint file (torn/partial
        write reaching the final name). ``drop_bytes=None`` drops a
        seeded random amount of the tail."""
        return self._add("checkpoint.file", "truncate", times,
                         drop_bytes=drop_bytes)

    def bit_flip(self, times=1, byte_index=None, bit=None):
        """Flip one bit of a just-written checkpoint file (silent disk
        corruption). Position defaults to a seeded random payload
        byte."""
        return self._add("checkpoint.file", "bitflip", times,
                         byte_index=byte_index, bit=bit)

    def resource_exhausted(self, times=1, mode=None, job=None):
        """Simulated XLA RESOURCE_EXHAUSTED at step dispatch. With
        ``mode`` the rule fires only for that gather mode (e.g. only
        the dense path OOMs; the slot-wise fallback fits). With
        ``job`` the rule fires only for that fleet job's dispatch
        (the fleet layer fires ``step.dispatch`` per admitted job, so
        chaos tests can OOM exactly one batch slot — its neighbors'
        bits must not move)."""
        return self._add("step.dispatch", "oom", times, mode=mode, job=job)

    def nan_poison(self, fld, step, cells=None, value=float("nan"),
                   times=1, job=None):
        """Write ``value`` into ``fld`` for ``cells`` (default: one
        seeded local cell) after step ``step`` completes. ``times > 1``
        re-poisons on every replay of that step (a deterministic
        blow-up the rollback cannot outrun — the retry-bound test).
        With ``job`` the poison targets ONE fleet batch slot (consumed
        via :func:`poison_fleet` by the fleet layer; job-scoped rules
        never fire at the plain per-grid ``poison_step`` site)."""
        return self._add("step.poison", "nan", times, field=fld, step=step,
                         cells=cells, value=value, job=job)

    def probe_hang(self, times=1):
        """Device probe times out (dead accelerator tunnel)."""
        return self._add("device.probe", "hang", times)

    def barrier_hang(self, tag=None, times=1, hang_s=None):
        """A coordination barrier never completes — the signature of a
        LOST RANK on a multi-process mesh. ``coord.barrier``'s watchdog
        must raise :class:`~dccrg_tpu_torch.coord.BarrierTimeoutError` naming
        the tag within its bound. ``tag`` narrows to one barrier by
        PREFIX (None: the next one) — the two-phase save suffixes its
        tags with ``#<attempt>``, so ``tag="save_commit:a.dc"`` hits
        every attempt; a finite ``hang_s`` below the barrier timeout
        models a slow-but-alive peer instead (the barrier completes)."""
        return self._add("coord.barrier_hang", "hang", times, tag=tag,
                         hang_s=hang_s)

    def preempt_signal(self, step=None, times=1):
        """A preemption signal (the scheduler's SIGTERM) 'arrives': the
        supervision layer's step-boundary poll observes it right after
        step ``step`` completes (None: the next boundary), exactly as
        if a real signal handler had set the preempt flag mid-step.
        Queried — not raised — through :func:`take_preempt`, so the
        whole emergency-checkpoint/resumable-exit machinery of
        :class:`dccrg_tpu_torch.supervise.SupervisedRunner` is what gets
        exercised (tier-1's stand-in for the REAL ``kill -TERM`` the
        mp harness delivers)."""
        return self._add("supervise.preempt", "preempt", times, step=step)

    def step_hang(self, step=None, times=1, hang_s=None):
        """The dispatched step wedges — a hung collective or a dead
        accelerator tunnel mid-dispatch. Queried by the supervision
        layer's deadline watchdog (:func:`take_step_hang`): the hang
        replaces the dispatch inside the watchdog's worker thread, so
        the timeout machinery itself is what gets exercised
        (:class:`~dccrg_tpu_torch.supervise.StepTimeoutError` within the
        bound, never a block-forever). A finite ``hang_s`` below the
        step deadline models a slow-but-alive step that completes."""
        return self._add("supervise.hang", "hang", times, step=step,
                         hang_s=hang_s)

    def silent_flip(self, fld, step, cells=None, bit=23, times=1,
                    job=None):
        """Land a FINITE bit-flip in ``fld`` after step ``step`` — the
        silent-data-corruption fault class. Unlike
        :meth:`nan_poison`, the corrupted value stays finite and
        plausible by construction (``bit`` defaults to the float32
        exponent LSB: the value halves or doubles; a flip that would
        land non-finite falls back to a finite wrong value instead),
        so ``comm.all_finite`` / ``GridBatch.finite_slots`` pass and
        only the integrity layer (:mod:`dccrg_tpu_torch.integrity`:
        in-program fingerprints, conservation drift, shadow audits)
        can see it. ``cells=None`` picks one seeded local cell.
        With ``job`` the flip targets ONE fleet batch slot (consumed
        via :func:`flip_fleet`; job-scoped rules never fire at the
        per-grid :func:`flip_step` site)."""
        return self._add("step.flip", "flip", times, field=fld,
                         step=step, cells=cells, bit=bit, job=job)

    def dispatch_error(self, times=1, step=None, job=None):
        """Transient dispatch failure (:class:`InjectedDispatchError`,
        the UNAVAILABLE class) at step dispatch. The supervision layer
        must retry with bounded backoff and succeed WITHOUT tripping a
        rollback. With ``job`` the rule fires only for that fleet
        job's dispatch (the fleet retries just that job's quantum)."""
        return self._add("supervise.dispatch", "dispatch", times, step=step,
                         job=job)

    def delta_parent_corrupt(self, times=1):
        """Corrupt the parent content digest an incremental (delta)
        checkpoint records in its sidecar — the parent-link corruption
        class. Queried — not raised — by
        :func:`dccrg_tpu_torch.resilience.save_delta_checkpoint` via
        :func:`take_delta_parent_corrupt`: the save completes with a
        wrong link, chain verification must then name the broken link
        and ``resume_latest`` must fall back to the last verifying
        prefix."""
        return self._add("checkpoint.delta", "parent_corrupt", times)

    def telemetry_io_error(self, times=1):
        """I/O error at a telemetry exporter write (``telemetry.export``
        — trace JSONL flushes and metrics-file exposition dumps).
        Telemetry is strictly best-effort: the write is dropped and
        counted, and the observed run must proceed with ZERO trips or
        rollbacks (pinned by tests/test_telemetry.py)."""
        return self._add("telemetry.export", "io", times)

    def gc_error(self, times=1):
        """I/O error mid retention-GC prune (``checkpoint.gc``, fired
        before an unlink). The chain-aware deletion order — deltas
        newest-first, keyframe last — must leave NO orphaned delta
        behind, whichever unlink the fault lands on."""
        return self._add("checkpoint.gc", "io", times)

    def rank_death(self, site="checkpoint.mp", phase=None, rank=None,
                   times=1):
        """This rank dies at an instrumented multi-process point
        (raises :class:`InjectedRankDeath`). Phases of the two-phase
        checkpoint save (``site="checkpoint.mp"``): ``meta`` (before
        the meta/offset-table prepare), ``slice`` (mid payload-run
        write), ``written`` (slice complete, before the commit
        barrier), ``commit`` (on the committing rank, before
        verify+rename), ``publish`` (after the rename, before the
        sidecar lands). ``rank`` narrows to one rank's pass."""
        return self._add(site, "rank_death", times, phase=phase, rank=rank)

    def host_death(self, rank=None, at_tick=None, times=1):
        """This HOST dies at a fleet-scheduler tick boundary — the
        elastic-fleet fault class (whole-rank loss mid-serve, outside
        any checkpoint barrier). Queried — not raised — through
        :func:`take_host_death` by
        :class:`~dccrg_tpu_torch.scheduler.FleetScheduler`, which raises
        :class:`InjectedRankDeath` when it fires: in-process tests
        catch it at the loop boundary and drive the SURVIVOR
        scheduler's lease-expiry reclaim; the REAL harness
        (tests/mp_harness.py ``host_death``) instead delivers an
        actual ``kill -9`` to the worker rank's OS process — same
        recovery contract, real corpse. ``rank``/``at_tick`` narrow
        to one rank's pass / one tick boundary."""
        return self._add("fleet.host", "host_death", times, rank=rank,
                         tick=at_tick)

    def mutation_error(self, site="adapt.commit", times=1, phase=None):
        """Fault inside a structural mutation. Sites (each names where
        in the commit the failure lands; ``phase`` narrows to one):

        - ``adapt.commit``     — stop_refining (phases ``resolve``,
                                 ``resolved``, ``preserved``)
        - ``adapt.resolve``    — end of resolve_adaptation, after the
                                 pins/weights inheritance (phase ``pins``)
        - ``grid.restructure`` — plan rebuild + data move, shared by
                                 adapt and balance (phases ``planned``,
                                 ``moved``)
        - ``balance.commit``   — balance_load stages (phases
                                 ``partition``, ``stage``, ``finish``,
                                 ``land``)
        - ``hybrid.recommit``  — the hybrid plan builder for refined
                                 grids (phases ``classified``, ``cached``)
        - ``partition.compute``— inside the SFC partitioner
        """
        return self._add(site, "mutation", times, phase=phase)

    def amr_error(self, site="amr.propose", phase=None, rank=None,
                  times=1):
        """Raise (:class:`InjectedMutationError`) at a distributed-AMR
        commit phase — sites ``amr.propose`` / ``amr.resolve`` /
        ``amr.install`` (phases ``prepare``, ``commit``), the named
        fault points of dccrg_tpu_torch/distamr.py. The cross-rank
        transaction must roll this rank back bitwise, restore its
        request sets, and post the abort marker every peer fast-aborts
        on; the fleet keeps serving the OLD plan. ``rank`` narrows to
        one rank's pass (faked in-process groups carry real rank
        ids)."""
        return self._add(site, "mutation", times, phase=phase, rank=rank)

    def amr_hang(self, site="amr.resolve", hang_s=None, phase=None,
                 rank=None, times=1):
        """This rank STALLS inside a distributed-AMR commit phase — the
        SIGSTOP-zombie / wedged-KV fault class. Queried — not raised —
        through :func:`take_amr_hang` (site suffixed ``.hang``, same
        discipline as :meth:`barrier_hang`): the stall replaces the
        phase work, so the PEERS' deadline-bounded proposal collects
        and fenced barriers are what get exercised — they must abort
        typed within their bound, and a commit the survivors re-form
        afterwards advances the fence so the woken zombie loses
        (:class:`~dccrg_tpu_torch.coord.StaleFenceError`). ``hang_s=None``
        stalls past any deadline (``math.inf``)."""
        return self._add(site + ".hang", "hang", times, phase=phase,
                         rank=rank, hang_s=hang_s)

    def amr_torn_record(self, site="amr.propose", rank=None, times=1):
        """This rank stores its sealed proposal/commit record with a
        corrupted tail — the half-written KV record of a rank that died
        mid-write. Queried — not raised — through
        :func:`take_torn_record` by the record WRITER (site suffixed
        ``.torn``), so the damage lands in the store and every READER's
        CRC frame check (:func:`~dccrg_tpu_torch.coord.unseal_record`) is
        what gets exercised: conviction as
        :class:`~dccrg_tpu_torch.coord.TornRecordError` and a collective
        abort, never action on the torn payload."""
        return self._add(site + ".torn", "torn", times, rank=rank)

    # -- streaming-intake spool faults (dccrg_tpu_torch/intake.py) ----------

    def spool_torn_write(self, times=1, job=None):
        """A submitter dies mid spec write: the spool file LANDS with
        a truncated sealed frame (a partial spec write reaching the
        final name). Queried — not raised — through
        :func:`take_spool_torn` by :func:`intake.submit`, so the torn
        bytes are durable and the intake reader's CRC conviction
        (:class:`~dccrg_tpu_torch.coord.TornRecordError`), bounded retries
        and poison-job quarantine are what get exercised."""
        return self._add("intake.spool.write.torn", "torn", times,
                         job=job)

    def spool_torn_rename(self, times=1, job=None):
        """A submitter dies BETWEEN the temp write and the atomic
        rename-in: the spec stays in the temp directory and never
        becomes visible (the other half of the torn-submission fault
        class). Queried — not raised — through
        :func:`take_spool_torn_rename` by :func:`intake.submit`; the
        stream must simply never see the job (durable-spool contract:
        visibility IS the rename)."""
        return self._add("intake.spool.rename.torn", "torn", times,
                         job=job)

    def spool_delay(self, times=1, rank=None):
        """Delayed directory visibility: one spool scan fails to see
        the newest not-yet-tracked entry (an NFS-ish lagging readdir).
        Queried — not raised — through :func:`take_spool_delay` by the
        intake scanner; the entry must be admitted by a LATER scan,
        never lost."""
        return self._add("intake.spool.scan", "delay", times,
                         rank=rank)

    def spool_io_error(self, times=1, job=None, rank=None):
        """Transient I/O error reading a spool spec file (site
        ``intake.spool.read``) — the retry/backoff envelope's bread
        and butter: under ``times < K`` retries the job must still
        admit; at ``times >= K`` it must quarantine with a structured
        reason instead of wedging the stream."""
        return self._add("intake.spool.read", "io", times, job=job,
                         rank=rank)

    def intake_death(self, rank=None, times=1, job=None):
        """This rank dies BETWEEN the spool claim (intake lease
        acquired, journal record written) and the scheduler add —
        the exactly-once admission window. Raised at site
        ``intake.claim`` as :class:`InjectedRankDeath`: in-process
        tests catch it and drive a survivor intake's lease-expiry
        reclaim; the REAL harness (tests/mp_harness.py
        ``intake_kill``) hard-exits the OS process, and the surviving
        fleet must re-admit from the journal record exactly once."""
        return self._add("intake.claim", "rank_death", times,
                         rank=rank, job=job)

    # -- warm-start cache faults (dccrg_tpu_torch/warmstart.py) -------------

    def warm_torn_manifest(self, times=1, key=None):
        """A manifest writer dies mid-write: the per-key record LANDS
        at its final name with a truncated sealed frame. Queried — not
        raised — through :func:`take_warm_torn` by the warmstart
        manifest writer, so the torn bytes are durable and every
        loader's CRC conviction (:class:`~dccrg_tpu_torch.coord
        .TornRecordError` -> typed ``WarmCacheError``, entry
        quarantined, cold compile) is what gets exercised."""
        return self._add("warm.manifest.write.torn", "torn", times,
                         key=key)

    def warm_corrupt_entry(self, times=1, key=None):
        """Silent corruption of a landed manifest entry's payload
        bytes (one flipped byte INSIDE the sealed frame — the CRC
        still reads as a frame, the payload no longer matches it).
        Queried through :func:`take_warm_corrupt` by the writer; the
        loader must convict, quarantine and fall cold."""
        return self._add("warm.manifest.write.corrupt", "corrupt",
                         times, key=key)

    def warm_stale_epoch(self, times=1, key=None):
        """A manifest entry lands stamped with a DIFFERENT cache
        epoch (the record of a run on older jax/jaxlib/package
        versions). Queried through :func:`take_warm_stale` by the
        writer; the loader must REJECT it to cold compile — a drifted
        cache is never trusted."""
        return self._add("warm.manifest.write.stale", "stale", times,
                         key=key)

    def warm_io_error(self, times=1, op=None):
        """Transient I/O error at a warm-cache dir operation (site
        ``warm.cache.io``; ``op`` narrows to ``read``/``write``/
        ``scan``/``gc``). The pool must degrade that one entry (or
        pass) to cold compile and keep serving — telemetry-discipline
        best-effort, never a crash."""
        return self._add("warm.cache.io", "io", times, op=op)

    def warm_prewarm_death(self, times=1, rank=None):
        """This rank dies mid-prewarm (site ``warm.prewarm``, raised
        as :class:`InjectedRankDeath` between two background
        pre-compiles): the manifest and cache dir must stay
        loadable — the next boot simply re-warms — and an in-process
        caller sees the typed death, not a wedged pool."""
        return self._add("warm.prewarm", "rank_death", times,
                         rank=rank)

    # -- installation -------------------------------------------------

    def __enter__(self):
        global _active
        if _active is not None:
            raise RuntimeError("a FaultPlan is already active")
        _active = self
        return self

    def __exit__(self, *exc):
        global _active
        _active = None
        return False

    def fired(self, site: str) -> int:
        """How many injections have fired at ``site``."""
        return sum(1 for s, _k, _d in self.log if s == site)

    # -- firing (internal) --------------------------------------------

    def _take(self, site: str, ctx: dict) -> "_Rule | None":
        for r in self.rules:
            if r.matches(site, ctx):
                r.fired += 1
                return r
        return None


def active() -> "FaultPlan | None":
    return _active


def fire(site: str, **ctx) -> None:
    """Raise the scheduled exception for ``site``, if any. Called from
    the instrumented sites; no-op without an active plan."""
    plan = _active
    if plan is None:
        return
    rule = plan._take(site, ctx)
    if rule is None:
        return
    plan.log.append((site, rule.kind, dict(ctx)))
    if rule.kind == "io":
        raise InjectedIOError(f"injected I/O error at {site}")
    if rule.kind == "oom":
        raise SimulatedResourceExhausted(f"at {site} {ctx}")
    if rule.kind == "hang":
        raise InjectedProbeHang(f"injected probe timeout at {site}")
    if rule.kind == "mutation":
        raise InjectedMutationError(
            f"injected mutation fault at {site} {ctx}".rstrip())
    if rule.kind == "rank_death":
        raise InjectedRankDeath(
            f"injected rank death at {site} {ctx}".rstrip())
    if rule.kind == "dispatch":
        raise InjectedDispatchError(f"at {site} {ctx}".rstrip())
    raise AssertionError(f"rule kind {rule.kind!r} cannot fire at {site}")


def take_barrier_hang(tag: str):
    """Consume a scheduled barrier hang for ``tag``; returns the hang
    duration in seconds (math.inf for a dead rank) or None. Queried —
    not raised — by coord.barrier: the hang replaces the sync inside
    the watchdog thread, so the timeout machinery itself is what gets
    exercised."""
    plan = _active
    if plan is None:
        return None
    rule = plan._take("coord.barrier_hang", {"tag": tag})
    if rule is None:
        return None
    plan.log.append(("coord.barrier_hang", "hang", {"tag": tag}))
    hang = rule.params.get("hang_s")
    return math.inf if hang is None else float(hang)


def take_amr_hang(site: str, phase=None, rank=None):
    """Consume a scheduled :meth:`~FaultPlan.amr_hang` for this rank's
    distributed-AMR phase; returns the stall duration in seconds
    (math.inf for a frozen-forever rank) or None. Queried — not raised
    — by distamr so the stall happens INSIDE the phase: the peers'
    deadline machinery is what gets exercised."""
    plan = _active
    if plan is None:
        return None
    ctx = {"phase": phase, "rank": rank}
    rule = plan._take(site + ".hang", ctx)
    if rule is None:
        return None
    plan.log.append((site + ".hang", "hang", dict(ctx)))
    hang = rule.params.get("hang_s")
    return math.inf if hang is None else float(hang)


def take_torn_record(site: str, rank=None) -> bool:
    """Consume a scheduled :meth:`~FaultPlan.amr_torn_record` for this
    rank's record write; True when one fired. Queried — not raised —
    by the record writer so the torn bytes LAND in the KV and the
    readers' CRC conviction is what gets exercised."""
    plan = _active
    if plan is None:
        return False
    ctx = {"rank": rank}
    rule = plan._take(site + ".torn", ctx)
    if rule is None:
        return False
    plan.log.append((site + ".torn", "torn", dict(ctx)))
    return True


def take_spool_torn(job=None) -> bool:
    """Consume a scheduled :meth:`~FaultPlan.spool_torn_write` for
    this submission; True when one fired (the submitter then lands a
    truncated sealed frame at the FINAL spool name)."""
    plan = _active
    if plan is None:
        return False
    ctx = {"job": job}
    rule = plan._take("intake.spool.write.torn", ctx)
    if rule is None:
        return False
    plan.log.append(("intake.spool.write.torn", "torn", dict(ctx)))
    return True


def take_spool_torn_rename(job=None) -> bool:
    """Consume a scheduled :meth:`~FaultPlan.spool_torn_rename`; True
    when one fired (the submitter then leaves the spec in the temp
    directory — it never becomes visible)."""
    plan = _active
    if plan is None:
        return False
    ctx = {"job": job}
    rule = plan._take("intake.spool.rename.torn", ctx)
    if rule is None:
        return False
    plan.log.append(("intake.spool.rename.torn", "torn", dict(ctx)))
    return True


def take_spool_delay(rank=None) -> bool:
    """Consume a scheduled :meth:`~FaultPlan.spool_delay` for this
    spool scan; True when one fired (the scanner then hides the
    newest not-yet-tracked entry until a later scan)."""
    plan = _active
    if plan is None:
        return False
    ctx = {"rank": rank}
    rule = plan._take("intake.spool.scan", ctx)
    if rule is None:
        return False
    plan.log.append(("intake.spool.scan", "delay", dict(ctx)))
    return True


def _take_query(site: str, kind: str, ctx: dict) -> bool:
    """Shared body of the queried (not raised) fault consumers."""
    plan = _active
    if plan is None:
        return False
    rule = plan._take(site, ctx)
    if rule is None:
        return False
    plan.log.append((site, kind, dict(ctx)))
    return True


def take_warm_torn(key=None) -> bool:
    """Consume a scheduled :meth:`~FaultPlan.warm_torn_manifest` for
    this manifest write; True when one fired (the writer then lands a
    truncated sealed frame at the final record name)."""
    return _take_query("warm.manifest.write.torn", "torn",
                       {"key": key})


def take_warm_corrupt(key=None) -> bool:
    """Consume a scheduled :meth:`~FaultPlan.warm_corrupt_entry`;
    True when one fired (the writer then lands a payload-corrupted
    sealed frame — the loader's CRC conviction is exercised)."""
    return _take_query("warm.manifest.write.corrupt", "corrupt",
                       {"key": key})


def take_warm_stale(key=None) -> bool:
    """Consume a scheduled :meth:`~FaultPlan.warm_stale_epoch`; True
    when one fired (the writer then stamps a drifted cache epoch —
    the loader's version-rejection is exercised)."""
    return _take_query("warm.manifest.write.stale", "stale",
                       {"key": key})


def take_host_death(rank: int, tick: int) -> bool:
    """Consume a scheduled :meth:`~FaultPlan.host_death` for this
    rank's tick boundary; True when one fired. Queried — not raised —
    by the fleet scheduler so the caller decides how to die (raise
    :class:`InjectedRankDeath` in-process; the mp harness maps it to a
    hard OS exit)."""
    plan = _active
    if plan is None:
        return False
    rule = plan._take("fleet.host", {"rank": rank, "tick": tick})
    if rule is None:
        return False
    plan.log.append(("fleet.host", "host_death",
                     {"rank": rank, "tick": tick}))
    return True


def take_delta_parent_corrupt() -> bool:
    """Consume a scheduled :meth:`~FaultPlan.delta_parent_corrupt`;
    True when one fired. Queried — not raised — by the delta save so
    the corrupted link LANDS in the sidecar and the chain-verification
    machinery is what gets exercised."""
    plan = _active
    if plan is None:
        return False
    rule = plan._take("checkpoint.delta", {})
    if rule is None:
        return False
    plan.log.append(("checkpoint.delta", "parent_corrupt", {}))
    return True


def take_preempt(step: int) -> bool:
    """Consume a scheduled :meth:`~FaultPlan.preempt_signal` for the
    boundary after ``step``; True when one fired. Queried — not raised
    — by the supervision layer's step-boundary poll: the fake sets the
    SAME preempt flag a real signal handler would, so everything
    downstream (trip consensus, emergency checkpoint, resumable exit)
    is the production path."""
    plan = _active
    if plan is None:
        return False
    rule = plan._take("supervise.preempt", {"step": step})
    if rule is None:
        return False
    plan.log.append(("supervise.preempt", "preempt", {"step": step}))
    return True


def take_step_hang(step: int):
    """Consume a scheduled :meth:`~FaultPlan.step_hang` for ``step``;
    returns the hang duration in seconds (math.inf for a wedged-forever
    dispatch) or None. The hang replaces the dispatch inside the
    supervision watchdog's worker thread — same discipline as
    :func:`take_barrier_hang`."""
    plan = _active
    if plan is None:
        return None
    rule = plan._take("supervise.hang", {"step": step})
    if rule is None:
        return None
    plan.log.append(("supervise.hang", "hang", {"step": step}))
    hang = rule.params.get("hang_s")
    return math.inf if hang is None else float(hang)


def corrupt_file(path: str) -> list:
    """Apply scheduled file corruptions (truncate / bit flips) to a
    just-written file; returns what was applied. Called after the
    atomic save (file AND sidecar complete), simulating corruption at
    rest — exactly what the CRC verification exists to catch."""
    plan = _active
    applied = []
    if plan is None:
        return applied
    while True:
        rule = plan._take("checkpoint.file", {"path": path})
        if rule is None:
            return applied
        size = os.path.getsize(path)
        if rule.kind == "truncate":
            drop = rule.params.get("drop_bytes")
            if drop is None:
                drop = int(plan.rng.integers(1, max(2, size // 4)))
            detail = {"path": path, "drop_bytes": drop}
            truncate_file(path, drop)
        elif rule.kind == "bitflip":
            byte = rule.params.get("byte_index")
            if byte is None:
                byte = int(plan.rng.integers(0, size))
            bit = rule.params.get("bit")
            if bit is None:
                bit = int(plan.rng.integers(0, 8))
            detail = {"path": path, "byte_index": byte, "bit": bit}
            flip_bit(path, byte, bit)
        else:
            raise AssertionError(f"rule kind {rule.kind!r} is not a "
                                 "file corruption")
        plan.log.append(("checkpoint.file", rule.kind, detail))
        applied.append((rule.kind, detail))


def poison_step(grid, step: int) -> list:
    """Apply scheduled NaN poisonings for ``step`` to ``grid``'s
    fields; returns the poisoned (field, cells) pairs. Each matching
    rule fires at most ONCE per call (= per visit of the step), so a
    rule with ``times=k`` re-poisons the first k replays."""
    plan = _active
    applied = []
    if plan is None:
        return applied
    ctx = {"step": step}
    for rule in [r for r in plan.rules if r.matches("step.poison", ctx)]:
        rule.fired += 1
        name = rule.params["field"]
        cells = rule.params["cells"]
        if cells is None:
            local = np.asarray(grid.get_cells())
            pick = int(plan.rng.integers(0, len(local)))
            cells = np.asarray([local[pick]], dtype=np.uint64)
        cells = np.atleast_1d(np.asarray(cells, dtype=np.uint64))
        shape, dtype = grid.fields[name]
        vals = torch.full((len(cells),) + shape, rule.params["value"],
                          dtype=dtype)
        grid.set(name, cells, vals)
        plan.log.append(("step.poison", "nan",
                         {"step": step, "field": name,
                          "cells": cells.tolist()}))
        applied.append((name, cells))
    return applied


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


def _flip_field(grid, name, cells, bit) -> torch.Tensor:
    """:func:`flip_values` of ``cells``' values of field ``name``, on
    the field's own bits: a bfloat16 field is read widened to float32
    (exact), narrowed back and flipped through its 16-bit words, with
    the finite fallback computed in float32 and rounded to bfloat16 as
    the reference's ml_dtypes arithmetic rounds it."""
    vals = np.asarray(grid.get(name, cells))
    if grid.fields[name][1] != torch.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(
            flip_values(vals, bit)))
    t = torch.from_numpy(np.ascontiguousarray(vals)).to(torch.bfloat16)
    # the mask as the reference's 16-bit shift makes it (0 past bit 15)
    mask = (np.array(1, dtype=np.uint16) << int(bit)).view(np.int16)
    flipped = (t.view(torch.int16) ^ torch.tensor(mask)).view(
        torch.bfloat16)
    safe = torch.where(t.float().abs() >= 2.0, t.float() * 0.5,
                       t.float() * 0.5 + 1.0).to(torch.bfloat16)
    return torch.where(torch.isfinite(flipped), flipped, safe)


def flip_step(grid, step: int) -> list:
    """Apply scheduled silent bit-flips for ``step`` to ``grid``'s
    fields (the per-grid site, mirroring :func:`poison_step`); returns
    the flipped ``(field, cells)`` pairs. Job-scoped rules (fleet
    slots) never fire here."""
    plan = _active
    applied = []
    if plan is None:
        return applied
    ctx = {"step": step}
    for rule in [r for r in plan.rules
                 if r.site == "step.flip" and r.matches("step.flip", ctx)
                 and r.params.get("job") is None]:
        rule.fired += 1
        name = rule.params["field"]
        cells = rule.params["cells"]
        if cells is None:
            local = np.asarray(grid.get_cells())
            pick = int(plan.rng.integers(0, len(local)))
            cells = np.asarray([local[pick]], dtype=np.uint64)
        cells = np.atleast_1d(np.asarray(cells, dtype=np.uint64))
        grid.set(name, cells, _flip_field(grid, name, cells,
                                          rule.params["bit"]))
        plan.log.append(("step.flip", "flip",
                         {"step": step, "field": name,
                          "cells": cells.tolist(),
                          "bit": int(rule.params["bit"])}))
        applied.append((name, cells))
    return applied


def flip_fleet(job: str, after_step: int, through_step: int) -> list:
    """Consume scheduled silent bit-flips targeting fleet job ``job``
    whose step falls in ``(after_step, through_step]`` — same window
    discipline as :func:`poison_fleet`. Returns ``[(field, cells,
    bit, step)]``; the fleet layer lands the flip in the job's batch
    slot itself (:meth:`dccrg_tpu_torch.fleet.GridBatch.flip`)."""
    plan = _active
    out = []
    if plan is None:
        return out
    for rule in plan.rules:
        if rule.site != "step.flip" or rule.fired >= rule.times:
            continue
        want_job = rule.params.get("job")
        if want_job is not None and want_job != job:
            continue
        step = rule.params.get("step")
        if step is None or not after_step < step <= through_step:
            continue
        rule.fired += 1
        plan.log.append(("step.flip", "flip",
                         {"step": step, "job": job,
                          "field": rule.params["field"],
                          "bit": int(rule.params["bit"])}))
        out.append((rule.params["field"], rule.params["cells"],
                    int(rule.params["bit"]), int(step)))
    return out


def poison_fleet(job: str, after_step: int, through_step: int) -> list:
    """Consume scheduled NaN poisonings targeting fleet job ``job``
    whose step falls in ``(after_step, through_step]`` — the window
    one batched quantum advanced that job through. Returns
    ``[(field, cells, value, step)]``; the FLEET layer writes the
    poison into the job's batch slot itself (a slot is not a grid, so
    :func:`poison_step` cannot). Rules with ``job=None`` keep wildcard
    semantics and match whichever job is polled first; job-scoped
    rules fire only for their job."""
    plan = _active
    out = []
    if plan is None:
        return out
    for rule in plan.rules:
        if rule.site != "step.poison" or rule.fired >= rule.times:
            continue
        want_job = rule.params.get("job")
        if want_job is not None and want_job != job:
            continue
        step = rule.params.get("step")
        if step is None or not after_step < step <= through_step:
            continue
        rule.fired += 1
        plan.log.append(("step.poison", "nan",
                         {"step": step, "job": job,
                          "field": rule.params["field"]}))
        out.append((rule.params["field"], rule.params["cells"],
                    rule.params["value"], int(step)))
    return out


# -- standalone corruption helpers (also used directly by tests) ------

def flip_bit(path: str, byte_index: int, bit: int = 0) -> None:
    """Flip one bit of ``path`` in place."""
    with open(path, "r+b") as f:
        f.seek(byte_index)
        (b,) = f.read(1)
        f.seek(byte_index)
        f.write(bytes([b ^ (1 << bit)]))


def truncate_file(path: str, drop_bytes: int) -> None:
    """Drop the last ``drop_bytes`` bytes of ``path``."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(0, size - int(drop_bytes)))


EVERY = math.inf  # times=EVERY: the rule never exhausts
