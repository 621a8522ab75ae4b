"""Fleet job scheduler: a priority queue over batched grid buckets.

Port of ``dccrg_tpu/scheduler.py``. :class:`FleetScheduler` turns
:mod:`dccrg_tpu_torch.fleet`'s batched execution layer into a
multi-tenant serving loop, reusing the per-run lifecycle machinery of
:mod:`dccrg_tpu_torch.supervise` per job:

- **admission**: jobs pop in priority order and land in the
  :class:`~dccrg_tpu_torch.fleet.GridBatch` bucket their
  ``(shape, schema, kernel)`` key selects, created on demand with a
  :func:`~dccrg_tpu_torch.grid.bucket_capacity`-rounded slot count
  (capped by ``DCCRG_FLEET_MAX_BATCH``) so the program survives drain
  and backfill; a job that does not fit waits in the queue and
  **backfills** the next slot a finishing, failing or requeued job
  frees. On the card a bucket whose job names ``diffuse`` or
  ``advect_x`` steps through kernel A' (``bulk=True``, the default;
  ``bulk=False`` keeps every bucket on the table program);
- **checkpoints**: every job owns a
  :class:`~dccrg_tpu_torch.supervise.CheckpointStore` stem (its name)
  in one shared directory; periodic per-job saves (dirty-field deltas
  chained to keyframes) happen at quantum boundaries when a job crosses
  its ``checkpoint_every`` cadence, followed by per-stem retention GC
  (:func:`~dccrg_tpu_torch.supervise.gc_checkpoints`);
- **isolation trips**: the per-slot numerics watchdog
  (:meth:`~dccrg_tpu_torch.fleet.GridBatch.finite_slots`) rolls a
  tripped job back from its own newest verifying checkpoint in place
  (bounded retries, then ``failed``); a job-scoped injected OOM
  (:meth:`~dccrg_tpu_torch.faults.FaultPlan.resource_exhausted` with
  ``job=``) **requeues** only that job, while every neighbour slot's
  bytes stay frozen exactly. A real (unattributed) out-of-memory error
  from the batched quantum requeues the lower-priority half of the
  bucket's jobs and rebuilds it at half capacity;
- **SDC defence** (:mod:`dccrg_tpu_torch.integrity`): every batched
  quantum returns per-slot entry/exit fingerprints and conservation
  sums (``DCCRG_INTEGRITY``, on by default); the scheduler compares
  them exactly (integer fingerprints) or against the expected drift
  (conservation sums) every quantum, runs a sampled
  **shadow-execution audit** every ``DCCRG_AUDIT_EVERY`` ticks
  (re-execute one slot's last quantum from its pre-quantum state in a
  spare slot or on the solo path, compare digests), and compares
  **DMR** replicas (``FleetJob(redundancy=2)``) at every quantum
  boundary. A CORRUPT verdict rolls back only the victim and marks the
  batch's device lane suspect; a lane past
  ``DCCRG_QUARANTINE_AFTER`` verdicts is **quarantined**: its buckets
  rebuild on surviving lanes with every admitted job migrated bit for
  bit. A lane is one entry of ``devices``: lanes may name distinct
  devices (each bucket lives on its lane's device, and a migration
  copies each job's rows into the surviving lane's storage) or the same
  card;
- **preemption**: the loop polls the supervision layer's preempt flag
  (SIGTERM/SIGINT handlers, :func:`~dccrg_tpu_torch.supervise
  .request_preempt`, or :meth:`~dccrg_tpu_torch.faults.FaultPlan
  .preempt_signal`) at quantum boundaries; on preemption every admitted
  job takes an emergency keyframe into its own stem and is requeued,
  then :class:`FleetPreemptedError` surfaces with the resumable exit
  code 75, and a scheduler over the same directory (``resume=True``)
  resumes every job bit for bit with an uninterrupted fleet;
- **elastic multi-host fleet** (``rank_aware=True`` /
  ``DCCRG_RANK_AWARE=1``): schedulers of several ranks serve one job
  set over a shared checkpoint directory. Each rank heartbeats a
  :class:`~dccrg_tpu_torch.coord.Membership` lease, every admitted job
  records an owner rank and **lease epoch** in the shared KV
  (:class:`JobLeases`), and leases renew at tick boundaries. A rank
  that sees a peer's lease expire (no renewal for ``DCCRG_LEASE_S`` of
  its own clock) while membership calls the peer dead **reclaims** the
  job: a compare-and-set on the next epoch's claim key lets exactly one
  survivor win, and the winner re-admits the job from its checkpoint
  stem. The epoch is checked before every save publish, so a paused
  and resumed zombie owner gets a typed :class:`OwnershipLostError` and
  drops the job locally. The pending queue partitions across live
  ranks (a deterministic hash and load balance by projected
  completion). Off by default: without the flag no membership or lease
  object exists.

The streaming intake (:mod:`dccrg_tpu_torch.intake`) and the warm
pool (:mod:`dccrg_tpu_torch.warmstart`) are off by default: they exist
when injected (``intake``, ``warm_pool``) or under ``DCCRG_INTAKE=1``
(spool from ``DCCRG_INTAKE_SPOOL``) and ``DCCRG_COMPILE_CACHE=<dir>``.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import os
import time
import zlib
from contextlib import nullcontext

import numpy as np
import torch

from . import autopilot as autopilot_mod
from . import checkpoint as checkpoint_mod
from . import (coord, faults, integrity, resilience, supervise,
               telemetry, warmstart)
from .convert import _to_tensor
from .fleet import (SHADOW, FleetJob, GridBatch, max_batch_default,
                    quantum_default)
from .grid import bucket_capacity

logger = logging.getLogger("dccrg_tpu_torch.scheduler")


def rank_aware_default(default: bool = False) -> bool:
    """The ``DCCRG_RANK_AWARE`` env knob: ``1`` makes the fleet
    scheduler rank-aware (membership heartbeats, lease-based job
    ownership, orphan reclaim). Off (default): no membership or lease
    object exists and scheduling is bitwise identical to the
    rank-unaware scheduler."""
    v = os.environ.get("DCCRG_RANK_AWARE", "")
    if v == "":
        return default
    return v not in ("0", "off", "false", "no")


class OwnershipLostError(RuntimeError):
    """This rank's lease on a fleet job was FENCED by a higher epoch:
    a survivor reclaimed the job (this rank's renewals stopped for
    ``DCCRG_LEASE_S`` — paused, partitioned, or presumed dead) and
    owns its checkpoint stem now. The job must be dropped locally
    WITHOUT rollback side effects — publishing anything over the
    reclaimer's chain is exactly what the epoch fence exists to
    prevent."""

    def __init__(self, job, rank, held_epoch, current):
        super().__init__(
            f"lease on fleet job {job!r} lost: rank {rank} holds epoch "
            f"{held_epoch}, but the shared KV records {current!r} — a "
            "survivor reclaimed the job; dropping it locally (the "
            "reclaimer's checkpoint chain is the live one)")
        self.job = str(job)
        self.rank = int(rank)
        self.held_epoch = held_epoch
        self.current = current


class JobLeases:
    """Lease-based job ownership with epoch fencing over the
    coordination KV store (:func:`dccrg_tpu_torch.coord.default_kv`).

    KV layout per job name::

        <prefix>/<name>          -> "<rank>:<epoch>:<beat>"
        <prefix>/<name>@<epoch>  -> "<rank>"   (the reclaim claim)
        <prefix>/done/<name>     -> "<status>:<rank>:<steps>:<digest>"

    The lease value's ``beat`` bumps on every renewal; expiry is
    judged by OBSERVER aging (the :class:`~dccrg_tpu_torch.coord.Membership`
    discipline — the observer's own clock ages a value it saw stop
    changing, no cross-host clock comparison). Takeover is a
    compare-and-set: :meth:`try_reclaim` CAS-creates the claim key
    for the NEXT epoch, and the KV's first-writer-wins guarantees
    exactly one survivor wins a given epoch. :meth:`check` is the
    fencing gate consulted before every save publish and renewal —
    a claim key above the held epoch (or a higher-epoch lease record)
    raises the typed :class:`OwnershipLostError`, so a zombie whose
    renew overwrote the lease VALUE still cannot publish: the claim
    key it can never un-create convicts it."""

    def __init__(self, kv, rank: int, *, lease_s=None,
                 clock=time.monotonic, prefix: str = "dccrg/job"):
        self.kv = kv
        self.rank = int(rank)
        self.lease_s = (coord.lease_seconds() if lease_s is None
                        else float(lease_s))
        self.clock = clock
        self.prefix = str(prefix)
        self.owned: dict = {}   # name -> held epoch
        self._beat = 0
        self._watch: dict = {}  # name -> [raw value, first-seen clock]

    def _key(self, name) -> str:
        return f"{self.prefix}/{name}"

    def census(self):
        """One-call snapshot of every lease/claim/done key under the
        prefix, or None when the KV cannot list (callers then fall
        back to per-key reads). On the real coordination service an
        ABSENT key costs a full blocking-get timeout, so the tick
        path reads the census once instead of per-key; publish-time
        fencing (:meth:`check` from ``_save_job``/``_finish``) stays
        on fresh per-key reads."""
        return coord.prefix_census(self.kv, self.prefix)

    def _read(self, key, census=None):
        return census.get(key) if census is not None \
            else self.kv.get(key)

    @staticmethod
    def _parse(raw):
        try:
            r, e, b = str(raw).split(":")
            return int(r), int(e), int(b)
        except (ValueError, TypeError, AttributeError):
            return None

    def _write(self, name, epoch) -> None:
        self._beat += 1
        self.kv.set(self._key(name),
                    f"{self.rank}:{int(epoch)}:{self._beat}")

    def acquire(self, name) -> int:
        """Own ``name`` at admission; returns the held epoch. A fresh
        job CAS-creates epoch 1; this rank's own surviving record (a
        restarted scheduler, a requeue) is adopted after the fencing
        check. A lease held by ANOTHER rank raises
        :class:`OwnershipLostError` — expiry takeovers go through
        :meth:`try_reclaim`, never through admission."""
        name = str(name)
        held = self.owned.get(name)
        if held is not None:
            self.check(name)
            self._write(name, held)
            return held
        if self.kv.create(self._key(name), f"{self.rank}:1:0"):
            self.owned[name] = 1
            return 1
        raw = self.kv.get(self._key(name))
        cur = self._parse(raw)
        if cur is not None and cur[0] == self.rank:
            self.owned[name] = cur[1]
            self.check(name)
            self._write(name, cur[1])
            return cur[1]
        raise OwnershipLostError(name, self.rank, None, raw)

    def check(self, name, census=None) -> None:
        """The fencing gate (consulted before EVERY save publish):
        raise :class:`OwnershipLostError` — and forget the lease
        locally — when a reclaimer's claim key for the next epoch
        exists or the lease record carries a higher epoch / another
        rank at ours. ``census`` serves the reads on the tick path;
        publish-time callers pass None for fresh per-key reads."""
        name = str(name)
        held = self.owned.get(name)
        if held is None:
            raise OwnershipLostError(
                name, self.rank, None,
                self._read(self._key(name), census))
        claim = self._read(f"{self._key(name)}@{held + 1}", census)
        if claim is not None:
            self.owned.pop(name, None)
            raise OwnershipLostError(
                name, self.rank, held,
                f"epoch {held + 1} claimed by rank {claim}")
        cur = self._parse(self._read(self._key(name), census))
        if cur is not None and (cur[1] > held
                                or (cur[1] == held
                                    and cur[0] != self.rank)):
            self.owned.pop(name, None)
            raise OwnershipLostError(name, self.rank, held,
                                     f"{cur[0]}:{cur[1]}")

    def renew(self, name, census=None) -> None:
        """Renew one owned lease (tick boundaries); the fencing check
        runs first, so a fenced zombie learns before it writes."""
        self.check(name, census)
        self._write(name, self.owned[str(name)])

    def renew_owned(self, census=None) -> list:
        """Renew every owned lease; returns the ``[(name, error)]``
        fenced ones (reclaimed while this rank was paused)."""
        lost = []
        for name in sorted(self.owned):
            try:
                self.renew(name, census)
            except OwnershipLostError as e:
                lost.append((name, e))
        return lost

    def release(self, name) -> None:
        """Stop renewing (the job finished; the done marker, not the
        lease, is its terminal record)."""
        self.owned.pop(str(name), None)

    def holder(self, name, census=None):
        """The rank the KV currently records as owner, or None."""
        cur = self._parse(self._read(self._key(str(name)), census))
        return None if cur is None else cur[0]

    def expired_holder(self, name, census=None):
        """Observer-aged expiry: the OTHER rank whose lease on
        ``name`` has not changed for ``lease_s``, else None. A fresh
        observer grants the current value a full lease of grace."""
        name = str(name)
        raw = self._read(self._key(name), census)
        if raw is None:
            return None
        now = self.clock()
        rec = self._watch.get(name)
        if rec is None or rec[0] != raw:
            self._watch[name] = rec = [raw, now]
        cur = self._parse(raw)
        if cur is None or cur[0] == self.rank:
            return None
        return cur[0] if now - rec[1] >= self.lease_s else None

    def try_reclaim(self, name):
        """Fenced takeover of an expired lease: CAS-create the claim
        key for the NEXT epoch of the lease value this observer
        actually watched expire (exactly one survivor can — the KV's
        first-writer-wins IS the compare-and-set), then rewrite the
        lease record at that epoch. Returns the new held epoch, or
        None when another survivor won — a takeover that already
        happened shows as a moved value, which must age a fresh full
        lease before anyone may claim it again."""
        name = str(name)
        rec = self._watch.get(name)
        raw = (rec[0] if rec is not None
               else self.kv.get(self._key(name)))
        cur = self._parse(raw)
        if cur is None:
            # the owner died before its lease record ever landed
            if self.kv.create(self._key(name), f"{self.rank}:1:0"):
                self.owned[name] = 1
                return 1
            return None
        live = self.kv.get(self._key(name))
        if live != raw:
            # the record moved since expiry was judged (another
            # survivor's takeover, or a late renew): not ours to take
            if live is not None:
                self._watch[name] = [live, self.clock()]
            return None
        now = self.clock()
        nxt = cur[1] + 1
        for _ in range(64):  # bound far above any real claim chain
            if self.kv.create(f"{self._key(name)}@{nxt}",
                              str(self.rank)):
                break
            # the claim key exists but the lease record we just read
            # is UNMOVED: either its creator won microseconds ago and
            # is about to rewrite the record, or it died in the two-
            # write window (claim created, record never rewritten) —
            # which would otherwise leave the job unreclaimable
            # FOREVER (every survivor's CAS at this epoch loses).
            # Give the claimant one full lease from first sight of
            # its claim, then escalate past the orphaned epoch.
            ck = f"{self._key(name)}@{nxt}"
            rec = self._watch.get(ck)
            if rec is None:
                self._watch[ck] = [self.kv.get(ck), now]
                return None
            if now - rec[1] < self.lease_s:
                return None
            nxt += 1
        else:
            return None
        self.owned[name] = nxt
        self._watch.pop(name, None)
        self._write(name, nxt)
        return nxt


class SLOPolicy:
    """Latency-SLO admission + shedding, fed by telemetry.

    The scheduler reports every bucket's measured quantum dispatch
    latency into :meth:`observe`; the policy keeps a per-bucket-key
    EWMA and turns it into two decisions:

    - **admission order** (:meth:`admission_key`): a job with a
      ``slo_ms`` deadline whose PROJECTED completion — remaining
      quanta x the EWMA latency of its bucket key, measured from its
      first enqueue — would violate the deadline jumps the priority
      queue (most-violated first); everything else keeps the plain
      ``(priority, FIFO)`` order, so a fleet without SLOs (or without
      latency pressure) admits byte-identically to the priority-only
      baseline;
    - **shedding** (:meth:`shed_victims`): when a bucket's measured
      quantum latency blows the TIGHTEST admitted slot SLO (negative
      slack), the least-urgent cohabitants — best-effort jobs first,
      lowest priority first, then the loosest-slack SLO jobs, never
      the tightest — are requeued so the scheduler can rebuild the
      bucket smaller (half capacity: fewer slots per dispatch = lower
      quantum latency for the jobs that stay).

    Deterministic by construction: ``clock`` is injectable (the
    pinned tests drive a fake clock and hand-fed observations) and
    the EWMA state is plain floats."""

    def __init__(self, quantum=None, alpha=0.25, clock=time.monotonic,
                 shed_cooldown=4):
        self.quantum = (quantum_default() if quantum is None
                        else max(1, int(quantum)))
        self.alpha = float(alpha)
        self.clock = clock
        #: ticks a bucket is left alone after a shed rebuild (the
        #: fresh, smaller bucket must re-measure before re-shedding)
        self.shed_cooldown = int(shed_cooldown)
        self._ewma: dict = {}  # bucket key -> EWMA quantum seconds
        #: warm-start hook (``WarmPool.projection_cost``): extra
        #: up-front seconds to charge a bucket key whose first
        #: dispatch will pay a cold compile — 0.0 once pre-warmed.
        #: None (the default) leaves every projection untouched.
        self.warm_cost = None

    def observe(self, key, seconds: float) -> None:
        """Fold one measured quantum dispatch latency into the
        bucket key's EWMA."""
        e = self._ewma.get(key)
        self._ewma[key] = (float(seconds) if e is None
                           else (1.0 - self.alpha) * e
                           + self.alpha * float(seconds))

    def quantum_latency(self, key):
        """The EWMA quantum latency of ``key`` (None: unmeasured)."""
        return self._ewma.get(key)

    def reset_key(self, key) -> None:
        """Forget a bucket key's EWMA (after a shed rebuild: the
        smaller bucket must be measured fresh, not judged by its
        predecessor's latency)."""
        self._ewma.pop(key, None)

    def projected_completion_s(self, job) -> float:
        """Projected seconds to finish ``job``: remaining quanta x
        the EWMA latency of its bucket key (0 when unmeasured — no
        data never reorders the queue), plus — when a warm-start pool
        is attached — the bucket's measured cold-compile cost while
        it is not yet pre-warmed: the compile storm is charged up
        front instead of discovered mid-tick."""
        key = job.bucket_key()
        extra = 0.0 if self.warm_cost is None else float(
            self.warm_cost(key))
        lat = self._ewma.get(key)
        if lat is None:
            return extra
        remaining = max(0, job.n_steps - job.steps_done)
        quanta = -(-remaining // self.quantum)  # ceil
        return quanta * lat + extra

    def slack_s(self, job):
        """Seconds of SLO budget left after the projected completion
        (None for best-effort jobs; negative = projected violation)."""
        if job.slo_ms is None or job.slo_t0 is None:
            return None
        budget = job.slo_ms / 1e3 - (self.clock() - job.slo_t0)
        return budget - self.projected_completion_s(job)

    def admission_key(self, job, seq):
        """Sort key for one admission pass: SLO-violating jobs first
        (most negative slack first), then the priority-FIFO
        baseline."""
        slack = self.slack_s(job)
        if slack is not None and slack < 0.0:
            return (0, slack, -job.priority, seq)
        return (1, 0.0, -job.priority, seq)

    def shed_victims(self, key, jobs) -> list:
        """The ``[(slot, job)]`` to requeue out of a bucket whose
        measured quantum latency blows its tightest admitted SLO —
        empty when the bucket is unmeasured, single-job, SLO-free, or
        every SLO still has slack. At most half the jobs shed, and
        the tightest-slack SLO job never does (shedding it would
        serve nobody)."""
        if len(jobs) <= 1 or self._ewma.get(key) is None:
            return []
        slacks = {j.name: self.slack_s(j) for _s, j in jobs}
        slo = [(s, j) for s, j in jobs if slacks[j.name] is not None]
        if not slo or min(slacks[j.name] for _s, j in slo) >= 0.0:
            return []
        # least urgent first: best-effort (no SLO) by ascending
        # priority, then SLO jobs by DESCENDING slack; the tightest
        # stays, and at most half the bucket sheds
        order = sorted(
            jobs, key=lambda e: ((0, e[1].priority, -e[0])
                                 if slacks[e[1].name] is None
                                 else (1, -slacks[e[1].name], -e[0])))
        return order[:min(len(jobs) // 2, len(jobs) - 1)]

    def lane_shed_victims(self, groups):
        """Cross-bucket (mixed-kernel) shedding for one device lane.

        ``groups`` is ``[(index, key, jobs)]`` — one entry per bucket
        sharing the lane (distinct kernels land in distinct buckets,
        so a lane serving a mixed fleet dispatches every group each
        tick and a deadline job pays the SUM of the cohabiting
        buckets' quantum latencies per quantum of its own). When a
        deadline job's slack measured against that lane latency is
        negative while its own bucket alone would still meet the
        deadline — the cohabitants, not the bucket, are the problem —
        the best-effort jobs of the OTHER groups are the victims
        (lowest priority first). Returns ``(trigger_job, victims)``
        with victims ``[(index, slot, job)]``, or None when there is
        no cross-bucket pressure (fewer than two groups, unmeasured
        latencies, no SLO job, or no best-effort cohabitant): a
        single-kernel or SLO-free fleet never sheds across buckets —
        the negative pin."""
        if len(groups) < 2:
            return None
        lats = {i: self._ewma.get(key) for i, key, _jobs in groups}
        if any(lat is None for lat in lats.values()):
            return None
        lane_lat = sum(lats.values())
        best = None
        for i, key, jobs in groups:
            for _slot, j in jobs:
                if j.slo_ms is None or j.slo_t0 is None:
                    continue
                remaining = max(0, j.n_steps - j.steps_done)
                quanta = -(-remaining // self.quantum)  # ceil
                budget = j.slo_ms / 1e3 - (self.clock() - j.slo_t0)
                lane_slack = budget - quanta * lane_lat
                own_slack = budget - quanta * lats[i]
                if lane_slack < 0.0 <= own_slack and (
                        best is None or lane_slack < best[0]):
                    best = (lane_slack, i, j)
        if best is None:
            return None
        _slack, keep, trigger = best
        victims = []
        for i, _key, jobs in groups:
            if i == keep:
                continue
            victims += [(i, slot, j) for slot, j in jobs
                        if j.slo_ms is None]
        if not victims:
            return None
        victims.sort(key=lambda e: (e[2].priority, -e[1]))
        return trigger, victims


class FleetPreemptedError(RuntimeError):
    """The fleet stopped at a quantum boundary on a preemption signal;
    every admitted job saved an emergency keyframe into its own stem
    and was requeued. ``exit_code`` is the resumable 75
    (:data:`~dccrg_tpu_torch.supervise.RESUMABLE_EXIT`); rerun the
    scheduler over the same checkpoint directory to resume."""

    exit_code = supervise.RESUMABLE_EXIT

    def __init__(self, requeued):
        super().__init__(
            f"fleet preempted; {len(requeued)} job(s) emergency-"
            f"checkpointed and requeued (exit code {self.exit_code})")
        self.requeued = list(requeued)


class FleetScheduler:
    """Admit, multiplex, checkpoint and drain a fleet of
    :class:`~dccrg_tpu_torch.fleet.FleetJob` runs (see module docstring).

    ``checkpoint_dir`` holds every job's numbered checkpoint stem.
    Knobs (None = env default): ``max_batch``
    (``DCCRG_FLEET_MAX_BATCH``), ``quantum``
    (``DCCRG_FLEET_QUANTUM``), ``keep_last`` (``DCCRG_KEEP_LAST``) /
    ``keep_every`` (per-stem retention). ``resume`` (default) restores
    a job with existing checkpoints from its newest verifying one
    instead of reinitializing. ``devices`` spreads bucket instances
    round-robin over a device list (default: the card); each entry is
    one lane of the SDC layer, on a device of its own (the reference's
    ``self.devices[lane]``) or sharing one card with another lane; a
    quarantine rebuilds a lane's buckets on a surviving lane's device.
    ``bulk`` is forwarded to every ``GridBatch`` the scheduler builds:
    True (the default) lets a bucket whose job names a kernel with a
    slot-wise twin step through kernel A' (on a card lane; its plain
    twin on a host lane), False keeps the table program.
    ``slo_policy`` injects a custom :class:`SLOPolicy` (fake clock /
    tuned EWMA for the deterministic tests); the default one is fed
    by the telemetry-measured quantum latencies and drives both the
    SLO admission reorder and the over-latency bucket shedding.
    ``autopilot`` injects a :class:`~dccrg_tpu_torch.autopilot.Autopilot`
    controller (fake clock for the deterministic tests); with None
    one is constructed only under ``DCCRG_AUTOPILOT=1`` — otherwise
    ``self.autopilot`` stays None and every autopilot hook is a
    skipped ``if``, leaving scheduling, checkpoint cadence and audit
    cadence those of a scheduler without one. ``intake`` injects a
    :class:`~dccrg_tpu_torch.intake.StreamIntake` (with None one is
    constructed only under ``DCCRG_INTAKE=1``) and ``warm_pool`` a
    :class:`~dccrg_tpu_torch.warmstart.WarmPool` (with None one is
    constructed only under ``DCCRG_COMPILE_CACHE``); without them
    ``self.intake`` and ``self.warm`` stay None."""

    def __init__(self, checkpoint_dir, jobs=(), *, max_batch=None,
                 quantum=None, keep_last=None, keep_every=0,
                 resume=True, devices=None,
                 install_signal_handlers=False, audit_every=None,
                 quarantine_after=None, slo_policy=None,
                 autopilot=None, rank_aware=None, membership=None,
                 intake=None, warm_pool=None, bulk=True):
        self.dir = str(checkpoint_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.max_batch = (max_batch_default() if max_batch is None
                          else max(1, int(max_batch)))
        self.quantum = (quantum_default() if quantum is None
                        else max(1, int(quantum)))
        self.keep_last = (supervise.keep_last_default()
                          if keep_last is None else max(1, int(keep_last)))
        self.keep_every = int(keep_every)
        self.resume = bool(resume)
        self.devices = list(devices) if devices else [None]
        self.bulk = bool(bulk)
        self._install = bool(install_signal_handlers)
        # SDC defense knobs: shadow-audit cadence in scheduler ticks
        # (DCCRG_AUDIT_EVERY, 0 = off) and the per-device corrupt-
        # verdict count that quarantines a lane
        # (DCCRG_QUARANTINE_AFTER, 0 = never)
        self.audit_every = (integrity.audit_every_default()
                            if audit_every is None
                            else max(0, int(audit_every)))
        self.quarantine_after = (integrity.quarantine_after_default()
                                 if quarantine_after is None
                                 else max(0, int(quarantine_after)))
        # per-lane suspect accounting: corrupt verdicts attributed to
        # each entry of `devices` (fingerprint/conservation trips,
        # audit mismatches, DMR divergences)
        self.suspects = [0] * len(self.devices)
        self.quarantined: set = set()  # lane indices taken out
        self.audits = 0
        self.audit_failures = 0
        self._audit_rr = 0
        self._pending_quarantine: set = set()
        # latency-SLO admission: quantum-latency EWMAs measured by the
        # telemetry-instrumented dispatch feed the policy; a custom
        # policy (fake clock, tuned alpha) is injectable for tests
        self.slo = (SLOPolicy(quantum=self.quantum)
                    if slo_policy is None else slo_policy)
        # the self-tuning controller: OFF unless injected or opted in
        # via DCCRG_AUTOPILOT=1 — None means no hook below ever runs
        if autopilot is None and autopilot_mod.autopilot_enabled():
            autopilot = autopilot_mod.Autopilot(
                quantum=self.quantum, audit_every=self.audit_every)
        self.autopilot = autopilot
        #: cumulative job-steps advanced by dispatches (a controller
        #: input: the trip-rate denominator)
        self.steps_total = 0
        self._queue: list = []  # heap of (-priority, seq, job)
        # lane-shed parking lot: cross-bucket SLO victims wait here
        # (keyframed) until their trigger job finishes, instead of
        # being re-admitted by the very next tick's backfill
        self._parked: list = []  # [{job, trigger, max_tick}]
        self._lane_shed_tick: dict = {}  # lane -> last shed tick
        self._seq = itertools.count()
        self._by_name: dict = {}
        self.buckets: dict = {}  # bucket key -> [GridBatch]
        self._stores: dict = {}  # job name -> CheckpointStore
        self._next_dev = 0
        self.report: dict = {}
        self.ticks = 0
        # elastic multi-host fleet: OFF by default — membership and
        # leases stay None and the serving loop takes ZERO new
        # branches, so rank-unaware scheduling (and rank-aware with a
        # single live rank) is bitwise identical to the pre-elastic
        # scheduler
        if rank_aware is None:
            rank_aware = membership is not None or rank_aware_default()
        self.rank_aware = bool(rank_aware)
        self.membership = None
        self.leases = None
        self._remote: dict = {}  # name -> parked (prio, seq, job) entry
        self._degraded = False
        if self.rank_aware:
            if membership is None:
                # the process group's rank and size (0 and 1 without
                # a torch.distributed group)
                membership = coord.Membership(coord.process_index(),
                                              coord.process_count())
            self.membership = membership
            self.leases = JobLeases(
                membership.kv, membership.rank,
                lease_s=membership.lease_s, clock=membership.clock)
            if coord.process_count() > 1:
                # barriers anywhere in this process now name a dead
                # rank (PeerDeadError) instead of blaming a tag.
                # Registered only in a real process group: an
                # in-process fake fleet (tests, two schedulers over one
                # InMemoryKV) must not leak its toy membership into
                # the process-global barrier path
                coord.set_membership(membership)
            membership.heartbeat(force=True)
            if membership.clock is time.monotonic:
                # real clock: beats ride a daemon thread, so a
                # seconds-long kernel build mid-tick is never read as
                # a death (fake-clock tests beat by hand)
                membership.start_auto()
        # streaming intake front door: OFF by default — None means
        # the serving loop takes ZERO new branches (the negative pin
        # in tests/test_torch_intake.py); DCCRG_INTAKE=1 constructs one
        # over DCCRG_INTAKE_SPOOL, or inject an intake.StreamIntake
        self.intake = None
        if intake is None and os.environ.get(
                "DCCRG_INTAKE", "") not in ("", "0", "off", "false",
                                            "no"):
            from . import intake as intake_mod

            intake = intake_mod.StreamIntake.from_env(self)
        if intake is not None:
            self.intake = intake
            intake.attach(self)
        # warm-start pool: OFF by default — None means the serving
        # loop takes ZERO new branches (the negative pin in
        # tests/test_torch_warmstart.py); DCCRG_COMPILE_CACHE constructs
        # one over that dir, or inject a warmstart.WarmPool directly
        self.warm = None
        if warm_pool is None:
            warm_pool = warmstart.WarmPool.from_env()
        if warm_pool is not None:
            self.warm = warm_pool
            warm_pool.attach(self)
        for j in jobs:
            self.add(j)

    # -- queue --------------------------------------------------------

    def add(self, job: FleetJob) -> None:
        """Queue a job (higher ``priority`` admits first; FIFO within
        a priority). The name is the checkpoint stem — unique per
        scheduler."""
        known = self._by_name.get(job.name)
        if known is not None and known is not job:
            raise ValueError(
                f"duplicate job name {job.name!r}: the name is the "
                "checkpoint stem and must be unique per scheduler")
        self._by_name[job.name] = job
        job.status = "queued"
        if job.slo_ms is not None and job.slo_t0 is None:
            # the SLO clock starts at the FIRST enqueue (requeues and
            # re-adds keep the original deadline)
            job.slo_t0 = self.slo.clock()
        heapq.heappush(self._queue, (-job.priority, next(self._seq), job))

    def store_for(self, job: FleetJob) -> supervise.CheckpointStore:
        st = self._stores.get(job.name)
        if st is None:
            st = supervise.CheckpointStore(self.dir, stem=job.name)
            self._stores[job.name] = st
        return st

    # -- admission + backfill -----------------------------------------

    def live_lanes(self) -> list:
        """Device-lane indices not quarantined by the SDC layer."""
        return [i for i in range(len(self.devices))
                if i not in self.quarantined]

    def _bucket_for(self, job: FleetJob, pending=None) -> GridBatch:
        """A bucket instance with a free slot for ``job``'s key, or
        None. Creates a new instance (round-robin over the live,
        non-quarantined ``devices`` lanes) sized to the demand visible
        NOW — bucket_capacity-rounded so later fluctuations reuse the
        compile — when every existing one is full and the lane list
        allows another. ``pending`` is the not-yet-admitted job list
        the demand sizing counts (default: the queue — the admission
        pass drains the queue first and passes its remainder)."""
        key = job.bucket_key()
        insts = self.buckets.setdefault(key, [])
        for b in insts:
            if b.free_slot() is not None:
                return b
        lanes = self.live_lanes()
        if len(insts) >= len(lanes):
            return None
        if pending is None:
            pending = [j for _p, _s, j in self._queue]
        # DMR jobs occupy redundancy slots each (primary + shadows):
        # size the bucket for the SLOT demand, not the job count
        same_key = job.redundancy + sum(
            j.redundancy for j in pending
            if j.bucket_key() == key)
        cap = min(self.max_batch, bucket_capacity(same_key))
        if self.autopilot is not None:
            # seed from the recorded OOM/shed history instead of
            # rediscovering the safe capacity by halving every run —
            # floored at the largest single job's slot demand, so a
            # redundancy=2 job's DMR shadow can never be stripped by
            # history learned from a differently-shaped workload
            need = max([job.redundancy] + [
                j.redundancy for j in pending
                if j.bucket_key() == key])
            cap = self.autopilot.seed_capacity(key, cap,
                                               min_capacity=need)
        lane = lanes[self._next_dev % len(lanes)]
        b = GridBatch(job, cap, device=self.devices[lane], bulk=self.bulk)
        b.lane = lane
        self._next_dev += 1
        insts.append(b)
        return b

    def _admit_pending(self) -> int:
        """One admission pass: place every queued job that fits
        (SLO-urgency order, then priority; non-fitting jobs go back
        and backfill later). Returns how many were admitted.

        The pass drains the priority heap, re-orders it through
        :meth:`SLOPolicy.admission_key` — jobs whose projected
        completion (quantum-latency EWMA x remaining quanta) violates
        their ``slo_ms`` deadline admit FIRST, most-violated first —
        and admits in that order. With no SLO jobs (or no violation)
        the key degrades to the exact ``(-priority, seq)`` heap order,
        so the priority-only baseline is unchanged (pinned by the
        deterministic reorder case of the tests)."""
        with telemetry.span("fleet.admit"):
            items = []
            while self._queue:
                items.append(heapq.heappop(self._queue))
            items.sort(key=lambda it: self.slo.admission_key(
                it[2], it[1]))
            deferred, admitted = [], 0
            for i, item in enumerate(items):
                job = item[2]
                batch = self._bucket_for(
                    job, pending=[it[2] for it in items[i + 1:]])
                if batch is None:
                    deferred.append(item)
                    continue
                if self.leases is not None:
                    # ownership is recorded at ADMISSION: the lease
                    # CAS arbitrates any transient partition
                    # disagreement between ranks — the loser parks
                    # the job and watches the winner's lease instead
                    try:
                        self.leases.acquire(job.name)
                    except OwnershipLostError as e:
                        logger.info(
                            "fleet job %s: admission lost the lease "
                            "race (%s); parking as remote", job.name, e)
                        self._remote[job.name] = item
                        continue
                self._admit_into(batch, job)
                admitted += 1
            for item in deferred:
                heapq.heappush(self._queue, item)
            return admitted

    def _admit_into(self, batch: GridBatch, job: FleetJob) -> None:
        telemetry.inc("dccrg_fleet_admissions_total", job=job.name)
        store = self.store_for(job)
        restored = None
        if self.resume or job.steps_done > 0 or job.requeues:
            restored = self._load_newest(batch, store, job)
        elif store.list():
            # resume=False over a dir holding a PREVIOUS run's stem:
            # purge it now, or the first trip/requeue/preemption would
            # _load_newest the stale (higher-step) state — and the
            # per-save GC would keep those stale files over this
            # run's fresh step-0 keyframe
            self._purge_stem(store, job)
        if restored is None:
            job.apply_init(batch.grid)
            job.steps_done = 0
        else:
            job.steps_done = restored
            # the restored checkpoint IS the last save: the periodic
            # cadence continues from it
            job.last_save_step = restored
        slot = batch.admit(job, from_grid=True)
        job.status = "running"
        # the slot was just (re)written through a sanctioned path:
        # the integrity fingerprint baseline restarts here
        job._fp = None
        if job.redundancy >= 2 and batch.admit_shadow(slot) is None:
            logger.warning(
                "DMR job %s: no free slot for its shadow replica; "
                "running unreplicated", job.name)
        logger.debug("admitted %s at step %d into slot %d", job.name,
                     job.steps_done, slot)
        if restored is None:
            # the rollback target always exists (the ResilientRunner
            # invariant, per job): a step-0 keyframe before stepping
            try:
                self._save_job(batch, slot, job, force_keyframe=True)
            except OwnershipLostError as e:
                self._drop_lost(batch, slot, job, e)

    def _purge_stem(self, store, job) -> None:
        """Delete every checkpoint (and sidecar) of ``job``'s stem —
        the ``resume=False`` contract is a from-scratch run."""
        try:
            store.drain()  # never unlink under an in-flight publish
        except Exception as e:  # noqa: BLE001 - purging anyway
            logger.warning("draining stem %s before purge failed (%s)",
                           job.name, e)
        n = 0
        for _step, path in store.list():
            for p in (path, resilience.sidecar_path(path)):
                try:
                    os.remove(p)
                    n += 1
                except OSError:
                    pass
        logger.warning("resume=False: purged %d stale checkpoint "
                       "file(s) of stem %s", n, job.name)

    def _load_newest(self, batch, store, job):
        """Restore the newest verifying checkpoint of ``job``'s stem
        into the bucket's scratch grid (chain-aware; older entries are
        the fallback, mirroring ``resume_latest``). Returns the
        restored step or None."""
        # drain barrier: never read a stem an async write is still
        # publishing into. A failed write already re-pointed the chain
        # state; the newest-first walk below IS the fallback.
        try:
            store.drain()
        except Exception as e:  # noqa: BLE001 - the walk is the fallback
            logger.error("async save of stem %s failed (%s); rolling "
                         "back to its last durable checkpoint",
                         job.name, e)
        for step, path in store.list():
            try:
                resilience.load_checkpoint_into(batch.grid, path)
            except Exception as e:  # noqa: BLE001 - walk to older
                logger.warning("fleet resume of %s skipped %s (%s)",
                               job.name, path, e)
                continue
            return int(step)
        return None

    # -- elastic multi-host: membership, leases, reclaim --------------

    def _job_cost(self, job) -> float:
        """Projected completion cost for the rank partition: remaining
        quanta x the bucket key's SLO EWMA (1.0 per quantum when
        unmeasured, so unmeasured fleets balance by quantum count)."""
        lat = self.slo.quantum_latency(job.bucket_key())
        remaining = max(1, job.n_steps - job.steps_done)
        quanta = -(-remaining // max(1, self.quantum))  # ceil
        return quanta * (lat if lat is not None else 1.0)

    def _rank_tick(self) -> None:
        """The rank-aware tick-boundary pass: heartbeat + membership
        poll (deadline-bounded — never blocks the serving loop), owned
        lease renewal (a fenced lease drops its job locally, the
        zombie discipline), the remote scan (done markers, lease
        aging, orphan reclaim) and the pending-queue partition."""
        m = self.membership
        with telemetry.span("fleet.membership"):
            m.heartbeat()
            m.poll()
        live = m.live_ranks()
        if len(live) == 1 and m.n_ranks > 1 and not self._degraded:
            self._degraded = True
            logger.warning(
                "fleet membership: all %d peer rank(s) dead — "
                "degrading to single-host serving on rank %d",
                m.n_ranks - 1, m.rank)
        elif self._degraded and len(live) > 1:
            self._degraded = False
            logger.warning(
                "fleet membership: peer rank(s) rejoined — elastic "
                "regrow to %d live rank(s)", len(live))
        # one KV prefix listing serves every tick-path read (absent
        # keys cost a full blocking-get timeout on the real service;
        # publish-time fencing stays on fresh per-key reads)
        census = self.leases.census()
        for name, err in self.leases.renew_owned(census=census):
            self._drop_lost_by_name(name, err)
        holders = self._scan_remote(census)
        self._partition_queue(live, holders, census)

    def _drop_lost_by_name(self, name, err) -> None:
        for b, s, j in self.active_jobs():
            if j.name == name:
                self._drop_lost(b, s, j, err)
                return
        job = self._by_name.get(name)
        if job is not None:
            self._drop_lost(None, None, job, err)

    def _drop_lost(self, batch, slot, job, err) -> None:
        """The zombie discipline: a fenced job is dropped locally
        WITHOUT rollback side effects (no save, no load, no requeue —
        the reclaimer's checkpoint chain is the live one) and tracked
        as remote until its done marker appears."""
        logger.warning("fleet job %s dropped: %s", job.name, err)
        telemetry.inc("dccrg_fleet_ownership_lost_total", job=job.name)
        if batch is not None and slot is not None \
                and batch.slots[slot] is job:
            batch.clear(slot)
        job.status = "lost"
        self.leases.release(job.name)
        if job.name not in self._remote:
            self._remote[job.name] = (-job.priority, next(self._seq),
                                      job)

    def _note_remote_done(self, name, job, raw) -> None:
        parts = (str(raw).split(":", 3) + ["", "", "", ""])[:4]
        status, rank_s, steps_s, digest = parts
        job.status = status
        job.digest = (digest or None) if status == "done" else None
        self.report[name] = {
            "status": status, "steps": int(steps_s or 0),
            "digest": job.digest, "trips": 0, "sdc_trips": 0,
            "retries_final": 0, "requeues": job.requeues,
            "transient_retries": 0, "rollbacks": 0,
            "slo_ms": job.slo_ms, "slo_met": None,
            "owner_rank": int(rank_s or -1), "remote": True,
        }

    def _scan_remote(self, census=None) -> dict:
        """One pass over the jobs other ranks own: resolve done
        markers into report rows, age the live leases, and RECLAIM the
        expired ones — the CAS claim key means exactly one survivor
        wins, and the winner requeues the job locally so the next
        admission pass re-admits it from its checkpoint stem. Returns
        the ``{name: holder_rank}`` census of still-live remote
        leases (the partition's load input)."""
        ls = self.leases
        holders = {}
        for name, entry in list(self._remote.items()):
            job = entry[2]
            raw = ls._read(f"{ls.prefix}/done/{name}", census)
            if raw is not None:
                self._note_remote_done(name, job, raw)
                del self._remote[name]
                continue
            holder = ls.holder(name, census)
            if holder == ls.rank:
                # a job THIS rank holds the lease on must never idle
                # in the remote set (a reclaim raced the partition):
                # requeue it locally — nobody else may serve it
                del self._remote[name]
                job.status = "queued"
                heapq.heappush(self._queue, entry)
                continue
            if holder is None:
                continue  # unclaimed: the partition decides below
            dead = ls.expired_holder(name, census)
            if dead is None or self.membership.state(dead) \
                    != coord.Membership.DEAD:
                # reclaim needs BOTH signals: the job lease expired
                # AND the holder's failure domain is dead by
                # membership — a live rank stalled in a long restore
                # keeps its work (the epoch fence would make a
                # spurious reclaim safe, but not free)
                holders[name] = holder
                continue
            t0 = time.perf_counter()
            with telemetry.span("fleet.reclaim"):
                epoch = ls.try_reclaim(name)
            if epoch is None:
                continue  # another survivor won; visible next tick
            age = round(ls.lease_s, 6)
            logger.warning(
                "fleet job %s: lease of rank %d expired (>= %gs "
                "without renewal); RECLAIMED at epoch %d — re-"
                "admitting from its checkpoint stem", name, dead,
                ls.lease_s, epoch)
            telemetry.inc("dccrg_fleet_reclaims_total", job=name)
            telemetry.observe("dccrg_fleet_reclaim_seconds",
                              time.perf_counter() - t0)
            job.requeues += 1
            job.status = "queued"
            del self._remote[name]
            heapq.heappush(self._queue, entry)
            if self.autopilot is not None:
                self.autopilot.record_reclaim(dead, [name], age)
        return holders

    def _partition_queue(self, live, holders, census=None) -> None:
        """Deterministic rank assignment of every UNCLAIMED pending
        job (queued here, or parked remote with no live lease):
        greedy least-projected-load over the live ranks, biggest job
        first, stable crc32 tiebreaks — every rank derives the same
        map from the same observed inputs, and the admission-time
        lease CAS arbitrates any transient disagreement (the loser
        parks the job back as remote). Jobs another rank holds a LIVE
        lease on are never touched. A single live rank keeps the
        exact heap entries — bitwise the rank-unaware admission
        order."""
        pool = []
        while self._queue:
            pool.append(heapq.heappop(self._queue))
        for name in list(self._remote):
            if (name not in holders and self._remote[name][2].status
                    == "queued"
                    and self.leases.holder(name, census) is None):
                pool.append(self._remote.pop(name))
        if len(live) <= 1:
            for entry in pool:
                heapq.heappush(self._queue, entry)
            return
        loads = {r: 0.0 for r in live}
        me = self.membership.rank
        for name, holder in holders.items():
            if holder in loads:
                loads[holder] += self._job_cost(self._remote[name][2])
        for _b, _s, j in self.active_jobs():
            loads[me] += self._job_cost(j)
        pool.sort(key=lambda e: (-self._job_cost(e[2]),
                                 zlib.crc32(e[2].name.encode()),
                                 e[2].name))
        for entry in pool:
            job = entry[2]
            if job.name in self.leases.owned:
                # a lease THIS rank already holds (a reclaim, a
                # requeue) pins the job local — the partition only
                # places unclaimed work
                loads[me] += self._job_cost(job)
                heapq.heappush(self._queue, entry)
                continue
            tgt = min(live, key=lambda r: (
                loads[r], zlib.crc32(f"{job.name}:{r}".encode())))
            loads[tgt] += self._job_cost(job)
            if tgt == me:
                heapq.heappush(self._queue, entry)
            else:
                self._remote[job.name] = entry

    # -- per-job checkpointing + retention ----------------------------

    def _save_job(self, batch, slot, job, force_keyframe=False) -> None:
        if self.leases is not None:
            # the epoch fence: NEVER publish into a stem a reclaimer
            # owns — a stale owner surfaces the typed
            # OwnershipLostError here, before any bytes move
            self.leases.check(job.name)
        with telemetry.tags(job=job.name):
            g = batch.write_grid(slot)
            store = self.store_for(job)
            steps = job.steps_done

            def _gc():
                # rides the save as its post hook: inline after a sync
                # save, chained onto the writer thread after an async
                # one (DCCRG_ASYNC_SAVE) — so the CRC+fsync+rename of a
                # periodic save overlaps the next quantum's dispatch
                # and GC still never races a publish
                try:
                    supervise.gc_checkpoints(
                        self.dir, keep_last=self.keep_last,
                        keep_every=self.keep_every, stem=job.name,
                        apply=True, assume_ok=steps)
                except OSError as e:  # GC must never kill the fleet
                    logger.warning("per-stem GC failed for %s (%s)",
                                   job.name, e)

            prev_last = job.last_save_step
            store.save(g, steps, dirty_fields=set(job.fields_out),
                       force_keyframe=force_keyframe, post=_gc)
            job.last_save_step = steps
            if store.pending():
                # speculative while the async write is in flight: a
                # writer failure reverts the cadence baseline at the
                # drain barrier (the ResilientRunner._save discipline),
                # so the next save isn't delayed by a checkpoint that
                # never published
                store._saver.add_on_fail(
                    lambda _e, job=job, prev=prev_last:
                    setattr(job, "last_save_step", prev))

    # -- trips: per-slot isolation ------------------------------------

    def _trip(self, batch, slot, job, kind) -> None:
        """One job tripped (NaN in its slot, a CORRUPT integrity
        verdict, or a job-scoped OOM). Neighbors are untouched by
        construction; this job rolls back from its own checkpoint —
        in place for numerics/corrupt trips (the same recovery: the
        checkpoint chain predates the bad bytes either way), via
        requeue for OOMs (the slot is freed so the working set
        shrinks; re-admission restores from the same stem, possibly
        into a different slot or bucket)."""
        job.trips.append((kind, job.steps_done))
        telemetry.inc("dccrg_fleet_trips_total", job=job.name, kind=kind)
        if job.steps_done > job._last_trip_step:
            job.retries = 0  # progress since the last trip
        job._last_trip_step = job.steps_done
        job.retries += 1
        logger.warning(
            "fleet job %s tripped (%s) at step %d; retry %d/%d",
            job.name, kind, job.steps_done, job.retries, job.max_retries)
        if job.retries > job.max_retries:
            self._finish(batch, slot, job, status="failed")
            return
        if kind == "oom":
            # the fault fires BEFORE the dispatch, so the slot state
            # is intact — keyframe it (same premise as _batch_oom /
            # _preempt) so re-admission resumes from here instead of
            # replaying everything since the last periodic save
            try:
                self._save_job(batch, slot, job, force_keyframe=True)
            except OwnershipLostError as e:
                self._drop_lost(batch, slot, job, e)
                return
            batch.clear(slot)
            job.requeues += 1
            self.add(job)
            return
        t0 = time.perf_counter()
        restored = self._load_newest(batch, self.store_for(job), job)
        if restored is None:
            logger.error("fleet job %s has no loadable checkpoint to "
                         "roll back to", job.name)
            self._finish(batch, slot, job, status="failed")
            return
        batch.read_grid(slot)
        # sanctioned rewrite: fingerprint baseline resets, and any DMR
        # shadow re-syncs to the restored bytes (the replicas must
        # re-diverge only through real corruption)
        job._fp = None
        batch.sync_shadow(slot)
        job.rollbacks += 1
        telemetry.inc("dccrg_fleet_rollbacks_total", job=job.name)
        # rollback cost is a controller input (with the trip rate it
        # prices the expected replay a longer checkpoint cadence buys)
        telemetry.observe("dccrg_rollback_seconds",
                          time.perf_counter() - t0)
        job.steps_done = restored
        # re-baseline the cadence like _admit_into: a fallback to an
        # OLDER checkpoint would otherwise leave steps_done -
        # last_save_step negative, suppressing saves over the whole
        # replayed region
        job.last_save_step = restored

    def _finish(self, batch, slot, job, status="done") -> None:
        if self.leases is not None:
            try:
                # the done marker is a publish too: a fenced zombie
                # completing a quantum must not write the terminal
                # record over the job a reclaimer is still serving
                self.leases.check(job.name)
            except OwnershipLostError as e:
                self._drop_lost(batch, slot, job, e)
                return
        if status == "done":
            job.digest = batch.digest(slot)
        job.status = status
        batch.clear(slot)
        telemetry.inc("dccrg_fleet_finished_total", status=status)
        slo_met = None
        if job.slo_ms is not None and job.slo_t0 is not None:
            took_ms = (self.slo.clock() - job.slo_t0) * 1e3
            # a failed job never met its SLO, however fast it failed
            slo_met = bool(status == "done" and took_ms <= job.slo_ms)
            telemetry.inc("dccrg_fleet_slo_total",
                          met=("yes" if slo_met else "no"))
        self.report[job.name] = {
            "status": status, "steps": job.steps_done,
            "digest": job.digest, "trips": len(job.trips),
            "sdc_trips": sum(1 for k, _s in job.trips
                             if k == "corrupt"),
            "retries_final": job.retries, "requeues": job.requeues,
            "transient_retries": job.transient_retries,
            "rollbacks": job.rollbacks,
            "slo_ms": job.slo_ms, "slo_met": slo_met,
        }
        if self.leases is not None:
            # the terminal record peers wait on: the done marker
            # replaces the lease (renewals stop; a done job is never
            # reclaimed)
            self.report[job.name]["owner_rank"] = self.membership.rank
            self.leases.kv.set(
                f"{self.leases.prefix}/done/{job.name}",
                f"{status}:{self.membership.rank}:{job.steps_done}:"
                f"{job.digest or '-'}")
            self.leases.release(job.name)

    # -- one bucket quantum -------------------------------------------

    def _fire_dispatch_faults(self, batch) -> None:
        """Per-job injection points before the batched dispatch:
        transient dispatch errors retry in place (no rollback, the
        supervision-layer discipline); a job-scoped simulated OOM
        requeues exactly that job."""
        if faults.active() is None:
            return
        for slot, job in batch.jobs:
            for attempt in range(3):
                try:
                    faults.fire("supervise.dispatch", step=job.steps_done,
                                job=job.name, attempt=attempt)
                    break
                except faults.InjectedDispatchError as e:
                    job.transient_retries += 1
                    logger.warning(
                        "transient dispatch error for fleet job %s "
                        "(%s); retrying", job.name, e)
                    time.sleep(0.01 * (2 ** attempt))
            else:
                # retries exhausted: the single-run discipline raises
                # (SupervisedRunner._dispatch); the fleet analogue is
                # failing ONLY this job — neighbors keep serving
                logger.error(
                    "fleet job %s: transient dispatch error persisted "
                    "through 3 attempts; failing the job", job.name)
                self._finish(batch, slot, job, status="failed")
                continue
            try:
                faults.fire("step.dispatch", mode="fleet",
                            step=job.steps_done, job=job.name)
            except Exception as e:  # noqa: BLE001 - filtered below
                if not resilience._is_resource_exhausted(e):
                    raise
                logger.warning("fleet job %s dispatch OOM (%s)",
                               job.name, e)
                self._trip(batch, slot, job, "oom")

    def _quantum(self, batch) -> None:
        with telemetry.span("fleet.quantum"):
            self._quantum_inner(batch)

    def _quantum_inner(self, batch) -> None:
        self._fire_dispatch_faults(batch)
        active = batch.jobs
        if not active:
            return
        budget = np.zeros(batch.capacity, dtype=np.int32)
        prev = {}
        for slot, job in active:
            budget[slot] = min(self.quantum,
                               max(0, job.n_steps - job.steps_done))
            prev[slot] = job.steps_done
        # DMR shadow replicas step in lockstep with their primary
        for sh, primary in batch.shadow_of.items():
            budget[sh] = budget[primary]
        # shadow-execution audit: snapshot ONE slot's pre-quantum
        # state at the sampled cadence; after the dispatch the same
        # quantum is re-executed from it and compared bitwise
        audit_slot, audit_pre = self._pick_audit(batch, active, budget)
        t_dispatch = time.perf_counter()
        try:
            batch.step(budget)
        except Exception as e:  # noqa: BLE001 - filtered below
            if not resilience._is_resource_exhausted(e):
                raise
            self._batch_oom(batch, e)
            return
        inv = batch.last_inv  # fused invariants (None: integrity off)
        for slot, job in active:
            job.steps_done += int(budget[slot])
            self.steps_total += int(budget[slot])
        # fleet-scoped fault landing pads (chaos tests): NaN poisons
        # and FINITE silent flips for the steps this quantum advanced
        # each job through
        if faults.active() is not None:
            for slot, job in active:
                for fld, cells, value, _ps in faults.poison_fleet(
                        job.name, prev[slot], job.steps_done):
                    batch.poison(slot, fld,
                                 self._fault_cells(batch, cells), value)
                for fld, cells, bit, _ps in faults.flip_fleet(
                        job.name, prev[slot], job.steps_done):
                    batch.flip(slot, fld,
                               self._fault_cells(batch, cells), bit)
        # per-slot watchdog: a tripped slot rolls back alone
        ok = batch.finite_slots()
        # the finite pull is the quantum's sync point, so the elapsed
        # time IS the measured dispatch latency — recorded per job in
        # the registry (the fleet CLI's p50/p99 source) and folded
        # into the SLO policy's per-bucket EWMA. The EWMA skips a
        # batch instance's FIRST dispatch: it may carry a kernel build
        # (seconds against millisecond quanta), and judging a
        # healthy bucket by its warmup would shed it spuriously —
        # each shed rebuild compiles again, re-poisoning the freshly
        # reset EWMA in a feedback loop of pointless halvings.
        lat = time.perf_counter() - t_dispatch
        if batch.dispatches > 1:
            self.slo.observe(batch.key, lat)
        elif self.warm is not None:
            # the batch instance's FIRST dispatch: the warm pool
            # classifies it warm (pre-compiled program served) or
            # cold (this latency carried the compile), journals the
            # decision and upserts the persistent manifest
            self.warm.note_dispatch(batch, lat)
        telemetry.observe("dccrg_fleet_quantum_seconds", lat)
        for slot, job in active:
            if budget[slot] > 0:
                telemetry.observe("dccrg_fleet_quantum_seconds", lat,
                                  job=job.name)
        tripped = set()
        for slot, job in active:
            if batch.slots[slot] is job and not ok[slot]:
                tripped.add(slot)
                self._trip(batch, slot, job, "nan")
        # in-program integrity invariants: entry/exit fingerprints +
        # conservation drift, then the current-state fingerprint pass
        # (exact integer sums — bit-comparable across programs)
        if inv is not None:
            self._check_integrity(batch, active, budget, inv, tripped)
        # sampled shadow-execution audit + always-on DMR comparison
        if audit_slot is not None and audit_slot not in tripped:
            self._run_audit(batch, audit_slot, audit_pre,
                            int(budget[audit_slot]), tripped)
        if batch.shadow_of:
            self._check_dmr(batch, tripped)
        # periodic per-job checkpoints + completion (never checkpoint
        # a slot that tripped this quantum: its state just rolled
        # back — the cadence restarts from the restored step)
        for slot, job in batch.jobs:
            if slot in tripped:
                continue
            if job.steps_done >= job.n_steps:
                self._finish(batch, slot, job)
            elif (job.checkpoint_every > 0 and job.last_save_step
                  is not None and job.steps_done - job.last_save_step
                  >= job.checkpoint_every):
                try:
                    self._save_job(batch, slot, job)
                except OwnershipLostError as e:
                    self._drop_lost(batch, slot, job, e)

    def _fault_cells(self, batch, cells):
        """Resolve a fault rule's ``cells=None`` to one seeded local
        cell (shared by the poison and flip landing pads)."""
        if cells is not None:
            return cells
        local = batch.grid.plan.cells
        pick = int(faults.active().rng.integers(0, len(local)))
        return [int(local[pick])]

    # -- SDC detection: invariants, audits, DMR, quarantine -----------

    def _check_integrity(self, batch, active, budget, inv,
                         tripped) -> None:
        """Compare the dispatch's fused invariants per slot:

        - ``fp_in`` vs the exit fingerprint of the PREVIOUS dispatch —
          EXACT: any corruption of the slot's resident bytes between
          the two dispatches (memory rot, a stray write, an injected
          flip), convicted at the next quantum boundary;
        - conservation-sum drift across the quantum for fields the
          kernel provably conserves — tolerance-bounded: in-compute
          corruption;
        - for slots about to CHECKPOINT or FINISH this tick only, one
          extra current-state fingerprint pass vs ``fp_out`` — EXACT:
          corruption since the dispatch is convicted before the bytes
          can be sealed into a checkpoint or reported as an answer.
          (Steady-state quanta skip this pass: the next quantum's
          ``fp_in`` covers them, and the save/finish guards are what
          make the one-quantum detection window airtight.)

        Any mismatch is a CORRUPT verdict: the victim rolls back
        alone (the NaN discipline) and the batch's device lane takes
        a suspect mark."""
        telemetry.inc("dccrg_integrity_checks_total", where="fleet")
        need_now = set()
        for slot, job in active:
            if slot in tripped or batch.slots[slot] is not job:
                continue
            if (job.steps_done >= job.n_steps
                    or (job.checkpoint_every > 0
                        and job.last_save_step is not None
                        and job.steps_done - job.last_save_step
                        >= job.checkpoint_every)):
                need_now.add(slot)
        fp_now = batch.fingerprint_slots() if need_now else None
        for slot, job in active:
            if slot in tripped or batch.slots[slot] is not job:
                continue
            why = None
            if job._fp is not None:
                for n, pair in job._fp.items():
                    got = inv["fp_in"][n][slot]
                    if int(got[0]) != pair[0] or int(got[1]) != pair[1]:
                        why = (f"fingerprint of field {n!r} changed "
                               "between dispatches (state corrupted "
                               "at rest)")
                        break
            if why is None and slot in need_now:
                for n in batch.fp_fields:
                    if not np.array_equal(fp_now[n][slot],
                                          inv["fp_out"][n][slot]):
                        why = (f"fingerprint of field {n!r} no longer "
                               "matches the dispatch output (state "
                               "corrupted after the step)")
                        break
            if why is None:
                steps = int(budget[slot])
                for n in batch.conserved:
                    s_in = float(inv["cs_in"][n][slot])
                    s_out = float(inv["cs_out"][n][slot])
                    shape, _dt = batch.schema[n]
                    n_el = batch.n_own * int(np.prod(shape, dtype=int)
                                             or 1)
                    tol = integrity.sum_tolerance(s_in, n_el,
                                                  max(1, steps))
                    if abs(s_out - s_in) > tol:
                        why = (f"conservation sum of field {n!r} "
                               f"drifted {abs(s_out - s_in):g} "
                               f"(tolerance {tol:g}) across the "
                               "quantum (in-compute corruption)")
                        break
            if why is not None:
                tripped.add(slot)
                self._sdc_trip(batch, slot, job, why)
            else:
                # the exit fingerprint is the next quantum's expected
                # entry fingerprint (exact, order-independent sums
                # compare bitwise across programs)
                job._fp = {n: (int(inv["fp_out"][n][slot, 0]),
                               int(inv["fp_out"][n][slot, 1]))
                           for n in batch.fp_fields}

    def _pick_audit(self, batch, active, budget):
        """The slot to shadow-audit this tick (round-robin over slots
        actually stepping) and its pre-quantum host state, or
        ``(None, None)`` off-cadence / when nothing steps."""
        if (self.audit_every <= 0
                or self.ticks % self.audit_every != 0):
            return None, None
        stepping = [slot for slot, _j in active if budget[slot] > 0]
        if not stepping:
            return None, None
        slot = stepping[self._audit_rr % len(stepping)]
        self._audit_rr += 1
        return slot, batch.extract(slot)

    def _run_audit(self, batch, slot, pre, steps, tripped) -> None:
        """Re-execute ``slot``'s last quantum from its pre-quantum
        state — in a spare slot of the SAME batch when one is free
        (the same program; every other slot is frozen
        bit-exact by its zero budget), else through the solo
        ``Grid.run_steps`` path on the bucket's scratch grid — and
        compare the results bitwise. A divergence is a CORRUPT verdict
        attributed to this slot and its device lane: either the
        original execution or the state since (an injected flip, memory
        rot) is wrong, and the checkpoint chain predates both."""
        job = batch.slots[slot]
        if job is None or job is SHADOW or steps <= 0:
            return
        t0 = time.perf_counter()
        try:
            with telemetry.span("integrity.audit"):
                digests = self._audit_digests(batch, slot, pre,
                                              steps, job)
                if digests is None:  # no comparable re-execution path
                    return
                live, shadow = digests
                # an audit counts only once a re-execution actually
                # compared — the bulk-no-spare and OOM skip paths
                # increment their own skip counter instead, so the
                # exposition never reports audits that did not run
                self.audits += 1
                telemetry.inc("dccrg_audits_total")
                # audit cost is a controller input: what one extra
                # re-execution window actually costs this fleet
                telemetry.observe("dccrg_audit_seconds",
                                  time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 - filtered just below
            if not resilience._is_resource_exhausted(e):
                raise
            # an OOM during the EXTRA audit dispatch must never kill
            # the fleet the audit protects: skip this window
            # (no verdict either way); if the pressure is real, the
            # next MAIN dispatch OOMs into _batch_oom's half-capacity
            # rebuild as usual
            logger.warning(
                "shadow audit of job %s skipped: the audit dispatch "
                "itself hit RESOURCE_EXHAUSTED (%s)", job.name, e)
            telemetry.inc("dccrg_audits_skipped_total")
            return
        # the verdict + containment run OUTSIDE the OOM-swallowing
        # try: only the audit's own extra dispatches may be skipped —
        # an OOM inside _sdc_trip's rollback must propagate, never
        # leave a half-applied trip on corrupt state
        if shadow != live:
            self.audit_failures += 1
            telemetry.inc("dccrg_audit_failures_total")
            tripped.add(slot)
            self._sdc_trip(
                batch, slot, job,
                f"shadow re-execution of the last {steps}-step "
                "quantum diverged from the live slot")

    def _audit_digests(self, batch, slot, pre, steps, job):
        live = batch.digest(slot)
        spare = batch.free_slot()
        if spare is not None:
            saved_extras = batch._extras[spare].copy()
            batch.insert(spare, pre)
            batch._extras[spare] = batch._extras[slot]
            bud = np.zeros(batch.capacity, dtype=np.int32)
            bud[spare] = steps
            batch.step(bud)
            shadow = batch.digest(spare)
            batch._extras[spare] = saved_extras
        elif batch.bulk_active():
            # the bucket stepped through kernel A', whose slot-wise
            # arithmetic matches the table kernel only to float
            # re-association: a solo table-path re-execution would
            # always diverge bitwise and convict healthy jobs. With no
            # spare slot there is no same-program re-execution to
            # compare against: skip this window (no verdict).
            logger.info(
                "shadow audit of job %s skipped: bucket runs kernel A' "
                "and no spare slot is free for a same-program "
                "re-execution", job.name)
            telemetry.inc("dccrg_audits_skipped_total")
            return None
        else:
            # solo re-execution: the unbatched path recomputes the
            # same quantum (bitwise identical by the fleet parity
            # contract), diversifying the program the audit trusts.
            # bulk=False: the bucket ran the TABLE program
            # (bulk_active() was False above), and a callable
            # SlotwiseKernel job would otherwise let Grid.run_steps
            # take the bulk executor here, the cross-program mismatch
            # the bulk_active() guard exists to prevent, mirrored.
            g = batch.grid
            for n, arr in pre.items():
                t = (arr if isinstance(arr, torch.Tensor)
                     else _to_tensor(np.array(arr, order="C"),
                                     batch.schema[n][1]))
                g.data[n] = t.to(g.device)[None].clone()
            g.run_steps(
                batch.kernel, batch.fields_in, batch.fields_out, steps,
                extra_args=tuple(
                    torch.tensor(p, dtype=torch.float32, device=g.device)
                    for p in job.params),
                bulk=False)
            shadow = checkpoint_mod.state_digest(g)
        return live, shadow

    def _check_dmr(self, batch, tripped) -> None:
        """Dual-modular-redundancy comparison: every
        ``redundancy>=2`` job's shadow replica must digest bitwise
        equal to its primary at every quantum boundary. A divergence
        is a CORRUPT verdict for the job (we cannot know which
        replica is wrong — the checkpoint chain predates the split,
        so the rollback repairs either case) and a suspect mark for
        the lane."""
        for sh, primary in list(batch.shadow_of.items()):
            job = batch.slots[primary]
            if job is None or primary in tripped:
                continue
            if batch.digest(primary) != batch.digest(sh):
                tripped.add(primary)
                self._sdc_trip(
                    batch, primary, job,
                    "DMR replicas diverged at the quantum boundary")

    def _sdc_trip(self, batch, slot, job, why) -> None:
        """A CORRUPT verdict: contain (per-slot rollback, the NaN
        discipline) and attribute (suspect accounting on the batch's
        device lane, quarantine after ``quarantine_after`` strikes)."""
        lane = getattr(batch, "lane", 0)
        logger.warning(
            "SDC verdict for fleet job %s (slot %d, device lane %d): "
            "%s", job.name, slot, lane, why)
        self._trip(batch, slot, job, "corrupt")
        if lane < len(self.suspects):
            self.suspects[lane] += 1
            integrity.note_suspect(lane, self.suspects[lane],
                                   quarantined=lane in self.quarantined)
            if (self.quarantine_after > 0
                    and lane not in self.quarantined
                    and self.suspects[lane] >= self.quarantine_after):
                # DEFERRED to the tick boundary: quarantine replaces
                # bucket instances, and this quantum is still
                # iterating the one that tripped
                self._pending_quarantine.add(lane)

    def _quarantine(self, lane: int) -> None:
        """Take device lane ``lane`` out of service: every bucket
        instance on it is rebuilt on a surviving lane with its
        admitted jobs migrated BIT-EXACTLY (the
        :meth:`~dccrg_tpu_torch.fleet.GridBatch.extract`/``insert`` path the
        batch-OOM rebuild uses), and admission never places new
        buckets there again. With no surviving lane the quarantine is
        recorded but the lane keeps serving — failing the whole fleet
        would be worse than suspect answers, and the operator sees
        the log either way."""
        survivors = [i for i in self.live_lanes() if i != lane]
        if not survivors:
            logger.error(
                "device lane %d exceeded the corruption threshold "
                "(%d verdict(s)) but is the ONLY lane; continuing to "
                "serve on suspect hardware", lane, self.suspects[lane])
            return
        self.quarantined.add(lane)
        integrity.note_suspect(lane, self.suspects[lane],
                               quarantined=True)
        moved = 0
        for key, insts in self.buckets.items():
            for i, batch in enumerate(insts):
                if getattr(batch, "lane", 0) != lane:
                    continue
                jobs = batch.jobs
                if not jobs:
                    insts[i] = None
                    continue
                new_lane = survivors[self._next_dev % len(survivors)]
                self._next_dev += 1
                fresh = GridBatch(jobs[0][1], batch.capacity,
                                  device=self.devices[new_lane],
                                  bulk=self.bulk)
                fresh.lane = new_lane
                for slot, job in jobs:
                    state = batch.extract(slot)
                    new_slot = fresh.admit(job, from_grid=False)
                    fresh.insert(new_slot, state)
                    # the bytes moved bit-exactly, so the fingerprint
                    # baseline survives the migration unchanged
                    if job.redundancy >= 2:
                        fresh.admit_shadow(new_slot)
                    moved += 1
                insts[i] = fresh
            self.buckets[key] = [b for b in insts if b is not None]
        logger.warning(
            "quarantined device lane %d after %d corrupt verdict(s); "
            "migrated %d job(s) bit-exactly to surviving lane(s) %s",
            lane, self.suspects[lane], moved, survivors)

    def _requeue_keyframed(self, batch, victims) -> None:
        """Requeue ``[(slot, job)]`` out of a live bucket: each slot's
        intact state saves a keyframe first, so re-admission resumes
        from here instead of replaying since the last periodic save
        (shared by the batch-OOM and SLO-shed paths)."""
        for slot, job in victims:
            try:
                self._save_job(batch, slot, job, force_keyframe=True)
            except OwnershipLostError as e:
                self._drop_lost(batch, slot, job, e)
                continue
            batch.clear(slot)
            job.requeues += 1
            self.add(job)

    def _rebuild_smaller(self, batch) -> GridBatch:
        """Replace ``batch`` with a half-capacity instance (floored at
        the survivor count) holding every surviving job migrated
        BIT-EXACTLY — the shrink primitive the batch-OOM and SLO-shed
        paths share. Occupancy alone frees neither device memory nor
        dispatch latency: the state arrays and the compiled program
        are both sized ``[capacity, ...]``, and freed slots would be
        backfilled from the queue on the very next tick."""
        survivors = batch.jobs
        new_cap = max(len(survivors), batch.capacity // 2)
        small = GridBatch(survivors[0][1], new_cap, device=batch.device,
                          bulk=self.bulk)
        small.lane = getattr(batch, "lane", 0)
        for slot, job in survivors:
            state = batch.extract(slot)
            new_slot = small.admit(job, from_grid=False)
            small.insert(new_slot, state)
            if job.redundancy >= 2 and small.admit_shadow(new_slot) \
                    is None:
                logger.warning(
                    "DMR job %s lost its shadow replica in the "
                    "half-size rebuild; running unreplicated",
                    job.name)
        insts = self.buckets[batch.key]
        insts[insts.index(batch)] = small
        # ANY rebuild changes the bucket's latency characteristics
        # (half the slots, and a fresh compile on the first dispatch):
        # reset the key's SLO EWMA and start the shed cooldown, so
        # the new instance is judged by its own measurements — on the
        # OOM path exactly as on the shed path
        self.slo.reset_key(batch.key)
        small._shed_tick = self.ticks
        return small

    def _batch_oom(self, batch, err) -> None:
        """A REAL (unattributed) RESOURCE_EXHAUSTED from the batched
        dispatch: the whole working set is too big. Requeue the
        lower-priority half of the bucket's jobs (their slot state is
        intact — the dispatch failed wholesale — so each saves a
        keyframe first) and REBUILD the bucket at a smaller capacity
        (:meth:`_rebuild_smaller`); repeated OOMs keep halving until
        a single job's failure is surfaced."""
        active = batch.jobs
        if len(active) <= 1:
            raise resilience.ResilienceExhaustedError(
                f"fleet bucket OOMs even with {len(active)} job(s)"
            ) from err
        by_prio = sorted(active, key=lambda e: (e[1].priority, -e[0]))
        drop = len(active) // 2
        self._requeue_keyframed(batch, by_prio[:drop])
        small = self._rebuild_smaller(batch)
        if self.autopilot is not None:
            self.autopilot.record_oom(batch.key, small.capacity)
        logger.warning(
            "fleet bucket OOM: requeued %d of %d job(s), rebuilt the "
            "bucket at capacity %d (was %d)", drop, len(active),
            small.capacity, batch.capacity)

    # -- latency-SLO shedding -----------------------------------------

    def _shed_for_slo(self, batch) -> None:
        """When ``batch``'s measured quantum latency blows the
        tightest admitted slot SLO (:meth:`SLOPolicy.shed_victims`),
        requeue the least-urgent cohabitants — keyframe first, so
        re-admission resumes from here — and REBUILD the bucket at
        half capacity with the survivors migrated bit-exactly (the
        ``_batch_oom`` discipline: occupancy alone frees no dispatch
        latency — the program is sized ``[capacity, ...]`` — and a
        freed slot would be backfilled next tick). The key's EWMA
        resets so the smaller bucket is judged by its own
        measurements, with a ``shed_cooldown``-tick grace."""
        victims = self.slo.shed_victims(batch.key, batch.jobs)
        if not victims:
            return
        if self.ticks - getattr(batch, "_shed_tick", -10**9) \
                < self.slo.shed_cooldown:
            return
        for _slot, job in victims:
            telemetry.inc("dccrg_fleet_slo_sheds_total", job=job.name)
        self._requeue_keyframed(batch, victims)
        # shed_victims caps at len(jobs)-1, so a survivor always
        # remains for the rebuild
        small = self._rebuild_smaller(batch)
        if self.autopilot is not None:
            self.autopilot.record_shed(batch.key, small.capacity)
        logger.warning(
            "SLO shed: requeued %d job(s) and rebuilt the bucket at "
            "capacity %d (was %d) — measured quantum latency blew "
            "the tightest admitted SLO", len(victims), small.capacity,
            batch.capacity)

    def _shed_for_lane(self) -> None:
        """Cross-bucket SLO shedding (mixed-kernel fleets): when a
        deadline job's projected completion against its LANE's total
        per-tick latency — every cohabiting bucket on the device
        dispatches each tick — violates the deadline while its own
        bucket alone would not, the best-effort jobs of the OTHER
        buckets on that lane are keyframed and PARKED (not requeued:
        the next admission pass would put them straight back) until
        the trigger job finishes. Tick-boundary act, once per lane
        per ``shed_cooldown``; a fleet without SLO jobs or with a
        single bucket per lane never enters the policy."""
        by_lane: dict = {}
        for insts in self.buckets.values():
            for b in insts:
                if b.jobs:
                    by_lane.setdefault(getattr(b, "lane", 0),
                                       []).append(b)
        for lane, batches in sorted(by_lane.items()):
            if len(batches) < 2:
                continue
            if self.ticks - self._lane_shed_tick.get(lane, -10**9) \
                    < self.slo.shed_cooldown:
                continue
            hit = self.slo.lane_shed_victims(
                [(i, b.key, b.jobs) for i, b in enumerate(batches)])
            if hit is None:
                continue
            trigger, victims = hit
            self._lane_shed_tick[lane] = self.ticks
            parked = 0
            for i, slot, job in victims:
                batch = batches[i]
                if batch.slots[slot] is not job:
                    continue
                try:
                    self._save_job(batch, slot, job,
                                   force_keyframe=True)
                except OwnershipLostError as e:
                    self._drop_lost(batch, slot, job, e)
                    continue
                batch.clear(slot)
                job.requeues += 1
                job.status = "parked"
                telemetry.inc("dccrg_fleet_lane_sheds_total",
                              job=job.name)
                self._parked.append({
                    "job": job, "trigger": trigger.name,
                    "max_tick": self.ticks
                    + 8 * max(1, self.slo.shed_cooldown)})
                parked += 1
            if parked:
                logger.warning(
                    "lane %d SLO shed: parked %d best-effort "
                    "cohabitant(s) from other buckets until deadline "
                    "job %s completes", lane, parked, trigger.name)

    def _release_parked(self, force: bool = False) -> None:
        """Re-enqueue lane-shed victims whose trigger finished (or
        whose backstop tick passed; ``force`` releases everything —
        the drain and preemption paths)."""
        if not self._parked:
            return
        still = []
        for entry in self._parked:
            trig = self._by_name.get(entry["trigger"])
            if (force or trig is None
                    or trig.status in ("done", "failed")
                    or self.ticks >= entry["max_tick"]):
                self.add(entry["job"])
            else:
                still.append(entry)
        self._parked = still

    # -- preemption ---------------------------------------------------

    def _preempt(self) -> None:
        requeued = []
        # lane-shed victims already hold park-time keyframes: back to
        # the queue so a resume serves them like any requeued job
        self._release_parked(force=True)
        with telemetry.span("fleet.preempt"):
            for insts in self.buckets.values():
                for batch in insts:
                    for slot, job in batch.jobs:
                        try:
                            self._save_job(batch, slot, job,
                                           force_keyframe=True)
                        except OwnershipLostError as e:
                            self._drop_lost(batch, slot, job, e)
                            continue
                        batch.clear(slot)
                        job.requeues += 1
                        self.add(job)
                        requeued.append(job.name)
            # every emergency keyframe must be DURABLE before the
            # resumable exit — the async writers get no grace after
            # the raise (kill-mid-overlap smoke in ci_debug_leg.sh)
            self._drain_stores(swallow=True)
        telemetry.inc("dccrg_fleet_preempts_total")
        supervise.clear_preempt()
        raise FleetPreemptedError(requeued)

    def _drain_stores(self, swallow: bool = False) -> None:
        """Async-save barrier over every stem this scheduler owns."""
        for name, store in list(self._stores.items()):
            try:
                store.drain()
            except Exception as e:  # noqa: BLE001 - policy filter below
                if not swallow:
                    raise
                logger.error("async save of stem %s failed at drain "
                             "(%s); its last durable checkpoint is the "
                             "resume point", name, e)

    # -- the serving loop ---------------------------------------------

    def active_jobs(self) -> list:
        """``[(batch, slot, job)]`` of every admitted job."""
        return [(b, s, j) for insts in self.buckets.values()
                for b in insts for s, j in b.jobs]

    def run(self, max_ticks=None) -> dict:
        """Serve until the queue and every bucket drain (or
        ``max_ticks`` quantum rounds elapse). Returns the per-job
        report ``{name: {status, steps, digest, trips, ...}}``.
        Raises :class:`FleetPreemptedError` after emergency-saving
        and requeueing every admitted job when preempted."""
        ctx = (supervise.preemption_handlers() if self._install
               else nullcontext())
        with ctx:
            while True:
                if (supervise.preempt_requested()
                        or faults.take_preempt(self.ticks)):
                    self._preempt()
                if faults.active() is not None and faults.take_host_death(
                        self.membership.rank if self.membership else 0,
                        self.ticks):
                    # the in-process honoring of FaultPlan.host_death
                    # (the mp harness lets InjectedRankDeath hard-exit
                    # the OS process — an actual dead host)
                    raise faults.InjectedRankDeath(
                        f"injected host death at tick {self.ticks}")
                if self.rank_aware:
                    self._rank_tick()
                if self.intake is not None:
                    # the streaming front door: scan / crash-recover /
                    # gate / admit before this tick's admission pass
                    # reads the queue
                    self.intake.pump()
                self._release_parked()
                self._admit_pending()
                active = [b for insts in self.buckets.values()
                          for b in insts if b.jobs]
                if not active:
                    if self._parked and not self._queue:
                        # everything else drained: whatever the parked
                        # jobs were yielding to is gone — serve them
                        self._release_parked(force=True)
                        continue
                    if self._queue:
                        raise RuntimeError(
                            "fleet wedged: queued jobs but no bucket "
                            "can admit them")
                    if self.rank_aware and self._remote:
                        # local work drained but the FLEET has not:
                        # idle at a fraction of the heartbeat cadence,
                        # watching the remote leases (the rank tick
                        # above reclaims on expiry) and done markers
                        self.ticks += 1
                        if max_ticks is not None \
                                and self.ticks >= int(max_ticks):
                            break
                        time.sleep(min(0.05,
                                       self.membership.heartbeat_s / 4))
                        continue
                    if self.intake is not None \
                            and not self.intake.idle():
                        # local work drained but the front door has
                        # waiting or in-flight records: idle-continue
                        # at the intake poll cadence
                        self.ticks += 1
                        if max_ticks is not None \
                                and self.ticks >= int(max_ticks):
                            break
                        if self.intake.poll_s > 0:
                            time.sleep(self.intake.poll_s)
                        continue
                    if self.autopilot is not None:
                        # a clean drain: seeded keys that never
                        # OOMed/shed earn their capacity floor back
                        self.autopilot.end_of_run()
                    break
                for batch in active:
                    self._quantum(batch)
                # quarantine at the tick boundary (never mid-quantum:
                # it replaces bucket instances under migration)
                for lane in sorted(self._pending_quarantine):
                    if lane not in self.quarantined:
                        self._quarantine(lane)
                self._pending_quarantine.clear()
                # latency-SLO shedding, also a tick-boundary act (it
                # replaces bucket instances); iterate a snapshot of
                # the CURRENT instances — a _batch_oom mid-tick may
                # already have swapped one out
                for insts in list(self.buckets.values()):
                    for batch in list(insts):
                        if batch.jobs:
                            self._shed_for_slo(batch)
                # cross-bucket (mixed-kernel) lane shedding — same
                # tick-boundary discipline; no-op without SLO jobs or
                # with one bucket per lane
                self._shed_for_lane()
                # autopilot control pass — also a tick-boundary act
                # (it retunes the knobs the NEXT tick dispatches
                # with); None (the default) skips everything
                if self.autopilot is not None:
                    self.autopilot.tick(self)
                self.ticks += 1
                telemetry.maybe_export_metrics()
                if max_ticks is not None and self.ticks >= int(max_ticks):
                    break
        # a write still in flight when serving stops must be durable
        # before the caller reads the report/stores (digest checks,
        # resume over the same dir); failures surface like sync saves'
        self._drain_stores()
        return self.report
