"""Durable streaming intake: the crash-consistent job front door.

The fleet historically drained a static job list handed to one
process — there was no way for work to ARRIVE. This module is the
streaming front door: jobs land as spec files in a **spool
directory** (atomic rename-in — visibility IS the rename), any live
rank may tail the spool, claim a record, and feed it to
``FleetScheduler.add`` with every step of that journey
crash-consistent:

- **Exactly-once admission.** A spool record is claimed through a
  coordination-KV CAS lease (:class:`~dccrg_tpu_torch.scheduler.JobLeases`
  under the ``dccrg/intake`` prefix — the fleet's lease/epoch
  machinery, unchanged): the KV's first-writer-wins ``create`` means
  exactly one rank owns an admission at a time. The claimant writes
  a sealed **journal record** (the validated payload) BEFORE adding
  the job, and keeps renewing its intake lease until the fleet shows
  durable evidence of the job (its ``dccrg/job`` lease or done
  marker; locally-held jobs in the single-host case). A rank killed
  between claim and add — or between add and fleet takeover — leaves
  an expiring lease a survivor reclaims with the epoch-fenced
  ``try_reclaim`` CAS and **re-admits from the journal record**
  (falling back to the spool file, which is only archived at
  finalize). Duplicate submissions are rejected by content **nonce**
  (a CAS-created ``nonce/`` key) and by the terminal ``done/``
  marker. Proven with real OS process kills in
  tests/test_torch_mp_fleet_real.py (``intake_kill``).

- **Typed retry/backoff envelope + poison-job quarantine.**
  Transient faults (torn spool reads convicted by the sealed-record
  CRC frame, injected I/O and KV faults from
  :class:`~dccrg_tpu_torch.faults.FaultPlan`) retry with jittered
  exponential backoff (deterministically seeded, capped); a record
  that fails ``K`` times — or permanently
  (:class:`~dccrg_tpu_torch.fleet.JobSpecError`,
  :class:`~dccrg_tpu_torch.fleet.UnknownKernelError`, a torn frame that
  can never heal) — moves to ``spool/quarantine/`` with a structured
  ``<name>.reason.json`` record instead of wedging the stream.

- **Overload backpressure with hysteresis.** Arrival-rate and
  drain-rate EWMAs drive an admission gate evaluated once per EWMA
  window: it closes when arrivals outrun drain (ratio >= ``hi``) or
  the oldest waiting record ages past the bound, and reopens only
  below the strictly lower ``lo`` — the hysteresis band plus the
  windowed cadence keep it from flapping (<= 1 transition per
  window by construction). A closed gate pauses NEW admissions; the
  spool is the durable buffer. When the backlog implies an unbounded
  queue age even at full drain, the newest records of the
  most-backlogged tenant are **gracefully shed** (journaled, moved
  to ``spool/shed/`` — re-submittable, never silently dropped).
  Per-tenant token buckets (``DCCRG_TENANT_RATE``) and weighted
  virtual-time fairness (``DCCRG_TENANT_WEIGHT``) order admissions
  across tenants; within the scheduler the existing ``SLOPolicy``
  admission keys take over.

- **Control-plane integration.** Every backpressure flip, shed and
  quarantine is a structured autopilot decision record
  (``intake.backpressure`` / ``intake.shed`` /
  ``intake.quarantine`` rules) that ``python -m dccrg_tpu_torch.autopilot
  explain|replay`` reconstructs divergence-free; telemetry grows
  queue-age histograms (``dccrg_intake_queue_age_seconds``,
  per-tenant), per-tenant admit/shed counters and an intake-lag
  gauge (``dccrg_intake_lag``).

Spool layout (all under one directory, shared by every rank)::

    spool/<name>.json            # sealed spec record (rename-in)
    spool/.tmp/                  # submit staging (never scanned)
    spool/admitted/<name>.json   # archived at finalize
    spool/quarantine/<name>.json + <name>.reason.json
    spool/shed/<name>.json       # graceful-shed victims

KV layout (``dccrg/intake`` prefix, riding ``JobLeases``)::

    dccrg/intake/<name>          # admission lease "rank:epoch:beat"
    dccrg/intake/<name>@<epoch>  # the reclaim claim (CAS)
    dccrg/intake/journal/<name>  # sealed validated payload
    dccrg/intake/nonce/<nonce>   # content-dedupe key (CAS) -> name
    dccrg/intake/done/<name>     # terminal marker "admitted:rank"

OFF by default: ``FleetScheduler`` constructs an intake only under
``DCCRG_INTAKE=1`` (spool from ``DCCRG_INTAKE_SPOOL``) or when one is
injected — otherwise ``sched.intake`` is None and the serving loop
takes zero new branches (the negative pin in
tests/test_torch_intake.py).

Host work only, as in the reference: nothing here touches a tensor.
The retry jitter draws one seeded ``random.Random`` in the reference's
order, so two runs with one seed journal the same decisions.
"""

from __future__ import annotations

import json
import logging
import os
import random
import time

from . import coord, faults, fleet, telemetry
from . import autopilot as autopilot_mod
from .scheduler import JobLeases, OwnershipLostError

logger = logging.getLogger(__name__)

#: spool subdirectories (never scanned for intake records)
TMP_DIR = ".tmp"
ADMITTED_DIR = "admitted"
QUARANTINE_DIR = "quarantine"
SHED_DIR = "shed"
_SUBDIRS = (TMP_DIR, ADMITTED_DIR, QUARANTINE_DIR, SHED_DIR)

#: the KV prefix intake admission leases/journals/nonces live under
#: (disjoint from the fleet's ``dccrg/job`` serving leases)
PREFIX = "dccrg/intake"


# ---------------------------------------------------------------------
# env knobs (all read at construction; features off by default)
# ---------------------------------------------------------------------

def intake_enabled_default(default: bool = False) -> bool:
    """The ``DCCRG_INTAKE`` env knob: ``1`` makes ``FleetScheduler``
    construct a :class:`StreamIntake` over ``DCCRG_INTAKE_SPOOL`` and
    pump it every tick. Off (default): no intake object exists and
    the serving loop is unchanged."""
    v = os.environ.get("DCCRG_INTAKE", "")
    if v == "":
        return default
    return v not in ("0", "off", "false", "no")


def spool_default():
    """The ``DCCRG_INTAKE_SPOOL`` env knob: the spool directory jobs
    arrive in (created on first use)."""
    return os.environ.get("DCCRG_INTAKE_SPOOL") or None


def retries_default(default: int = 4) -> int:
    """The ``DCCRG_INTAKE_RETRIES`` env knob: transient admission
    attempts before a record is quarantined as poison (K)."""
    try:
        return max(1, int(os.environ.get("DCCRG_INTAKE_RETRIES", "")
                          or default))
    except ValueError:
        return default


def backoff_default(default: float = 0.05) -> float:
    """The ``DCCRG_INTAKE_BACKOFF_S`` env knob: base of the jittered
    exponential retry backoff (seconds; attempt ``i`` waits
    ``base * 2**(i-1)`` +- jitter, capped)."""
    try:
        return max(0.0, float(
            os.environ.get("DCCRG_INTAKE_BACKOFF_S", "") or default))
    except ValueError:
        return default


def backoff_cap_default(default: float = 2.0) -> float:
    """The ``DCCRG_INTAKE_BACKOFF_CAP_S`` env knob: upper bound on a
    single retry delay (seconds)."""
    try:
        return max(0.0, float(
            os.environ.get("DCCRG_INTAKE_BACKOFF_CAP_S", "")
            or default))
    except ValueError:
        return default


def age_bound_default(default: float = 30.0) -> float:
    """The ``DCCRG_INTAKE_AGE_S`` env knob: the bounded-queue-age
    target (seconds) the backpressure gate and the graceful shed
    enforce."""
    try:
        return max(0.1, float(
            os.environ.get("DCCRG_INTAKE_AGE_S", "") or default))
    except ValueError:
        return default


def _parse_tenant_map(raw: str, cast=float):
    """``"5"`` (every tenant), ``"a=2,b=5,*=1"`` (named + default)
    -> ``{tenant: value}`` with ``"*"`` as the fallback key; None for
    empty/unparseable."""
    raw = (raw or "").strip()
    if not raw:
        return None
    out = {}
    try:
        if "=" not in raw:
            return {"*": cast(raw)}
        for part in raw.split(","):
            part = part.strip()
            if not part:
                continue
            k, v = part.split("=", 1)
            out[k.strip()] = cast(v)
    except ValueError:
        return None
    return out or None


def tenant_rate_default():
    """The ``DCCRG_TENANT_RATE`` env knob: per-tenant token-bucket
    admission rate in jobs/second — ``"5"`` for every tenant or
    ``"tenantA=2,tenantB=5,*=1"``. Unset: no rate limit."""
    return _parse_tenant_map(os.environ.get("DCCRG_TENANT_RATE", ""))


def tenant_weight_default():
    """The ``DCCRG_TENANT_WEIGHT`` env knob: weighted-fairness shares
    (same syntax as ``DCCRG_TENANT_RATE``; default weight 1)."""
    return _parse_tenant_map(os.environ.get("DCCRG_TENANT_WEIGHT", ""))


def tenant_burst_default(default: float = 4.0) -> float:
    """The ``DCCRG_TENANT_BURST`` env knob: token-bucket burst depth
    (jobs a briefly idle tenant may admit back-to-back)."""
    try:
        return max(1.0, float(
            os.environ.get("DCCRG_TENANT_BURST", "") or default))
    except ValueError:
        return default


# ---------------------------------------------------------------------
# typed errors
# ---------------------------------------------------------------------

class IntakeError(Exception):
    """Base class of intake front-door failures."""


class IntakeRetryExhausted(IntakeError):
    """A spool record burned its K transient-retry budget — the
    poison-job verdict that moves it to quarantine."""

    def __init__(self, name: str, attempts: int, last_error):
        self.name = str(name)
        self.attempts = int(attempts)
        self.last_error = last_error
        super().__init__(
            f"intake record {name!r}: {attempts} admission attempts "
            f"exhausted (last: {type(last_error).__name__}: "
            f"{last_error})")


#: admission faults that can NEVER heal by retrying — straight to
#: quarantine with the typed reason (the satellite contract:
#: unknown-kernel specs are a typed quarantine reason, not a raw
#: KeyError)
PERMANENT_FAULTS = (fleet.JobSpecError, fleet.UnknownKernelError,
                    json.JSONDecodeError)


# ---------------------------------------------------------------------
# producer side: durable spool submission
# ---------------------------------------------------------------------

def record_nonce(row: dict, tenant: str) -> str:
    """The content nonce a duplicate submission is rejected by: a
    CRC of the canonical JSON of (tenant, job row). Two submissions
    of the SAME spec dedupe; a different spec under a reused name is
    a conflict the admission path surfaces."""
    import zlib

    canon = json.dumps({"job": row, "tenant": tenant}, sort_keys=True)
    return f"{zlib.crc32(canon.encode('utf-8')) & 0xFFFFFFFF:08x}"


def ensure_spool(spool: str) -> str:
    """Create the spool directory tree (idempotent)."""
    spool = str(spool)
    os.makedirs(spool, exist_ok=True)
    for d in _SUBDIRS:
        os.makedirs(os.path.join(spool, d), exist_ok=True)
    return spool


def submit(spool: str, row: dict, *, tenant: str = "default",
           nonce=None) -> str:
    """Durably submit one job record to the spool: write the sealed
    spec to ``spool/.tmp/`` and atomically rename it in — a crashed
    submitter leaves either a complete visible record or an invisible
    temp file, never a half-visible one (fault injection lands both
    torn halves deliberately: :meth:`~dccrg_tpu_torch.faults.FaultPlan.
    spool_torn_write` tears the payload AT the final name so the
    reader's CRC conviction is exercised;
    :meth:`~dccrg_tpu_torch.faults.FaultPlan.spool_torn_rename` drops the
    rename). Returns the final spool path. ``row`` is a fleet job-row
    dict (see :func:`dccrg_tpu_torch.fleet.job_from_row`); ``name`` is
    required and is the admission/checkpoint identity."""
    if "name" not in row:
        raise fleet.JobSpecError(f"job row without a name: {row}")
    name = str(row["name"])
    if os.sep in name or name.startswith("."):
        raise fleet.JobSpecError(f"unsafe job name {name!r}")
    ensure_spool(spool)
    payload = {"job": dict(row), "tenant": str(tenant),
               "nonce": str(nonce) if nonce is not None
               else record_nonce(row, str(tenant))}
    sealed = coord.seal_record(json.dumps(payload, sort_keys=True))
    if faults.take_spool_torn(job=name):
        # a submitter death mid-write: a truncated frame LANDS
        sealed = sealed[:max(1, len(sealed) // 2)]
    tmp = os.path.join(spool, TMP_DIR, f"{name}.json")
    with open(tmp, "w") as f:
        f.write(sealed)
        f.flush()
        os.fsync(f.fileno())
    final = os.path.join(spool, f"{name}.json")
    if faults.take_spool_torn_rename(job=name):
        # a submitter death between write and rename: the record
        # never becomes visible (the durable-spool contract)
        return final
    os.replace(tmp, final)
    return final


# ---------------------------------------------------------------------
# rate estimation + per-tenant admission shaping
# ---------------------------------------------------------------------

class _Ewma:
    """Rate EWMA over irregular samples: ``update(count, dt)`` folds
    ``count/dt`` in with weight ``1 - exp(-dt/tau)`` (so the smoothing
    horizon is ``tau`` SECONDS regardless of pump cadence — fake-clock
    and real-clock tests share the numbers)."""

    def __init__(self, tau_s: float):
        self.tau_s = float(tau_s)
        self.value = None

    def update(self, count: float, dt: float) -> float:
        import math

        if dt <= 0:
            return self.value if self.value is not None else 0.0
        rate = float(count) / dt
        if self.value is None:
            self.value = rate
        else:
            a = 1.0 - math.exp(-dt / self.tau_s)
            self.value += a * (rate - self.value)
        return self.value


class _TokenBucket:
    """Per-tenant admission rate limit: ``rate`` tokens/second up to
    ``burst``; an admission spends one token."""

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self.t = float(now)

    def take(self, now: float) -> bool:
        self.tokens = min(self.burst,
                          self.tokens + (now - self.t) * self.rate)
        self.t = float(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class _Retry:
    __slots__ = ("attempts", "next_t", "last_error")

    def __init__(self):
        self.attempts = 0
        self.next_t = 0.0
        self.last_error = None


# ---------------------------------------------------------------------
# the consumer: spool tail -> claim -> admit, crash-consistently
# ---------------------------------------------------------------------

class StreamIntake:
    """Tail a spool directory and feed a ``FleetScheduler``
    crash-consistently (see the module docstring for the protocol).

    ``kv``/``rank``/``clock`` default to the scheduler's membership
    when attached (real multi-host fleets share the coordination
    service KV); standalone construction takes
    :func:`~dccrg_tpu_torch.coord.default_kv` and rank 0. All control knobs
    (retries, backoff, age bound, tenant rates/weights) default to
    their env readers; tests inject a fake clock plus explicit
    numbers. ``autopilot=None`` journals nothing — the same
    negative-pin discipline as the scheduler's controller hook."""

    def __init__(self, spool, *, kv=None, rank=None, clock=None,
                 membership=None, autopilot=None, lease_s=None,
                 retries=None, backoff_s=None, backoff_cap_s=None,
                 age_bound_s=None, hi_ratio=1.2, lo_ratio=0.9,
                 window_s=2.0, ewma_tau_s=None, rates=None,
                 weights=None, burst=None, max_admit=8, seed=0,
                 poll_s=0.02):
        self.spool = ensure_spool(spool)
        self.membership = membership
        if kv is None:
            kv = (membership.kv if membership is not None
                  else coord.default_kv())
        if rank is None:
            rank = membership.rank if membership is not None else 0
        if clock is None:
            clock = (membership.clock if membership is not None
                     else time.monotonic)
        self.rank = int(rank)
        self.clock = clock
        self.leases = JobLeases(kv, self.rank, lease_s=lease_s,
                                clock=clock, prefix=PREFIX)
        self.kv = kv
        self.autopilot = autopilot
        self.retries = (retries_default() if retries is None
                        else max(1, int(retries)))
        self.backoff_s = (backoff_default() if backoff_s is None
                          else float(backoff_s))
        self.backoff_cap_s = (backoff_cap_default()
                              if backoff_cap_s is None
                              else float(backoff_cap_s))
        self.age_bound_s = (age_bound_default() if age_bound_s is None
                            else float(age_bound_s))
        self.hi_ratio = float(hi_ratio)
        self.lo_ratio = float(lo_ratio)
        self.window_s = float(window_s)
        self.ewma_tau_s = (self.window_s if ewma_tau_s is None
                           else float(ewma_tau_s))
        self.rates = tenant_rate_default() if rates is None else rates
        self.weights = (tenant_weight_default() if weights is None
                        else weights)
        self.burst = (tenant_burst_default() if burst is None
                      else float(burst))
        self.max_admit = max(1, int(max_admit))
        self.poll_s = float(poll_s)
        self._rng = random.Random(int(seed) * 9176 + self.rank)
        self.sched = None
        # gate state: 0 = open, 1 = closed; transitions counted for
        # the flap bound (<= 1 per window)
        self.gate = 0
        self.gate_transitions = 0
        self._gate_eval_t = None
        self.arrival = _Ewma(self.ewma_tau_s)
        self.drain = _Ewma(self.ewma_tau_s)
        self._last_pump_t = None
        self._arrived_since = 0
        self._done_seen = 0
        # observer-clock arrival tracking: name -> first-seen clock
        # (the queue-age signal; no cross-host clock comparison)
        self._seen: dict = {}
        self._waiting: list = []  # [(name, path)] from the last scan
        self._retry: dict = {}    # name -> _Retry
        self._buckets: dict = {}  # tenant -> _TokenBucket
        self._vtime: dict = {}    # tenant -> virtual time (fairness)
        self._meta: dict = {}     # owned name -> {"tenant": ...}
        self.admitted = 0
        self.deduped = 0
        self.quarantined = 0
        self.shed = 0
        self.reclaimed = 0

    # -- wiring --------------------------------------------------------

    @classmethod
    def from_env(cls, sched):
        """The ``DCCRG_INTAKE=1`` construction path: spool from
        ``DCCRG_INTAKE_SPOOL`` (required), everything else from the
        env readers and the scheduler's own membership/autopilot."""
        spool = spool_default()
        if not spool:
            raise IntakeError(
                "DCCRG_INTAKE=1 needs DCCRG_INTAKE_SPOOL=<dir>")
        intake = cls(spool, membership=sched.membership,
                     autopilot=sched.autopilot)
        return intake

    def attach(self, sched) -> None:
        """Bind to the scheduler whose ``add`` this intake feeds;
        adopts its autopilot when none was injected (one journal)."""
        self.sched = sched
        if self.autopilot is None:
            self.autopilot = sched.autopilot

    # -- spool scanning ------------------------------------------------

    def _scan(self, now: float) -> list:
        """List the waiting spool records (sorted — deterministic
        admission order), tracking first-seen clocks for the queue-age
        signal. Honors the delayed-visibility fault: one scan hides
        the newest not-yet-tracked entry."""
        try:
            names = sorted(os.listdir(self.spool))
        except OSError:
            return self._waiting
        entries = [n[:-5] for n in names
                   if n.endswith(".json") and not n.startswith(".")]
        if entries and faults.take_spool_delay(rank=self.rank):
            fresh = [n for n in entries if n not in self._seen]
            if fresh:
                entries = [n for n in entries if n != fresh[-1]]
        for n in entries:
            if n not in self._seen:
                self._seen[n] = now
                self._arrived_since += 1
        gone = [n for n in self._seen if n not in entries]
        for n in gone:
            # admitted/archived/shed elsewhere: stop aging it
            if n not in self.leases.owned:
                self._seen.pop(n, None)
        self._waiting = [(n, os.path.join(self.spool, f"{n}.json"))
                         for n in entries
                         if n not in self.leases.owned]
        return self._waiting

    def backlog(self) -> int:
        """Waiting spool records as of the last pump (the intake-lag
        gauge's source)."""
        return len(self._waiting)

    def idle(self) -> bool:
        """True when nothing is in flight: no waiting spool records
        and no admission lease still being watched to finalize."""
        return not self._waiting and not self.leases.owned

    def oldest_age(self, now: float) -> float:
        """Age of the oldest WAITING record by this observer's clock
        (0.0 with an empty spool) — the gate's bounded-queue-age
        signal."""
        ages = [now - self._seen[n] for n, _p in self._waiting
                if n in self._seen]
        return max(ages) if ages else 0.0

    # -- record loading (the retry envelope's protected region) --------

    def _load(self, name: str, path: str) -> dict:
        faults.fire("intake.spool.read", job=name, rank=self.rank)
        with open(path) as f:
            raw = f.read()
        payload = coord.unseal_record(raw, key=f"spool/{name}")
        d = json.loads(payload)
        if not isinstance(d, dict) or "job" not in d:
            raise fleet.JobSpecError(
                f"spool record {name!r}: no job row")
        return d

    # -- quarantine ----------------------------------------------------

    def _quarantine(self, name: str, path: str, err, attempts: int,
                    tenant: str = "?") -> None:
        """Move a poison record to ``spool/quarantine/`` with a
        structured reason file; journal the decision; the stream
        continues draining behind it."""
        qdir = os.path.join(self.spool, QUARANTINE_DIR)
        try:
            if os.path.exists(path):
                os.replace(path, os.path.join(qdir, f"{name}.json"))
        except OSError:
            pass
        reason = {
            "name": name, "tenant": tenant,
            "attempts": int(attempts),
            "error_type": type(err).__name__,
            "error": str(err),
            "rank": self.rank,
            "t": round(float(self.clock()), 6),
        }
        tmp = os.path.join(qdir, f".{name}.reason.tmp")
        try:
            with open(tmp, "w") as f:
                json.dump(reason, f, sort_keys=True, indent=1)
            os.replace(tmp, os.path.join(qdir,
                                         f"{name}.reason.json"))
        except OSError:
            logger.warning("intake: quarantine reason for %s did not "
                           "land", name)
        self.quarantined += 1
        self._retry.pop(name, None)
        self._seen.pop(name, None)
        self.leases.release(name)
        telemetry.inc("dccrg_intake_quarantined_total", tenant=tenant)
        if self.autopilot is not None:
            self.autopilot.record_intake_quarantine(
                name, {"tenant": tenant, "attempts": int(attempts),
                       "error_type": type(err).__name__,
                       "error": str(err)[:200]})
        logger.warning("intake: record %s quarantined after %d "
                       "attempt(s): %s", name, attempts, err)

    def _transient_failed(self, name: str, path: str, err,
                          now: float, tenant: str = "?") -> None:
        """One transient admission failure: jittered exponential
        backoff, quarantine at the K-th."""
        st = self._retry.setdefault(name, _Retry())
        st.attempts += 1
        st.last_error = err
        telemetry.inc("dccrg_intake_retries_total")
        if st.attempts >= self.retries:
            self._quarantine(
                name, path,
                IntakeRetryExhausted(name, st.attempts, err),
                st.attempts, tenant)
            return
        delay = min(self.backoff_cap_s,
                    self.backoff_s * (2.0 ** (st.attempts - 1)))
        delay *= 1.0 + 0.25 * self._rng.random()  # decorrelate ranks
        st.next_t = now + delay
        logger.info("intake: record %s attempt %d failed (%s); "
                    "retry in %.3gs", name, st.attempts, err, delay)

    # -- exactly-once admission ---------------------------------------

    def _journal_key(self, name: str) -> str:
        return f"{PREFIX}/journal/{name}"

    def _done_key(self, name: str) -> str:
        return f"{PREFIX}/done/{name}"

    def _archive(self, name: str) -> None:
        src = os.path.join(self.spool, f"{name}.json")
        try:
            if os.path.exists(src):
                os.replace(src, os.path.join(
                    self.spool, ADMITTED_DIR, f"{name}.json"))
        except OSError:
            pass

    def _admit_payload(self, name: str, payload: dict,
                       now: float) -> bool:
        """The claim->journal->add critical section (intake lease
        already held). Returns True when the job entered the
        scheduler queue."""
        tenant = str(payload.get("tenant", "default"))
        # the journal record is what a survivor re-admits from after
        # a kill between this write and the scheduler add
        self.kv.set(self._journal_key(name), coord.seal_record(
            json.dumps(payload, sort_keys=True)))
        # the exactly-once admission window the mp harness kills in
        faults.fire("intake.claim", rank=self.rank, job=name)
        job = fleet.job_from_row(payload["job"], validate_kernel=True)
        self.leases.check(name)  # the fencing gate before the add
        if self.sched is None:
            raise IntakeError("intake not attached to a scheduler")
        if name in self.sched._by_name:
            # already in this scheduler (a reclaim raced a requeue):
            # nothing to add; fall through to finalize-watching
            pass
        else:
            self.sched.add(job)
        warm = getattr(self.sched, "warm", None)
        if warm is not None:
            # the stream knows what is about to dispatch: bump this
            # bucket key to the front of the prewarm queue
            warm.note_incoming(job.bucket_key())
        self._meta[name] = {"tenant": tenant}
        self._retry.pop(name, None)
        age = now - self._seen.get(name, now)
        telemetry.observe("dccrg_intake_queue_age_seconds", age,
                          tenant=tenant)
        telemetry.inc("dccrg_intake_admitted_total", tenant=tenant)
        self.admitted += 1
        vt = self._vtime.get(tenant, 0.0)
        self._vtime[tenant] = vt + 1.0 / self._weight(tenant)
        return True

    def _try_admit(self, name: str, path: str, payload: dict,
                   now: float) -> str:
        """Admit one waiting record (spool payload already loaded by
        the caller, ONCE, under the same envelope); returns a
        disposition tag (for tests): ``admitted``, ``dedup``,
        ``foreign``, ``inflight``, ``failed``, ``quarantined``."""
        if name in self.leases.owned:
            return "inflight"  # this pump already (re-)admitted it
        tenant = str(payload.get("tenant", "default"))
        try:
            # terminal marker: already admitted (and finalized) by
            # someone — a late duplicate file
            if self.kv.get(self._done_key(name)) is not None:
                self._archive(name)
                self._seen.pop(name, None)
                self.deduped += 1
                telemetry.inc("dccrg_intake_dedupe_total",
                              tenant=tenant)
                return "dedup"
            # content-nonce dedupe: the CAS key maps nonce -> name;
            # losing the CAS to a DIFFERENT name means this content
            # was already submitted under another identity
            nonce = str(payload.get("nonce", ""))
            if nonce:
                key = f"{PREFIX}/nonce/{nonce}"
                if not self.kv.create(key, name):
                    owner = self.kv.get(key)
                    if owner is not None and str(owner) != name:
                        self._archive(name)
                        self._seen.pop(name, None)
                        self.deduped += 1
                        telemetry.inc("dccrg_intake_dedupe_total",
                                      tenant=tenant)
                        logger.info(
                            "intake: record %s deduped (nonce held "
                            "by %s)", name, owner)
                        return "dedup"
            try:
                self.leases.acquire(name)
            except OwnershipLostError:
                return "foreign"  # another live rank is admitting it
            self._admit_payload(name, payload, now)
            return "admitted"
        except PERMANENT_FAULTS as e:
            st = self._retry.get(name)
            self._quarantine(name, path, e,
                             (st.attempts if st else 0) + 1, tenant)
            return "quarantined"
        except OwnershipLostError:
            return "foreign"
        except coord.TornRecordError as e:
            # a torn spool frame MAY be a submitter still mid-crash
            # landing; retry K times, then it is poison
            self._transient_failed(name, path, e, now, tenant)
            return "failed"
        except (OSError, faults.InjectedIOError) as e:
            self._transient_failed(name, path, e, now, tenant)
            return "failed"

    # -- crash recovery: reclaim + half-admitted re-admission ---------

    def _reclaim_pass(self, census, now: float) -> None:
        """Scan the intake-lease census for records whose claimant
        died mid-admission: lease expired (observer-aged) — and the
        holder DEAD by membership when one is attached — then the
        epoch-fenced CAS takeover, and re-admission from the journal
        record (the spool file as fallback)."""
        if census is None:
            return
        base = PREFIX + "/"
        for key, _raw in sorted(census.items()):
            tail = key[len(base):]
            if "/" in tail or "@" in tail or not tail:
                continue  # claim keys / journal / nonce / done
            name = tail
            if name in self.leases.owned:
                continue
            if census.get(self._done_key(name)) is not None:
                continue
            dead = self.leases.expired_holder(name, census)
            if dead is None:
                continue
            if (self.membership is not None
                    and self.membership.state(dead)
                    != coord.Membership.DEAD):
                continue  # a live rank stalled mid-admission keeps it
            epoch = self.leases.try_reclaim(name)
            if epoch is None:
                continue  # another survivor won
            self.reclaimed += 1
            telemetry.inc("dccrg_intake_reclaims_total")
            logger.warning(
                "intake: admission lease of rank %d on %s expired "
                "(>= %gs); reclaimed at epoch %d — re-admitting",
                dead, name, self.leases.lease_s, epoch)
            self._readmit(name, now)

    def _readmit(self, name: str, now: float) -> None:
        """Re-admit a reclaimed half-admitted record from its journal
        (falling back to the still-unarchived spool file)."""
        path = os.path.join(self.spool, f"{name}.json")
        payload = None
        raw = self.kv.get(self._journal_key(name))
        if raw is not None:
            try:
                payload = json.loads(
                    coord.unseal_record(raw, key=f"journal/{name}"))
            except (coord.TornRecordError, ValueError):
                payload = None  # torn journal: the spool file decides
        try:
            if payload is None:
                payload = self._load(name, path)
            self._seen.setdefault(name, now)
            self._admit_payload(name, payload, now)
        except PERMANENT_FAULTS as e:
            self._quarantine(name, path, e, 1,
                             str((payload or {}).get("tenant", "?")))
        except OwnershipLostError:
            pass  # fenced while re-admitting: the new owner has it
        except (OSError, faults.InjectedIOError,
                coord.TornRecordError) as e:
            # transient: keep the lease, the retry envelope resumes
            # on the next pump via the normal waiting path
            self._transient_failed(name, path, e, now)

    def _fleet_evidence(self, name: str) -> bool:
        """Durable evidence the fleet took the job over (the intake
        lease may stop renewing): the scheduler's own serving lease
        or done marker in rank-aware mode, plain local presence
        otherwise (single-host: the KV dies with the process)."""
        sched = self.sched
        if sched is None:
            return False
        if sched.leases is None:
            return name in sched._by_name or name in sched.report
        if name in sched.report:
            return True
        jk = f"{sched.leases.prefix}/{name}"
        if self.kv.get(jk) is not None:
            return True
        return self.kv.get(
            f"{sched.leases.prefix}/done/{name}") is not None

    def _watch_owned(self, census) -> None:
        """Renew every admission lease still covering an in-flight
        admission; FINALIZE (terminal done marker, spool archive,
        journal GC, lease release) once the fleet shows durable
        evidence of the job."""
        for name, err in self.leases.renew_owned(census=census):
            # a reclaimer fenced us while paused: it owns the
            # re-admission; ours stays only in OUR scheduler, whose
            # job-level lease fencing arbitrates serving
            logger.warning("intake: admission lease on %s fenced: %s",
                           name, err)
            self._meta.pop(name, None)
        for name in sorted(self.leases.owned):
            if not self._fleet_evidence(name):
                continue
            self.kv.create(self._done_key(name),
                           f"admitted:{self.rank}")
            self.kv.delete(self._journal_key(name))
            self.leases.release(name)
            self._archive(name)
            self._seen.pop(name, None)
            self._meta.pop(name, None)

    # -- backpressure gate + graceful shed ----------------------------

    def _rates_update(self, now: float) -> None:
        if self._last_pump_t is None:
            self._last_pump_t = now
            return
        dt = now - self._last_pump_t
        if dt <= 0:
            return
        self._last_pump_t = now
        self.arrival.update(self._arrived_since, dt)
        self._arrived_since = 0
        done = len(self.sched.report) if self.sched is not None else 0
        self.drain.update(max(0, done - self._done_seen), dt)
        self._done_seen = done

    def _gate_inputs(self, now: float) -> dict:
        arr = self.arrival.value
        drn = self.drain.value
        ratio = (None if arr is None or not drn
                 else round(arr / drn, 6))
        return {
            "ratio": ratio,
            "arrival_per_s": (None if arr is None else round(arr, 6)),
            "drain_per_s": (None if drn is None else round(drn, 6)),
            "queue_age_s": round(self.oldest_age(now), 6),
            "backlog": self.backlog(),
            "hi": self.hi_ratio, "lo": self.lo_ratio,
            "age_bound_s": self.age_bound_s,
        }

    def _gate_tick(self, now: float) -> None:
        """Evaluate the gate once per EWMA window (<= 1 transition
        per window by construction) through the shared pure rule —
        journaled via the autopilot when one is attached."""
        if (self._gate_eval_t is not None
                and now - self._gate_eval_t < self.window_s):
            return
        self._gate_eval_t = now
        inputs = self._gate_inputs(now)
        if self.autopilot is not None:
            new = self.autopilot.record_intake_gate(inputs)
        else:
            d = autopilot_mod.RULES["intake.backpressure"](
                self.gate, inputs)
            new = self.gate if d is None else d
        if new != self.gate:
            self.gate_transitions += 1
            logger.warning("intake: backpressure gate %s (%s)",
                           "CLOSED" if new else "OPEN", inputs)
        self.gate = new
        telemetry.set_gauge("dccrg_intake_gate", self.gate)
        if self.gate:
            self._maybe_shed(now, inputs)

    def _weight(self, tenant: str) -> float:
        w = self.weights or {}
        try:
            return max(1e-6, float(w.get(tenant, w.get("*", 1.0))))
        except (TypeError, ValueError):
            return 1.0

    def _maybe_shed(self, now: float, inputs: dict) -> None:
        """Graceful shed under saturation: when even full drain
        cannot bound the queue age (``backlog / drain > bound``),
        move the NEWEST waiting records of the most-backlogged tenant
        to ``spool/shed/`` — journaled, re-submittable — until the
        projected age is back in bounds."""
        drn = self.drain.value
        if not drn or drn <= 0 or not self._waiting:
            return
        excess = len(self._waiting) - int(drn * self.age_bound_s)
        if excess <= 0:
            return
        by_tenant: dict = {}
        loadable = []
        for name, path in self._waiting:
            try:
                payload = self._load(name, path)
            except Exception:  # noqa: BLE001 - retry path handles it
                continue
            tenant = str(payload.get("tenant", "default"))
            by_tenant.setdefault(tenant, []).append((name, path))
            loadable.append((name, tenant))
        if not by_tenant:
            return
        # the most over-fair-share tenant pays first (backlog scaled
        # by 1/weight), its NEWEST records first (oldest keep their
        # FIFO claim on the reopened gate)
        tenant = max(sorted(by_tenant),
                     key=lambda t: len(by_tenant[t]) / self._weight(t))
        victims = by_tenant[tenant][-excess:]
        sdir = os.path.join(self.spool, SHED_DIR)
        shed_names = []
        for name, path in victims:
            try:
                os.replace(path, os.path.join(sdir, f"{name}.json"))
            except OSError:
                continue
            shed_names.append(name)
            self._seen.pop(name, None)
            self._retry.pop(name, None)
            telemetry.inc("dccrg_intake_shed_total", tenant=tenant)
        if not shed_names:
            return
        self.shed += len(shed_names)
        if self.autopilot is not None:
            self.autopilot.record_intake_shed(
                shed_names, tenant,
                {"backlog": inputs.get("backlog"),
                 "drain_per_s": inputs.get("drain_per_s"),
                 "age_bound_s": self.age_bound_s})
        logger.warning("intake: shed %d record(s) of tenant %s under "
                       "saturation: %s", len(shed_names), tenant,
                       shed_names)

    # -- tenant-fair admission ----------------------------------------

    def _admissible(self, now: float) -> list:
        """The waiting records eligible this pump, ordered by
        weighted virtual-time fairness across tenants (FIFO within a
        tenant), with token buckets enforced at pick time."""
        rows = []
        for name, path in self._waiting:
            st = self._retry.get(name)
            if st is not None and now < st.next_t:
                continue
            rows.append((name, path))
        return rows

    def _bucket(self, tenant: str, now: float):
        if self.rates is None:
            return None
        b = self._buckets.get(tenant)
        if b is None:
            rate = self.rates.get(tenant, self.rates.get("*"))
            if rate is None:
                return None
            b = self._buckets[tenant] = _TokenBucket(
                rate, self.burst, now)
        return b

    def _admit_some(self, now: float) -> int:
        """Admit up to ``max_admit`` records this pump: load each
        eligible record ONCE under the retry envelope, group by
        tenant, then repeatedly pick the tenant with the lowest
        weighted virtual time, spend its token, admit its oldest
        record."""
        rows = self._admissible(now)
        if not rows:
            return 0
        by_tenant: dict = {}
        for name, path in rows:
            if name in self.leases.owned:
                continue  # re-admitted by this pump's reclaim pass
            try:
                payload = self._load(name, path)
            except PERMANENT_FAULTS as e:
                st = self._retry.get(name)
                self._quarantine(name, path, e,
                                 (st.attempts if st else 0) + 1)
                continue
            except (OSError, coord.TornRecordError) as e:
                self._transient_failed(name, path, e, now)
                continue
            tenant = str(payload.get("tenant", "default"))
            by_tenant.setdefault(tenant, []).append(
                (name, path, payload))
        admitted = 0
        throttled = set()
        while admitted < self.max_admit and by_tenant:
            pick = min(sorted(t for t in by_tenant
                              if t not in throttled),
                       key=lambda t: self._vtime.get(t, 0.0),
                       default=None)
            if pick is None:
                break
            b = self._bucket(pick, now)
            if b is not None and not b.take(now):
                throttled.add(pick)
                telemetry.inc("dccrg_intake_throttled_total",
                              tenant=pick)
                continue
            name, path, payload = by_tenant[pick].pop(0)
            if not by_tenant[pick]:
                del by_tenant[pick]
            verdict = self._try_admit(name, path, payload, now)
            if verdict == "admitted":
                admitted += 1
            elif b is not None:
                b.tokens = min(b.burst, b.tokens + 1.0)  # not spent
        return admitted

    # -- the pump ------------------------------------------------------

    def pump(self) -> dict:
        """One intake pass (called from the scheduler's tick loop or
        driven directly by tests/bench): scan the spool, refresh the
        rate EWMAs, recover crashed admissions, finalize completed
        ones, evaluate the backpressure gate, and — gate open —
        admit a fair batch. Returns a stats snapshot."""
        now = float(self.clock())
        with telemetry.span("intake.pump"):
            self._scan(now)
            self._rates_update(now)
            census = coord.prefix_census(self.kv, PREFIX)
            self._watch_owned(census)
            self._reclaim_pass(census, now)
            self._gate_tick(now)
            n = 0
            if not self.gate:
                n = self._admit_some(now)
                if n:
                    self._scan(now)  # admitted names leave _waiting
        telemetry.set_gauge("dccrg_intake_lag", self.backlog())
        return {
            "admitted": n, "backlog": self.backlog(),
            "gate": self.gate,
            "gate_transitions": self.gate_transitions,
            "quarantined": self.quarantined, "shed": self.shed,
            "deduped": self.deduped, "reclaimed": self.reclaimed,
        }
