"""Fleet autopilot: telemetry-driven self-tuning with an explainable
decision journal.

Port of ``dccrg_tpu/autopilot.py``, host arithmetic as there. The
serving layers carry a dozen hand-set knobs (``DCCRG_FLEET_QUANTUM``,
``bucket_capacity``, per-job ``checkpoint_every``,
``DCCRG_AUDIT_EVERY``, ...), and the telemetry layer measures what they
cost (per-bucket quantum-latency EWMAs, trip, rollback and audit
counters, save-cost histograms). This module closes the loop: a
**deterministic controller** wired into
:class:`~dccrg_tpu_torch.scheduler.FleetScheduler` that tunes, within
hard bounds, from nothing but recorded observations:

- **quantum length** against measured SLO slack (long quanta spread the
  per-quantum host work, short quanta bound preemption and rollback
  loss), with a journal-driven cross-run warm start (``quantum.learn``
  at a clean drain, ``quantum.warm_start`` at the next run's first
  tick);
- **per-stem checkpoint cadence** from measured save cost and observed
  trip rate (Young's ``sqrt(2 * save_cost / trip_rate)`` in step
  units), with Daly's ``R`` term from the measured
  ``dccrg_rollback_seconds`` once a rollback was observed;
- **audit cadence** up while a device lane's suspect counter is warm
  and back to the configured baseline after a clean streak;
- **initial bucket capacity** seeded from the recorded OOM/shed
  history instead of rediscovered by halving every run (the journal is
  the cross-run memory).

Every decision is a **structured record** (observed inputs, rule fired,
action taken, expected effect) in a bounded in-memory ring and an
append-only JSONL journal (``DCCRG_DECISION_FILE``, rank-tagged and
mergeable across ranks like the telemetry traces), in the reference's
format: a journal written by either package replays in the other.
``python -m dccrg_tpu_torch.autopilot explain`` renders every decision
from the journal alone, and ``replay`` re-derives each action by
feeding the recorded inputs back through the same pure rule functions
the live controller used; any divergence is a bug (journal corruption,
nondeterminism, or a rule edit that changed behaviour). A periodic
status snapshot (``DCCRG_STATUS_FILE``) shows the per-bucket latency
EWMAs, live knob values, suspect counters and SLO slack.

Deterministic by construction: the clock is injectable, every rule is
a pure function of ``(current value, recorded inputs)`` (thresholds and
hard bounds travel inside the recorded inputs, so replay needs nothing
but the journal), and the controller's own state (streaks, windowed
rates) reaches the rules only through those inputs.

Off by default: without ``DCCRG_AUTOPILOT=1`` the scheduler never
constructs a controller, and scheduling, checkpoint cadence and audit
cadence are those of a scheduler without one. With it on, the
controller is host arithmetic per scheduler tick: no device work, no
extra launches.
"""

from __future__ import annotations

import collections
import hashlib
import json
import math
import os
import time

from . import telemetry

logger = __import__("logging").getLogger("dccrg_tpu_torch.autopilot")


# ---------------------------------------------------------------------
# env knobs
# ---------------------------------------------------------------------

def autopilot_enabled(default: bool = False) -> bool:
    """The ``DCCRG_AUTOPILOT`` env knob: ``1`` lets the fleet
    scheduler construct and run the self-tuning controller. Unset
    (default): no controller object exists and every knob keeps its
    configured value — the negative pin."""
    v = os.environ.get("DCCRG_AUTOPILOT", "")
    if v == "":
        return default
    return v not in ("0", "off", "false", "no")


def decision_file_default():
    """The ``DCCRG_DECISION_FILE`` env knob: JSONL journal every
    decision record is appended to (best-effort, like every telemetry
    exporter). A literal ``{rank}`` is substituted with the coord rank
    id; per-rank files merge like traces (records carry the rank)."""
    return os.environ.get("DCCRG_DECISION_FILE") or None


def status_file_default():
    """The ``DCCRG_STATUS_FILE`` env knob: where the periodic
    human-readable status snapshot is (re)written."""
    return os.environ.get("DCCRG_STATUS_FILE") or None


def decision_ring_default(default: int = 4096) -> int:
    """The ``DCCRG_DECISION_RING`` env knob: how many decision records
    the in-memory ring holds (the journal file is unbounded)."""
    try:
        return max(16, int(os.environ.get("DCCRG_DECISION_RING", "")
                           or default))
    except ValueError:
        return default


# ---------------------------------------------------------------------
# the rules: pure functions of (current value, recorded inputs)
# ---------------------------------------------------------------------
#
# Every rule takes the knob's current value and the inputs dict that
# was (or will be) recorded in the decision journal, and returns the
# new value — or None when the rule does not fire on those inputs.
# Thresholds, streaks and hard bounds are all INSIDE the inputs, so
# `replay` can re-derive the action from the journal alone. Rules
# must be deterministic and JSON-faithful (inputs survive a
# json round-trip unchanged).

def _rule_quantum_shorten(before, inp):
    """Negative SLO slack or a warm trip rate: halve the quantum —
    shorter quanta bound preemption/rollback loss and tighten the
    watchdog/checkpoint poll cadence."""
    slack = inp.get("slo_slack_min_s")
    violating = slack is not None and slack < 0.0
    tripping = inp.get("trip_rate", 0.0) > inp.get("trip_warm", 0.02)
    if not (violating or tripping):
        return None
    if inp.get("streak", 1) < inp.get("patience", 1):
        return None
    new = max(int(inp.get("lo", 1)), int(before) // 2)
    return new if new != int(before) else None


def _rule_quantum_lengthen(before, inp):
    """Comfortable slack (or no SLO jobs at all) and a cool trip
    rate, sustained: double the quantum — long quanta amortize
    per-dispatch overhead across more steps."""
    lat = inp.get("quantum_latency_s")
    if lat is None:
        return None  # never lengthen blind: no measured dispatch yet
    if inp.get("trip_rate", 0.0) > inp.get("trip_cool", 0.005):
        return None
    slack = inp.get("slo_slack_min_s")
    if slack is not None and slack < inp.get("slack_factor", 8.0) * lat:
        return None
    if inp.get("streak", 1) < inp.get("patience", 1):
        return None
    new = min(int(inp.get("hi", 64)), int(before) * 2)
    return new if new != int(before) else None


def _rule_ckpt_retune(before, inp):
    """Young/Daly first-order optimal checkpoint interval from
    measured save cost x observed trip rate, in step units. With the
    measured per-trip recovery cost (``rollback_s`` — the chain-aware
    checkpoint load the ``dccrg_rollback_seconds`` histogram times)
    the optimum is Daly's ``sqrt(2 * C * (M + R))`` with ``C =
    save_cost_s/step_seconds``, ``M = 1/trip_rate`` and ``R =
    rollback_s/step_seconds``; without it (no rollback observed yet)
    it degrades to Young's ``sqrt(2 * C / trip_rate)`` exactly. A
    trip-free history pushes the cadence to the upper bound (saves
    cost, trips don't); a deadband suppresses churn."""
    sc = inp.get("save_cost_s")
    st = inp.get("step_seconds")
    if sc is None or st is None or sc <= 0.0 or st <= 0.0:
        return None
    rate = inp.get("trip_rate", 0.0)
    if rate <= 0.0:
        opt = float(inp.get("hi", 256))
    else:
        mtbf_steps = 1.0 / rate
        rb = inp.get("rollback_s")
        if rb is not None and rb > 0.0:
            mtbf_steps += rb / st
        opt = math.sqrt(2.0 * (sc / st) * mtbf_steps)
    new = max(int(inp.get("lo", 1)),
              min(int(inp.get("hi", 256)), int(round(opt))))
    before = int(before)
    if abs(new - before) < max(1, int(before
                                      * inp.get("deadband", 0.25))):
        return None
    return new


def _rule_audit_tighten(before, inp):
    """Fresh suspect verdicts on a device lane: audit more often —
    halve the cadence (or switch audits ON at ``warm_start`` when the
    baseline keeps them off)."""
    if inp.get("new_suspects", 0) <= 0:
        return None
    before = int(before)
    new = (int(inp.get("warm_start", 8)) if before <= 0
           else max(1, before // 2))
    new = min(new, int(inp.get("hi", 16))) if new > 0 else new
    return new if new != before else None


def _rule_audit_relax(before, inp):
    """A sustained clean streak: walk the audit cadence back toward
    the configured baseline (doubling; a zero baseline switches
    audits back off once the cadence passes the envelope top)."""
    if inp.get("clean_streak", 0) < inp.get("relax_after", 8):
        return None
    base = int(inp.get("baseline", 0))
    before = int(before)
    if before == base or before <= 0:
        return None
    new = before * 2
    if base > 0:
        new = min(new, base)
    if new > int(inp.get("hi", 16)):
        new = 0 if base <= 0 else int(inp.get("hi", 16))
    return new if new != before else None


def _rule_capacity_learn(before, inp):
    """An OOM/shed rebuild survived at ``observed_capacity`` slots:
    remember the smallest capacity that has ever had to be halved to
    for this bucket key."""
    obs = int(inp["observed_capacity"])
    if before is None:
        return obs
    new = min(int(before), obs)
    return new if new != int(before) else None


def _rule_capacity_seed(before, inp):
    """A new bucket for a key with recorded OOM/shed history: start
    at the learned surviving capacity instead of rediscovering it by
    halving."""
    learned = inp.get("learned_capacity")
    if learned is None:
        return None
    new = max(int(inp.get("lo", 1)), min(int(before), int(learned)))
    return new if new != int(before) else None


def _rule_quantum_learn(before, inp):
    """The run drained cleanly: journal the converged quantum as
    cross-run memory (the ``capacity.learn`` discipline for the
    QUANTUM knob — the journal record IS the memory,
    ``load_history`` replays it). Fires only when the final value
    differs from what the next run would otherwise start at (the
    previously learned value, else the configured default)."""
    final = inp.get("final_quantum")
    if final is None:
        return None
    final = int(final)
    base = before if before is not None else inp.get("configured")
    if base is not None and int(base) == final:
        return None
    return final


def _rule_quantum_warm_start(before, inp):
    """A prior run journaled its converged quantum for this
    scheduler: start there (clamped to the hard envelope) instead of
    re-converging from the configured default — the ``capacity.seed``
    mirror."""
    learned = inp.get("learned_quantum")
    if learned is None:
        return None
    new = max(int(inp.get("lo", 1)),
              min(int(inp.get("hi", 64)), int(learned)))
    return new if new != int(before) else None


def _rule_capacity_probe(before, inp):
    """A run that completed with NO OOM/shed on a seeded bucket key:
    double the learned capacity back toward the configured default —
    the learned floor is a recoverable observation, not a permanent
    ratchet (one transient co-tenant spike must not pin a key's
    throughput down forever)."""
    if not inp.get("clean_run"):
        return None
    new = int(before) * 2
    cap = inp.get("default_capacity")
    if cap is not None:
        new = min(new, int(cap))
    return new if new != int(before) else None


def _rule_shed_cooldown(before, inp):
    """Retune the SLO-shed cooldown from observed shed churn: a fresh
    shed doubles the cooldown (every shed rebuild costs a compile and
    resets the EWMA — back-to-back sheds are the feedback loop the
    cooldown exists to damp), and a sustained clean streak halves it
    back toward the configured baseline (a calm fleet earns its
    responsiveness back)."""
    before = int(before)
    lo = max(1, int(inp.get("lo", 1)))
    hi = int(inp.get("hi", 64))
    if inp.get("new_sheds", 0) > 0:
        new = min(hi, max(lo, before * 2))
    elif (inp.get("shed_clean_streak", 0) >= inp.get("relax_after", 8)
          and before > max(lo, int(inp.get("baseline", lo)))):
        new = min(hi, max(lo, int(inp.get("baseline", lo)),
                          before // 2))
    else:
        return None
    return new if new != before else None


def _rule_retry_budget(before, inp):
    """Retune a job's trip-retry budget from ITS OWN trip history: a
    job burning consecutive retries at the same step (a deterministic
    blow-up the rollback cannot outrun) fails faster — each replay of
    the doomed window is pure wasted wall — while a job whose trips
    RECOVER (progress after every rollback, no same-step churn) earns
    headroom for the next transient upset."""
    before = int(before)
    lo = max(1, int(inp.get("lo", 1)))
    hi = int(inp.get("hi", 8))
    repeat = int(inp.get("repeat_trips", 0))
    recovered = int(inp.get("recovered", 0))
    if repeat >= 2:
        new = max(lo, min(hi, before - 1))
    elif recovered > 0 and repeat == 0:
        new = min(hi, max(lo, before + 1))
    else:
        return None
    return new if new != before else None


def _rule_intake_gate(before, inp):
    """The streaming-intake backpressure gate with hysteresis: the
    gate CLOSES (1) when the arrival/drain EWMA ratio crosses ``hi``
    or the oldest waiting record's age exceeds ``age_bound_s``, and
    only REOPENS (0) once the ratio has fallen below the strictly
    lower ``lo`` with the queue age back in bounds — the hysteresis
    band (plus the caller's per-EWMA-window evaluation cadence) is
    what keeps the gate from flapping at the saturation boundary.
    Thresholds travel inside the recorded inputs so replay is
    self-contained."""
    state = 1 if before else 0
    ratio = inp.get("ratio")
    age = float(inp.get("queue_age_s", 0.0))
    hi = float(inp.get("hi", 1.2))
    lo = float(inp.get("lo", 0.9))
    bound = float(inp.get("age_bound_s", 30.0))
    over = (ratio is not None and float(ratio) >= hi) or age > bound
    calm = (ratio is None or float(ratio) <= lo) and age <= bound
    if state == 0 and over:
        return 1
    if state == 1 and calm:
        return 0
    return None


def _rule_intake_shed(before, inp):
    """Narrate a journaled graceful shed under intake saturation:
    ``n`` waiting spool records were moved aside because the backlog
    implied an unbounded queue age (``backlog / drain`` beyond the
    bound). The 'knob' is the cumulative shed count — the record
    exists so ``explain`` reconstructs WHAT was shed, from WHICH
    tenant and under WHICH saturation numbers from the journal
    alone."""
    n = int(inp.get("n", 0))
    if n <= 0:
        return None
    return int(before) + n


def _rule_intake_quarantine(before, inp):
    """Narrate a poison-job quarantine: a spool record whose
    admission failed ``attempts`` times (or failed permanently —
    torn frame, malformed spec, unknown kernel) moved to
    ``spool/quarantine/`` with a structured reason instead of
    wedging the stream. The 'knob' is the cumulative quarantine
    count."""
    if not inp.get("name"):
        return None
    return int(before) + 1


def _rule_fleet_reclaim(before, inp):
    """Narrate an elastic-fleet job reclaim in the decision journal:
    ``n`` jobs of a dead rank were taken over (lease expired, epoch
    fence bumped). The 'knob' is the cumulative reclaim count — the
    record exists so ``explain`` reconstructs WHO died, WHAT was
    reclaimed and under WHICH lease bound from the journal alone."""
    n = int(inp.get("n", 0))
    if n <= 0:
        return None
    return int(before) + n


def _rule_warm_cache(before, inp):
    """Narrate one warm-start cache decision: a bucket program was
    served ``warm`` (pre-compiled ahead of the dispatch), compiled
    ``cold`` (first dispatch carried the compile), ``reject``-ed (a
    persisted artifact could not be trusted — epoch drift, registry
    drift, I/O failure — and fell cold) or ``quarantine``-d (a torn
    or corrupt manifest record moved aside). The 'knob' is the
    cumulative decision count — the record exists so ``explain``
    reconstructs every warm claim and every degradation from the
    journal alone."""
    if inp.get("decision") not in ("warm", "cold", "reject",
                                  "quarantine"):
        return None
    return int(before) + 1


def _rule_warm_gc(before, inp):
    """Narrate an applied warm-cache retention GC: ``n`` files
    pruned (least-recently-hit first) under the configured size/age
    bounds. The 'knob' is the cumulative pruned count."""
    n = int(inp.get("n", 0))
    if n <= 0:
        return None
    return int(before) + n


#: rule name -> pure derivation. `replay` and the live controller
#: share these by construction — one source of truth.
RULES = {
    "quantum.shorten": _rule_quantum_shorten,
    "quantum.lengthen": _rule_quantum_lengthen,
    "quantum.learn": _rule_quantum_learn,
    "quantum.warm_start": _rule_quantum_warm_start,
    "checkpoint.retune": _rule_ckpt_retune,
    "audit.tighten": _rule_audit_tighten,
    "audit.relax": _rule_audit_relax,
    "capacity.learn": _rule_capacity_learn,
    "capacity.seed": _rule_capacity_seed,
    "capacity.probe": _rule_capacity_probe,
    "shed.cooldown": _rule_shed_cooldown,
    "retry.budget": _rule_retry_budget,
    "fleet.reclaim": _rule_fleet_reclaim,
    "intake.backpressure": _rule_intake_gate,
    "intake.shed": _rule_intake_shed,
    "intake.quarantine": _rule_intake_quarantine,
    "warmstart.cache": _rule_warm_cache,
    "warmstart.gc": _rule_warm_gc,
}

#: the "expected effect" text journaled with each rule's decisions
EXPECTED = {
    "quantum.shorten": ("shorter quanta bound preemption/rollback "
                        "loss and tighten the poll cadence"),
    "quantum.lengthen": ("longer quanta amortize per-dispatch "
                         "overhead across more steps"),
    "quantum.learn": ("remember the converged quantum so the next "
                      "run starts there instead of re-converging"),
    "quantum.warm_start": ("start at the quantum a prior run "
                           "converged to (journal-driven cross-run "
                           "warm start)"),
    "checkpoint.retune": ("save cost x trip rate optimum (Young): "
                          "minimize save overhead + expected replay"),
    "audit.tighten": ("audit a warm-suspect fleet more often so a "
                      "defective lane convicts sooner"),
    "audit.relax": ("a clean streak earns the baseline audit cost "
                    "back"),
    "capacity.learn": ("remember the bucket capacity that survived "
                       "the OOM/shed so future runs start there"),
    "capacity.seed": ("start at the capacity that survived the "
                      "recorded OOM/shed history instead of "
                      "rediscovering it by halving"),
    "capacity.probe": ("a clean run earns the seeded key headroom "
                       "back toward the configured default — the "
                       "learned floor decays instead of ratcheting"),
    "shed.cooldown": ("damp shed churn: back-to-back shed rebuilds "
                      "cost a compile each and re-poison the fresh "
                      "EWMA; a calm fleet earns responsiveness back"),
    "retry.budget": ("fail deterministic blow-ups faster, grant "
                     "recovering jobs headroom for the next "
                     "transient upset"),
    "fleet.reclaim": ("a dead rank's jobs were reclaimed by lease "
                      "expiry and re-admitted from their checkpoint "
                      "stems on this rank"),
    "intake.backpressure": ("hysteresis gate on spool admission: "
                            "arrivals outrunning drain (or an aged "
                            "queue) pause new admissions until the "
                            "stream calms — the spool is the durable "
                            "buffer, queue age stays bounded"),
    "intake.shed": ("graceful shed under saturation: the backlog "
                    "implied an unbounded queue age, so the newest "
                    "records of the most-backlogged tenant moved "
                    "aside (journaled, re-submittable) instead of "
                    "aging forever behind a closed gate"),
    "intake.quarantine": ("poison-job quarantine: a record that "
                          "cannot admit (K retries exhausted or a "
                          "permanent spec fault) moved to "
                          "spool/quarantine/ with a structured "
                          "reason so the stream keeps draining "
                          "behind it"),
    "warmstart.cache": ("persistent compile cache decision: warm "
                        "serves skip the compile storm, cold/reject/"
                        "quarantine degradations never trust a "
                        "drifted or damaged artifact — no wrong "
                        "program, no silent warm claim"),
    "warmstart.gc": ("size/age-bounded cache retention: prune "
                     "least-recently-hit entries so the cache dir "
                     "stays bounded without touching keys being "
                     "pre-warmed"),
}


def key_id(bucket_key) -> str:
    """A short stable id for a fleet bucket key (callable kernels are
    normalized to their qualname so the id survives process restarts,
    the journal being cross-run memory; a torch dtype to its name, the
    reference's spelling, so a key of either package has one id)."""
    import sys

    torch = sys.modules.get("torch")

    def norm(x):
        if isinstance(x, tuple):
            return tuple(norm(e) for e in x)
        if torch is not None and isinstance(x, torch.dtype):
            return str(x).replace("torch.", "")
        if callable(x):
            return getattr(x, "__qualname__", repr(x))
        return x
    return hashlib.sha1(repr(norm(bucket_key)).encode()).hexdigest()[:12]


# ---------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------

class Autopilot:
    """The deterministic self-tuning controller (see module
    docstring). One instance per :class:`~dccrg_tpu_torch.scheduler
    .FleetScheduler`; the scheduler calls :meth:`tick` at every tick
    boundary, :meth:`seed_capacity` when creating a bucket and
    :meth:`record_oom` / :meth:`record_shed` after shrink rebuilds.

    ``clock`` is injectable (the pinned tests drive a fake clock);
    everything else the controller consumes comes from the telemetry
    registry and the scheduler's own counters, and every value a
    decision depended on is recorded IN the decision.

    ``quantum``/``audit_every`` declare the BASELINES the hard
    envelopes and the audit relax target derive from — pass the
    scheduler's configured values (the ``DCCRG_AUTOPILOT`` env path
    does). The scheduler's LIVE knob values stay the source of
    truth: each tick adopts them and only a journaled rule firing
    ever writes them back."""

    def __init__(self, *, quantum=8, audit_every=0,
                 clock=time.monotonic, decision_file=None,
                 status_file=None, ring=None, ckpt_bounds=(1, 256),
                 trip_warm=0.02, trip_cool=0.005, slack_factor=8.0,
                 shorten_patience=1, lengthen_patience=4,
                 relax_after=8, adjust_every=4, status_every=1,
                 load_history=True):
        self.clock = clock
        self.quantum = max(1, int(quantum))
        self.quantum0 = self.quantum
        self.audit_every = max(0, int(audit_every))
        self.audit0 = self.audit_every
        #: the hard envelopes no decision may leave (the property
        #: test's oracle; each rule also receives its lo/hi INSIDE
        #: the recorded inputs so replay is self-contained)
        self.bounds = {
            "quantum": (1, max(8 * self.quantum0, self.quantum0)),
            "checkpoint_every": (max(1, int(ckpt_bounds[0])),
                                 max(1, int(ckpt_bounds[1]))),
            "audit_every": (0, max(16, self.audit0)),
            "shed_cooldown": (1, 64),
            "max_retries": (1, 8),
        }
        self.trip_warm = float(trip_warm)
        self.trip_cool = float(trip_cool)
        self.slack_factor = float(slack_factor)
        self.shorten_patience = max(1, int(shorten_patience))
        self.lengthen_patience = max(1, int(lengthen_patience))
        self.relax_after = max(1, int(relax_after))
        self.adjust_every = max(1, int(adjust_every))
        self.status_every = max(1, int(status_every))
        self._decision_file = (decision_file_default()
                               if decision_file is None
                               else str(decision_file))
        self._status_file = (status_file_default() if status_file is None
                             else str(status_file))
        self.decisions = collections.deque(
            maxlen=decision_ring_default() if ring is None
            else max(16, int(ring)))
        self.seq = 0
        self._tick = 0
        # learned safe bucket capacities: key_id -> slots. NOT a
        # permanent ratchet: end_of_run() probes seeded keys that
        # survived a clean run back up toward the default
        self.capacity: dict = {}
        self._seeded: set = set()   # keys the learned floor bound
        self._shrunk: set = set()   # keys that OOMed/shed this run
        self._default_seen: dict = {}  # key_id -> configured default
        # windowed observation state feeding the rules. The registry
        # is process-global: baseline the counters/histograms we
        # difference at CONSTRUCTION time, so a controller attached
        # to a fresh scheduler never inherits an earlier run's trips
        # or save costs as a phantom first-tick observation.
        self._last_steps = 0  # sched.steps_total is per-scheduler
        self._last_trips = float(telemetry.registry().counter_total(
            "dccrg_fleet_trips_total"))
        self._save_cost_base = self._save_cost_totals()
        self._rollback_base = self._rollback_totals()
        self._last_suspects = 0
        # shed-churn observation state (the shed.cooldown rule) — the
        # counter is process-global, so baseline at construction like
        # the trip/save-cost series
        self._last_sheds = float(telemetry.registry().counter_total(
            "dccrg_fleet_slo_sheds_total"))
        self._shed_clean = 0
        self._shed0 = None  # the configured cooldown, from first sight
        # per-job trip-history watermarks (the retry.budget rule
        # re-evaluates a job only when its trip count moved)
        self._retry_seen: dict = {}
        #: cumulative elastic-fleet reclaims narrated in the journal
        self.reclaims = 0
        #: streaming-intake control state narrated in the journal:
        #: the backpressure gate (0 = open, 1 = closed) plus the
        #: cumulative shed / quarantine counts
        self.intake_gate = 0
        self.intake_sheds = 0
        self.intake_quarantines = 0
        #: warm-start narration state: cumulative cache decisions
        #: (warm/cold/reject/quarantine) and cumulative GC prunes
        self.warm_events = 0
        self.warm_gcs = 0
        # journal-driven cross-run warm start of the QUANTUM knob
        # (the capacity.learn/probe discipline): load_history recovers
        # the last run's journaled quantum.learn, the first tick
        # applies it through the quantum.warm_start rule
        self.learned_quantum = None
        self._warmed = False
        self._trip_rate = 0.0
        self._clean = 0
        self._q_short = 0
        self._q_long = 0
        if load_history and self._decision_file is not None:
            self.load_history(self._resolved(self._decision_file))

    # -- journal ------------------------------------------------------

    @staticmethod
    def _resolved(path: str) -> str:
        return path.replace("{rank}", str(telemetry._rank()))

    def load_history(self, path: str) -> int:
        """Recover the persistent half of the controller state — the
        per-bucket-key learned capacities and the learned QUANTUM —
        from a prior run's journal, replaying the
        ``capacity.learn``/``capacity.probe``/``quantum.learn``
        records in order (shrinks AND clean-run recoveries both
        apply — the history is not a one-way ratchet). Returns how
        many records informed it. Missing/unreadable files are
        simply no history."""
        n = 0
        for rec in read_journal(path):
            after = rec.get("after")
            if rec.get("rule") == "quantum.learn":
                if isinstance(after, int) and after >= 1:
                    self.learned_quantum = after
                    n += 1
                continue
            if rec.get("rule") not in ("capacity.learn",
                                       "capacity.probe"):
                continue
            knob = rec.get("knob", "")
            if not (knob.startswith("capacity[") and knob.endswith("]")):
                continue
            kid = knob[len("capacity["):-1]
            if not isinstance(after, int) or after < 1:
                continue
            self.capacity[kid] = after
            n += 1
        if n:
            logger.info(
                "autopilot recovered %d capacity record(s) from %s",
                n, path)
        return n

    def _apply(self, rule: str, knob: str, before, inputs: dict):
        """Run ``rule`` on ``(before, inputs)``; when it fires, record
        the decision (ring + journal + metrics) and return the new
        value, else return ``before`` unchanged."""
        after = RULES[rule](before, inputs)
        if after is None:
            return before
        rec = {
            "seq": self.seq,
            "tick": self._tick,
            "ts": time.time(),
            "t": round(float(self.clock()), 6),
            "rank": telemetry._rank(),
            "rule": rule,
            "knob": knob,
            "before": before,
            "after": after,
            "inputs": inputs,
            "expected": EXPECTED.get(rule, ""),
        }
        self.seq += 1
        self.decisions.append(rec)
        telemetry.inc("dccrg_autopilot_decisions_total", rule=rule)
        path = self._decision_file
        if path is not None:
            telemetry._best_effort_write(
                self._resolved(path),
                json.dumps(rec, sort_keys=True) + "\n", append=True)
        logger.info("autopilot %s: %s %s -> %s (%s)", rule, knob,
                    before, after, rec["expected"])
        return after

    # -- observation gathering ----------------------------------------

    @staticmethod
    def _save_cost_totals():
        """``(sum_seconds, count)`` over the periodic save-cost
        histogram series (``dccrg_ckpt_save_seconds`` kinds keyframe/
        delta; the ``emergency`` kind is a deadline-bounded preempt
        save and must not price the periodic cadence)."""
        tot, n = 0.0, 0
        for (nm, lab), h in telemetry.registry().histograms.items():
            if nm != "dccrg_ckpt_save_seconds" \
                    or ("kind", "emergency") in lab:
                continue
            tot += h.sum_seconds
            n += h.total
        return tot, n

    def _save_cost_mean(self):
        """Mean periodic save cost observed SINCE this controller was
        constructed (the registry outlives schedulers), or None when
        nothing was recorded yet."""
        tot, n = self._save_cost_totals()
        tot -= self._save_cost_base[0]
        n -= self._save_cost_base[1]
        return (tot / n) if n > 0 else None

    @staticmethod
    def _rollback_totals():
        """``(sum_seconds, count)`` over every ``dccrg_rollback_
        seconds`` series (the runner's chain-aware checkpoint load and
        the fleet's per-slot restore both observe it)."""
        tot, n = 0.0, 0
        for (nm, _lab), h in telemetry.registry().histograms.items():
            if nm != "dccrg_rollback_seconds":
                continue
            tot += h.sum_seconds
            n += h.total
        return tot, n

    def _rollback_cost_mean(self):
        """Mean measured per-trip recovery cost since construction,
        or None before the first observed rollback — the
        ``checkpoint.retune`` rule's Daly ``R`` term (replay was
        previously priced via save cost only)."""
        tot, n = self._rollback_totals()
        tot -= self._rollback_base[0]
        n -= self._rollback_base[1]
        return (tot / n) if n > 0 else None

    def gather(self, sched) -> dict:
        """One tick's controller inputs, computed from the scheduler's
        state and the telemetry registry. Every value is a JSON
        primitive — the decision journal must round-trip them
        exactly."""
        active = sched.active_jobs()
        slacks = [s for s in (sched.slo.slack_s(j)
                              for _b, _s, j in active) if s is not None]
        slack_min = min(slacks) if slacks else None
        lats = list(sched.slo._ewma.values())
        lat = max(lats) if lats else None
        trips = float(telemetry.registry().counter_total(
            "dccrg_fleet_trips_total"))
        steps = int(getattr(sched, "steps_total", 0))
        d_steps = steps - self._last_steps
        d_trips = trips - self._last_trips
        if d_steps > 0:
            # EWMA of the per-step trip rate over the tick window
            self._trip_rate = (0.7 * self._trip_rate
                               + 0.3 * (d_trips / d_steps))
        self._last_steps, self._last_trips = steps, trips
        suspects = int(sum(sched.suspects))
        new_susp = suspects - self._last_suspects
        self._last_suspects = suspects
        if new_susp > 0:
            self._clean = 0
        else:
            self._clean += 1
        sheds = float(telemetry.registry().counter_total(
            "dccrg_fleet_slo_sheds_total"))
        new_sheds = int(sheds - self._last_sheds)
        self._last_sheds = sheds
        if new_sheds > 0:
            self._shed_clean = 0
        else:
            self._shed_clean += 1
        return {
            "new_sheds": new_sheds,
            "shed_clean_streak": self._shed_clean,
            "slo_slack_min_s": (None if slack_min is None
                                else round(float(slack_min), 9)),
            "quantum_latency_s": (None if lat is None
                                  else round(float(lat), 9)),
            "trip_rate": round(float(self._trip_rate), 9),
            "save_cost_s": self._save_cost_mean(),
            "rollback_s": self._rollback_cost_mean(),
            "new_suspects": new_susp,
            "suspects_total": suspects,
            "clean_streak": self._clean,
            "active_jobs": len(active),
        }

    # -- the per-tick control pass ------------------------------------

    def tick(self, sched) -> dict:
        """One control pass at a scheduler tick boundary: gather
        inputs, run every tuning rule, apply the surviving knob
        values back onto the scheduler, export the live-knob gauges
        and (periodically) the status snapshot. Pure host-side
        arithmetic — no device work. Returns the gathered inputs
        (the tests' window into the observation path)."""
        self._tick = int(sched.ticks)
        inp = self.gather(sched)
        if not self._warmed:
            # journal-driven cross-run warm start: applied once, at
            # the first control pass, through a journaled rule like
            # every other knob move (no-op without recovered history)
            self._warmed = True
            self._warm_start_quantum(sched)
        self._tune_quantum(sched, inp)
        self._tune_audit(sched, inp)
        self._tune_shed(sched, inp)
        self._tune_retries(sched, inp)
        if self._tick % self.adjust_every == 0:
            self._tune_checkpoints(sched, inp)
        telemetry.set_gauge("dccrg_autopilot_quantum", self.quantum)
        telemetry.set_gauge("dccrg_autopilot_audit_every",
                            self.audit_every)
        if self._tick % self.status_every == 0:
            self.write_status(sched, inp)
        return inp

    def _warm_start_quantum(self, sched) -> None:
        before = max(1, int(sched.quantum))
        lo, hi = self.bounds["quantum"]
        q = self._apply(
            "quantum.warm_start", "quantum", before,
            {"learned_quantum": self.learned_quantum, "lo": lo,
             "hi": hi, "configured": self.quantum0})
        if q != before:
            self.quantum = q
            sched.quantum = q
            sched.slo.quantum = q

    def _tune_quantum(self, sched, inp) -> None:
        # the scheduler's live value is the source of truth: the
        # controller only ever moves it through a journaled rule —
        # an injected controller whose constructor defaults differ
        # from the configured knob must not silently stomp it
        self.quantum = max(1, int(sched.quantum))
        lo, hi = self.bounds["quantum"]
        slack = inp["slo_slack_min_s"]
        rate = inp["trip_rate"]
        short_evi = ((slack is not None and slack < 0.0)
                     or rate > self.trip_warm)
        self._q_short = self._q_short + 1 if short_evi else 0
        lat = inp["quantum_latency_s"]
        long_evi = (lat is not None and rate <= self.trip_cool
                    and (slack is None
                         or slack >= self.slack_factor * lat))
        self._q_long = self._q_long + 1 if long_evi else 0
        base = dict(inp, lo=lo, hi=hi, trip_warm=self.trip_warm,
                    trip_cool=self.trip_cool,
                    slack_factor=self.slack_factor)
        q = self._apply(
            "quantum.shorten", "quantum", self.quantum,
            dict(base, streak=self._q_short,
                 patience=self.shorten_patience))
        if q == self.quantum:
            q = self._apply(
                "quantum.lengthen", "quantum", self.quantum,
                dict(base, streak=self._q_long,
                     patience=self.lengthen_patience))
        if q != self.quantum:
            self._q_short = self._q_long = 0
            self.quantum = q
            # the scheduler budgets and the SLO projections both
            # follow the tuned quantum (written back ONLY on a
            # journaled decision)
            sched.quantum = self.quantum
            sched.slo.quantum = self.quantum

    def _tune_audit(self, sched, inp) -> None:
        self.audit_every = max(0, int(sched.audit_every))  # live truth
        lo, hi = self.bounds["audit_every"]
        base = dict(inp, lo=lo, hi=hi, baseline=self.audit0,
                    warm_start=8, relax_after=self.relax_after)
        a = self._apply("audit.tighten", "audit_every",
                        self.audit_every, base)
        if a == self.audit_every:
            a = self._apply("audit.relax", "audit_every",
                            self.audit_every, base)
        if a != self.audit_every:
            self.audit_every = a
            sched.audit_every = a

    def _tune_shed(self, sched, inp) -> None:
        # the shed cooldown rides the same pure-rule machinery as
        # every other knob: the live value is the truth, only a
        # journaled firing writes back
        before = max(1, int(sched.slo.shed_cooldown))
        if self._shed0 is None:
            self._shed0 = before  # the configured baseline
        lo, hi = self.bounds["shed_cooldown"]
        new = self._apply(
            "shed.cooldown", "shed_cooldown", before,
            dict(inp, lo=lo, hi=hi, baseline=self._shed0,
                 relax_after=self.relax_after))
        if new != before:
            sched.slo.shed_cooldown = new

    def _tune_retries(self, sched, inp) -> None:
        # per-job retry budgets from each job's OWN trip history,
        # re-evaluated only when that history moved (event-driven, no
        # per-tick churn toward a bound)
        lo, hi = self.bounds["max_retries"]
        for _b, _s, job in sched.active_jobs():
            trips = len(job.trips)
            if self._retry_seen.get(job.name) == trips or trips == 0:
                continue
            self._retry_seen[job.name] = trips
            before = max(1, int(job.max_retries))
            # job.retries is the scheduler's consecutive same-step
            # streak (reset on progress); recovered = trips the job
            # progressed past
            new = self._apply(
                "retry.budget", f"max_retries[{job.name}]", before,
                {"repeat_trips": int(job.retries),
                 "recovered": max(0, trips - int(job.retries)),
                 "trips_total": trips, "lo": lo, "hi": hi})
            if new != before:
                job.max_retries = new

    def record_reclaim(self, dead_rank, jobs, lease_s) -> None:
        """An elastic-fleet reclaim happened on this rank: journal it
        through the ``fleet.reclaim`` rule so ``explain`` narrates who
        died and what was taken over, and ``replay`` re-derives the
        cumulative count."""
        jobs = sorted(str(j) for j in jobs)
        after = self._apply(
            "fleet.reclaim", "reclaims", int(self.reclaims),
            {"n": len(jobs), "jobs": jobs, "dead_rank": int(dead_rank),
             "lease_s": float(lease_s)})
        self.reclaims = int(after)

    # -- streaming-intake decisions (the intake front door) -----------

    def record_intake_gate(self, inputs: dict) -> int:
        """Evaluate the intake backpressure gate through the
        ``intake.backpressure`` rule (journaled on every flip) and
        return the new gate state (0 = open, 1 = closed). ``inputs``
        must already be JSON-faithful (rounded floats) — they are
        recorded verbatim and replay re-derives the flip from them
        alone."""
        after = self._apply("intake.backpressure", "intake_gate",
                            int(self.intake_gate), dict(inputs))
        self.intake_gate = int(after)
        return self.intake_gate

    def record_intake_shed(self, names, tenant, inputs: dict) -> None:
        """A graceful intake shed happened: journal it through the
        ``intake.shed`` rule so ``explain`` narrates what was shed
        and under which saturation numbers."""
        names = sorted(str(n) for n in names)
        after = self._apply(
            "intake.shed", "intake_sheds", int(self.intake_sheds),
            dict(inputs, n=len(names), names=names,
                 tenant=str(tenant)))
        self.intake_sheds = int(after)

    def record_intake_quarantine(self, name, reason: dict) -> None:
        """A poison job moved to quarantine: journal it through the
        ``intake.quarantine`` rule with the structured reason record
        (error type, attempts, tenant)."""
        after = self._apply(
            "intake.quarantine", "intake_quarantines",
            int(self.intake_quarantines),
            dict(reason, name=str(name)))
        self.intake_quarantines = int(after)

    # -- warm-start decisions (the warm pool) -------------------------

    def record_warm(self, decision, kid, inputs: dict) -> None:
        """A warm-start cache decision happened (``warm``/``cold``/
        ``reject``/``quarantine``): journal it through the
        ``warmstart.cache`` rule so ``explain`` narrates every warm
        claim and every degradation-to-cold with its inputs."""
        after = self._apply(
            "warmstart.cache", "warm_events", int(self.warm_events),
            dict(inputs, decision=str(decision), key=str(kid)))
        self.warm_events = int(after)

    def record_warm_gc(self, pruned, inputs: dict) -> None:
        """An applied warm-cache retention GC pruned ``pruned``
        files: journal it through the ``warmstart.gc`` rule."""
        pruned = sorted(str(p) for p in pruned)
        after = self._apply(
            "warmstart.gc", "warm_gcs", int(self.warm_gcs),
            dict(inputs, n=len(pruned), pruned=pruned))
        self.warm_gcs = int(after)

    def _tune_checkpoints(self, sched, inp) -> None:
        lo, hi = self.bounds["checkpoint_every"]
        for b, _s, job in sched.active_jobs():
            before = int(job.checkpoint_every)
            if before <= 0 or job.steps_done < before:
                continue  # cadence disabled / not one period of data
            # step time from the job's OWN bucket latency (a
            # heterogeneous fleet's fast buckets must not be priced
            # by the slowest bucket's EWMA)
            lat = sched.slo.quantum_latency(b.key)
            step_s = (None if lat is None
                      else round(lat / max(1, self.quantum), 9))
            rate = round(len(job.trips) / max(1, job.steps_done), 9)
            new = self._apply(
                "checkpoint.retune", f"checkpoint_every[{job.name}]",
                before, dict(inp, lo=lo, hi=hi, step_seconds=step_s,
                             trip_rate=rate, deadband=0.25))
            if new != before:
                job.checkpoint_every = new

    # -- capacity history ---------------------------------------------

    def seed_capacity(self, bucket_key, default_cap: int,
                      min_capacity: int = 1) -> int:
        """The initial capacity for a NEW bucket of ``bucket_key``:
        the learned surviving capacity when the recorded OOM/shed
        history knows one smaller than ``default_cap``, else the
        default. ``min_capacity`` floors the seed (the scheduler
        passes the largest single job's slot demand, so a DMR job's
        shadow slot survives history learned from plain jobs)."""
        kid = key_id(bucket_key)
        self._default_seen[kid] = int(default_cap)
        if self.capacity.get(kid) is not None:
            self._seeded.add(kid)
        return self._apply(
            "capacity.seed", f"capacity[{kid}]", int(default_cap),
            {"learned_capacity": self.capacity.get(kid),
             "default_capacity": int(default_cap),
             "lo": max(1, int(min_capacity))})

    def _learn_capacity(self, bucket_key, surviving: int,
                        event: str) -> None:
        kid = key_id(bucket_key)
        self._shrunk.add(kid)
        before = self.capacity.get(kid)
        after = self._apply(
            "capacity.learn", f"capacity[{kid}]", before,
            {"observed_capacity": int(surviving), "event": event})
        if after is not None:
            self.capacity[kid] = int(after)

    def record_oom(self, bucket_key, surviving_capacity: int) -> None:
        """A real batch OOM forced a half-capacity rebuild that
        survived at ``surviving_capacity`` slots."""
        self._learn_capacity(bucket_key, surviving_capacity, "oom")

    def record_shed(self, bucket_key, surviving_capacity: int) -> None:
        """An SLO shed rebuilt the bucket at ``surviving_capacity``
        slots."""
        self._learn_capacity(bucket_key, surviving_capacity, "shed")

    def end_of_run(self) -> None:
        """The scheduler drained cleanly: every SEEDED bucket key
        that saw no OOM/shed this run earns a ``capacity.probe`` —
        the learned floor doubles back toward the configured default,
        so one transient spike never pins a key's capacity down
        across all future runs (the recovery is journaled and
        replayable like every other decision)."""
        for kid in sorted(self._seeded - self._shrunk):
            before = self.capacity.get(kid)
            if before is None:
                continue
            after = self._apply(
                "capacity.probe", f"capacity[{kid}]", int(before),
                {"clean_run": True,
                 "default_capacity": self._default_seen.get(kid)})
            if after != before:
                self.capacity[kid] = int(after)
        self._seeded.clear()
        self._shrunk.clear()
        # cross-run QUANTUM memory: journal the converged value when
        # it differs from what the next run would start at (the
        # previously learned value, else the configured default) —
        # a fresh controller sharing only the journal warm-starts
        # there
        before_q = self.learned_quantum
        after_q = self._apply(
            "quantum.learn", "quantum.learned", before_q,
            {"final_quantum": int(self.quantum),
             "configured": self.quantum0})
        if after_q != before_q and after_q is not None:
            self.learned_quantum = int(after_q)

    # -- status snapshot ----------------------------------------------

    def status_text(self, sched, inp=None) -> str:
        """The human-readable operator snapshot: live knob values
        (with their hard bounds), per-bucket latency EWMAs and
        occupancy, per-lane suspect counters, per-job SLO slack and
        checkpoint cadence, and the tail of the decision ring."""
        lines = [
            f"dccrg autopilot status — tick {self._tick}, "
            f"{self.seq} decision(s)",
            f"knobs: quantum={self.quantum} "
            f"(bounds {self.bounds['quantum'][0]}.."
            f"{self.bounds['quantum'][1]}, configured {self.quantum0})"
            f" audit_every={self.audit_every} "
            f"(bounds {self.bounds['audit_every'][0]}.."
            f"{self.bounds['audit_every'][1]}, "
            f"configured {self.audit0})",
        ]
        if inp is not None:
            lines.append(
                "inputs: " + " ".join(
                    f"{k}={v}" for k, v in sorted(inp.items())))
        lines.append("buckets:")
        for key, insts in sched.buckets.items():
            kid = key_id(key)
            lat = sched.slo.quantum_latency(key)
            for b in insts:
                lines.append(
                    f"  {kid} cap={b.capacity} jobs={len(b.jobs)} "
                    f"ewma_s={'-' if lat is None else f'{lat:.6g}'}"
                    + (f" seeded<={self.capacity[kid]}"
                       if kid in self.capacity else ""))
        lines.append(
            "suspects: " + " ".join(
                f"lane{i}={n}" + ("(quarantined)"
                                  if i in sched.quarantined else "")
                for i, n in enumerate(sched.suspects)))
        lines.append("jobs:")
        for _b, _s, job in sched.active_jobs():
            slack = sched.slo.slack_s(job)
            lines.append(
                f"  {job.name} steps={job.steps_done}/{job.n_steps} "
                f"ckpt_every={job.checkpoint_every} "
                f"trips={len(job.trips)} slo_slack_s="
                + ("-" if slack is None else f"{slack:.6g}"))
        if self.decisions:
            lines.append("recent decisions:")
            for rec in list(self.decisions)[-5:]:
                lines.append("  " + explain_decision(rec))
        return "\n".join(lines) + "\n"

    def write_status(self, sched, inp=None) -> bool:
        """Best-effort (re)write of the status snapshot to
        ``DCCRG_STATUS_FILE``; no sink configured is a no-op."""
        path = self._status_file
        if path is None:
            return False
        return telemetry._best_effort_write(
            self._resolved(path), self.status_text(sched, inp),
            append=False)


# ---------------------------------------------------------------------
# journal reading, explain, replay (no controller needed)
# ---------------------------------------------------------------------

def read_journal(path: str) -> list:
    """Parse one JSONL decision journal — the trace-file reader with
    a dict filter (torn tail lines from a killed run are skipped)."""
    return [r for r in telemetry.read_trace(path)
            if isinstance(r, dict)]


def merge_journals(paths) -> list:
    """Merge per-rank journals into one ``(ts, rank, seq)``-ordered
    list — records already carry their rank tag, like trace
    events."""
    recs = []
    for p in paths:
        recs.extend(read_journal(p))
    recs.sort(key=lambda r: (r.get("ts", 0.0), r.get("rank", 0),
                             r.get("seq", 0)))
    return recs


def explain_decision(rec: dict) -> str:
    """One decision record as a human-readable line: when, which rule,
    what moved, every observed input it depended on, and the expected
    effect."""
    inputs = rec.get("inputs", {})
    shown = ", ".join(f"{k}={inputs[k]}" for k in sorted(inputs))
    return (f"[tick {rec.get('tick', '?')} seq {rec.get('seq', '?')} "
            f"rank {rec.get('rank', 0)}] {rec.get('rule', '?')}: "
            f"{rec.get('knob', '?')} {rec.get('before')} -> "
            f"{rec.get('after')} | observed: {shown} | expected: "
            f"{rec.get('expected', '')}")


def replay(records) -> list:
    """Re-derive every journaled action by feeding the RECORDED inputs
    back through the same pure rules the live controller used.
    Returns ``[(record, why)]`` divergences — an empty list means the
    journal fully explains the run; anything else is a bug (journal
    corruption, a nondeterministic input leak, or a rule edit that
    silently changed behavior)."""
    divergences = []
    for rec in records:
        rule = RULES.get(rec.get("rule"))
        if rule is None:
            divergences.append((rec, f"unknown rule {rec.get('rule')!r}"))
            continue
        try:
            got = rule(rec.get("before"), rec.get("inputs", {}))
        except Exception as e:  # noqa: BLE001 - a divergence, not a crash
            divergences.append((rec, f"rule raised {e!r}"))
            continue
        if got is None:
            divergences.append(
                (rec, "rule does not fire on the recorded inputs"))
        elif got != rec.get("after"):
            divergences.append(
                (rec, f"re-derived {got!r} != recorded "
                      f"{rec.get('after')!r}"))
    return divergences


# ---------------------------------------------------------------------
# CLI: python -m dccrg_tpu_torch.autopilot explain|replay <journal>...
# ---------------------------------------------------------------------

def _main(argv=None) -> int:
    """``python -m dccrg_tpu_torch.autopilot explain <journal.jsonl>...``
    prints every decision human-readably (rule, knob move, observed
    inputs, expected effect) from the journal alone; ``replay``
    re-derives each action from the recorded inputs through the same
    rules the live controller used and exits 1 on any divergence
    (replay divergence = bug). Per-rank journals of one run merge
    like traces. Needs no device."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m dccrg_tpu_torch.autopilot",
                                 description=_main.__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("explain", help="reconstruct every decision "
                                       "human-readably")
    e.add_argument("files", nargs="+")
    r = sub.add_parser("replay", help="re-derive every action from "
                                      "the recorded inputs; exit 1 "
                                      "on divergence")
    r.add_argument("files", nargs="+")
    args = ap.parse_args(argv)
    recs = merge_journals(args.files)
    if args.cmd == "explain":
        for rec in recs:
            print(explain_decision(rec))
        print(f"# {len(recs)} decision(s)")
        return 0
    div = replay(recs)
    for rec, why in div:
        print(f"DIVERGED seq {rec.get('seq', '?')} "
              f"({rec.get('rule', '?')}): {why}")
    print(json.dumps({"decisions": len(recs),
                      "divergences": len(div)}))
    return 1 if div else 0


if __name__ == "__main__":  # pragma: no cover - exercised via CLI
    import sys

    sys.exit(_main())
