"""Preemption-aware run supervision of the port: the layer that drives
the resilience stack across a run's whole lifecycle.

Port of ``dccrg_tpu/supervise.py``. On preemptible fleets the dominant
failure is preemption: the scheduler SIGTERMs the job with a short
grace window, and a hung collective or a wedged step quietly eats that
window. This module wraps
:class:`~dccrg_tpu_torch.resilience.ResilientRunner`:

**Preemption handling**: :class:`SupervisedRunner` installs
SIGTERM/SIGINT handlers that set a flag; the flag is polled at step
boundaries (never mid-launch) and put through the per-step trip
consensus (``resilience._TRIP_INTERRUPT``, outranked by any real trip),
so in a process group every rank observes the preemption together. The
run then takes an **emergency checkpoint** (the ordinary atomic save,
with the ``coord.barrier`` timeout cut to a quarter of the grace window,
``DCCRG_PREEMPT_GRACE``), verifies its CRCs and raises
:class:`PreemptedError` with the resumable exit code
:data:`RESUMABLE_EXIT` (``EX_TEMPFAIL``, 75).

**Step-hang watchdog**: with ``DCCRG_STEP_TIMEOUT`` (or
``step_timeout=``) set, each step runs on a deadline thread, a
``torch.cuda.synchronize`` of the grid's card included (asynchronous
launches cannot hide a wedged step), and raises
:class:`StepTimeoutError` naming the step instead of blocking forever.
Transient dispatch errors (the ``UNAVAILABLE`` / ``DEADLINE_EXCEEDED``
class, or an injected :class:`~dccrg_tpu_torch.faults.InjectedDispatchError`)
retry with bounded backoff WITHOUT tripping a rollback. Unset, the step
path adds no thread and no sync.

**Incremental checkpoints, auto-resume and retention GC**: periodic
checkpoints land in a :class:`CheckpointStore` as one numbered file per
step: keyframes (``ckpt_00000042.dc``) and dirty-field DELTAS
(``.dcd``) that hold only the fields written since the previous save,
chained through sidecar parent links (``DCCRG_KEYFRAME_EVERY``,
``DCCRG_DELTA=0``; structural mutations force a keyframe).
:func:`resume_latest` picks the newest entry that passes verification,
chain-aware for deltas, falling back to older entries and last to a
salvage load. :func:`gc_checkpoints` applies a keep-last-K
(``DCCRG_KEEP_LAST``) / keep-every-N policy after each save, whole
chains only: it never orphans a delta nor deletes the only verifying
chain, and it sweeps stale temp files of dead runs
(:func:`dccrg_tpu_torch.checkpoint.stale_temp_files`).

Every path is driven deterministically by fault injection
(:meth:`~dccrg_tpu_torch.faults.FaultPlan.preempt_signal`,
:meth:`~dccrg_tpu_torch.faults.FaultPlan.step_hang`,
:meth:`~dccrg_tpu_torch.faults.FaultPlan.dispatch_error`), and by a
real in-process ``SIGTERM``. See also ``python -m
dccrg_tpu_torch.resilience verify|chain|gc``.
"""

from __future__ import annotations

import logging
import math
import os
import re
import signal
import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field as dataclass_field

import torch

from . import background
from . import checkpoint as checkpoint_mod
from . import coord, faults, resilience, telemetry

logger = logging.getLogger("dccrg_tpu_torch.supervise")

#: The exit code of a preempted-but-resumable run: EX_TEMPFAIL (75),
#: the sysexits convention schedulers read as "transient failure,
#: reschedule me". A supervised job that exits with it left a
#: CRC-verified checkpoint behind; restart it and call
#: :func:`resume_latest`.
RESUMABLE_EXIT = 75


class StepTimeoutError(RuntimeError):
    """A supervised deadline expired: the step (or the emergency
    checkpoint, ``what`` says which) did not complete within its bound,
    the signature of a wedged collective or a dead card mid-step.
    ``step`` names the step for step deadlines."""

    def __init__(self, what, timeout, step=None):
        super().__init__(
            f"{what} did not complete within {timeout:g}s (wedged "
            "collective, dead accelerator tunnel, or a stuck host "
            "callback); the worker thread is abandoned — this state "
            "is not recoverable in-process, only reportable")
        self.what = str(what)
        self.timeout = float(timeout)
        self.step = step


class PreemptedError(RuntimeError):
    """The supervised run stopped at a step boundary because a
    preemption signal arrived (or a faked
    :meth:`~dccrg_tpu_torch.faults.FaultPlan.preempt_signal` fired).
    ``checkpoint`` is the CRC-verified emergency checkpoint, or, when
    the emergency save could not finish inside the grace window
    (``clean=False``), the last periodic one; either way the run
    resumes from it through :func:`resume_latest`. ``exit_code`` is
    :data:`RESUMABLE_EXIT`."""

    exit_code = RESUMABLE_EXIT

    def __init__(self, step, checkpoint=None, clean=True):
        super().__init__(
            f"preempted at the boundary after step {step}; resumable "
            f"from {checkpoint or '<no checkpoint>'} (exit code "
            f"{RESUMABLE_EXIT})")
        self.step = int(step)
        self.checkpoint = checkpoint
        self.clean = bool(clean)


# ---------------------------------------------------------------------
# env knobs
# ---------------------------------------------------------------------

def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def step_timeout_default(default: float = 0.0) -> float:
    """The ``DCCRG_STEP_TIMEOUT`` env knob: seconds before a
    dispatched step is declared wedged (0 = watchdog off; the step
    path then has no thread and no extra device sync)."""
    return _env_float("DCCRG_STEP_TIMEOUT", default)


def ckpt_seconds_default(default: float = 0.0) -> float:
    """The ``DCCRG_CKPT_SECONDS`` env knob: wall-clock checkpoint
    cadence in seconds (monotonic clock, evaluated at step boundaries
    only — never mid-step), for runs whose step times are too uneven
    for a step-count cadence. 0 keeps the step-count cadence alone."""
    return _env_float("DCCRG_CKPT_SECONDS", default)


def preempt_grace(default: float = 30.0) -> float:
    """The ``DCCRG_PREEMPT_GRACE`` env knob: seconds the emergency
    checkpoint may spend after a preemption signal — set it below the
    scheduler's kill grace. Barriers inside the save get a quarter of
    it each, so one dead peer cannot eat the whole window."""
    return _env_float("DCCRG_PREEMPT_GRACE", default)


def keep_last_default(default: int = 3) -> int:
    """The ``DCCRG_KEEP_LAST`` env knob: how many newest checkpoints
    retention GC keeps (minimum 1)."""
    try:
        return max(1, int(os.environ.get("DCCRG_KEEP_LAST", "")
                          or default))
    except ValueError:
        return default


def delta_enabled(default: bool = True) -> bool:
    """The ``DCCRG_DELTA`` env knob: ``0`` opts out of incremental
    (dirty-field delta) periodic saves — every save is then a full
    keyframe, byte-for-byte the pre-delta behavior."""
    v = os.environ.get("DCCRG_DELTA", "")
    if v == "":
        return default
    return v != "0"


def keyframe_every_default(default: int = 8) -> int:
    """The ``DCCRG_KEYFRAME_EVERY`` env knob: every K-th periodic save
    is a full keyframe, so a delta chain holds at most K-1 deltas
    (minimum 1 = every save a keyframe). Long chains save bytes but
    lengthen resume (each link replays) and widen the blast radius of
    a lost link — the retention GC never splits a chain either way."""
    try:
        return max(1, int(os.environ.get("DCCRG_KEYFRAME_EVERY", "")
                          or default))
    except ValueError:
        return default


# ---------------------------------------------------------------------
# preemption flag + signal handlers
# ---------------------------------------------------------------------

_PREEMPT = threading.Event()
_sigint_count = 0


def preempt_requested() -> bool:
    """True when a preemption signal (real or programmatic) is
    pending; the supervised loop observes it at the next step
    boundary."""
    return _PREEMPT.is_set()


def request_preempt() -> None:
    """Set the preempt flag programmatically: what the signal handler
    (and a consumed :meth:`~dccrg_tpu_torch.faults.FaultPlan
    .preempt_signal`) does."""
    _PREEMPT.set()


def clear_preempt() -> None:
    _PREEMPT.clear()


def _signal_handler(signum, frame):  # noqa: ARG001 - signal API
    global _sigint_count
    if signum == getattr(signal, "SIGINT", None):
        _sigint_count += 1
        if _sigint_count > 1:
            # a second ctrl-C means "now": the graceful path already
            # had its chance
            raise KeyboardInterrupt
    _PREEMPT.set()
    try:
        name = signal.Signals(signum).name
    except ValueError:  # pragma: no cover - exotic signal number
        name = str(signum)
    logger.warning(
        "received %s: finishing the current step, then emergency "
        "checkpoint and resumable exit (%d)", name, RESUMABLE_EXIT)


@contextmanager
def preemption_handlers(signals=(signal.SIGTERM, signal.SIGINT)):
    """Install the preemption signal handlers for the duration of a
    supervised run; previous handlers are restored on exit and the
    preempt flag starts cleared (this context owns the run's
    lifecycle). Only the main thread may install handlers — elsewhere
    this degrades to a no-op and the flag can still be raised via
    :func:`request_preempt`. A second SIGINT escalates to
    ``KeyboardInterrupt`` (the graceful path already had its
    chance)."""
    global _sigint_count
    _sigint_count = 0
    clear_preempt()
    prev = {}
    for s in signals:
        try:
            prev[s] = signal.signal(s, _signal_handler)
        except (ValueError, OSError):  # non-main thread / unsupported
            pass
    try:
        yield
    finally:
        # the flag belongs to THIS run's lifecycle: a signal this run
        # already answered (emergency checkpoint + resumable exit)
        # must not leak into the next run in the same process
        clear_preempt()
        for s, h in prev.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):  # pragma: no cover
                pass


# ---------------------------------------------------------------------
# deadline machinery
# ---------------------------------------------------------------------

def _under_deadline(fn, timeout, what, step=None):
    """Run ``fn()`` under :func:`dccrg_tpu_torch.coord.run_with_deadline`
    (the shared watchdog-thread primitive). On expiry the worker is
    abandoned — a wedged collective cannot be cancelled, only
    reported — and :class:`StepTimeoutError` is raised; ``fn``'s own
    exception re-raises on the caller thread."""
    finished, result, err = coord.run_with_deadline(
        fn, timeout, f"deadline:{what}")
    if not finished:
        raise StepTimeoutError(what, timeout, step=step)
    if err is not None:
        raise err
    return result


@contextmanager
def _grace_env(grace: float):
    """Shorten ``DCCRG_BARRIER_TIMEOUT`` for the emergency save: a
    multi-process checkpoint crosses up to three barriers, so each gets
    a quarter of the grace window and one dead peer can eat at most its
    barrier's share. Never lengthens an already-shorter configured
    timeout; the caller's value is restored either way."""
    cut = min(coord.barrier_timeout(), max(1.0, float(grace) / 4.0))
    old = os.environ.get("DCCRG_BARRIER_TIMEOUT")
    os.environ["DCCRG_BARRIER_TIMEOUT"] = str(cut)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("DCCRG_BARRIER_TIMEOUT", None)
        else:
            os.environ["DCCRG_BARRIER_TIMEOUT"] = old


#: The per-step latency histogram: the one histogram implementation
#: (:class:`dccrg_tpu_torch.telemetry.LogHistogram`, BASE=1e-4, 30
#: buckets) under the reference's name; the registry's
#: ``dccrg_step_seconds`` series is fed from the same measurements.
LatencyHistogram = telemetry.LogHistogram


# markers of the transient class of runtime errors (a flaky link) that
# a re-dispatch can cure, the reference's list; a device OOM is excluded
# (the fallback chain owns it)
_TRANSIENT_MARKERS = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED")


def _is_transient_dispatch(e: BaseException) -> bool:
    if isinstance(e, faults.InjectedDispatchError):
        return True
    if isinstance(e, (StepTimeoutError, resilience.NumericsError,
                      faults.SimulatedResourceExhausted,
                      torch.OutOfMemoryError)):
        return False
    s = str(e)
    if "RESOURCE_EXHAUSTED" in s:
        return False
    return any(m in s for m in _TRANSIENT_MARKERS)


# ---------------------------------------------------------------------
# the numbered checkpoint store + retention GC + auto-resume
# ---------------------------------------------------------------------

_CKPT_RE = re.compile(r"^(?P<stem>.+)_(?P<step>\d{1,12})\.(?P<ext>dcd?)$")


def _scan_checkpoints(dirpath: str) -> list:
    """``[(stem, step, path)]`` of every numbered checkpoint —
    keyframe (``.dc``) or delta (``.dcd``) — in ``dirpath``, in name
    order."""
    out = []
    try:
        names = os.listdir(dirpath)
    except OSError:
        return out
    for name in sorted(names):
        m = _CKPT_RE.match(name)
        if m is not None:
            out.append((m.group("stem"), int(m.group("step")),
                        os.path.join(dirpath, name)))
    return out


def list_checkpoints(dirpath: str, stem: str | None = None) -> list:
    """``[(step, path)]`` of the numbered checkpoints in ``dirpath``
    (``<stem>_<step>.dc`` keyframes and ``<stem>_<step>.dcd`` deltas),
    newest step first; a keyframe outranks a same-step delta (an
    emergency save landing on a delta's step). ``stem=None`` matches
    any stem."""
    out = [(s, p) for st, s, p in _scan_checkpoints(dirpath)
           if stem is None or st == stem]
    # ".dc" sorts before ".dcd" (prefix), so path order breaks the tie
    # toward the keyframe
    out.sort(key=lambda e: (-e[0], e[1]))
    return out


def retention_plan(steps, keep_last: int = 3, keep_every: int = 0):
    """The pure retention policy: which checkpoint steps to keep and
    which to drop. Keeps the newest ``keep_last`` steps (clamped to at
    least 1 — the policy alone can never empty a directory) plus, with
    ``keep_every > 0``, every step divisible by it (the coarse
    long-horizon trail, the reference's keep-every-Nth restart files).
    Returns ``(keep, drop)``, both newest first. Verification safety
    is :func:`gc_checkpoints`'s job, not this function's."""
    steps = sorted({int(s) for s in steps}, reverse=True)
    keep = set(steps[:max(1, int(keep_last))])
    if int(keep_every) > 0:
        keep.update(s for s in steps if s % int(keep_every) == 0)
    return ([s for s in steps if s in keep],
            [s for s in steps if s not in keep])


@dataclass
class GCReport:
    """What a retention sweep kept, dropped and refused. ``rescued``
    names a step kept beyond policy because it was the only one that
    passes verification; ``refused`` is non-None when nothing in the
    directory verifies and the GC declined to prune at all."""

    kept: list = dataclass_field(default_factory=list)      # [(step, path)]
    dropped: list = dataclass_field(default_factory=list)   # [(step, path)]
    stale_temps: list = dataclass_field(default_factory=list)
    rescued: int | None = None
    refused: str | None = None
    applied: bool = False


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def _chain_index(files) -> dict:
    """Chain structure of one stem's ``[(step, path)]`` (sorted): maps
    each chain's root path -> sorted member ``(step, path)`` list. A
    keyframe roots its own chain; each delta attaches to its sidecar's
    recorded parent file. A delta whose parent cannot be resolved
    (missing file, unreadable sidecar, self/cyclic link) roots an
    already-orphaned chain of its own — it can never verify, so the
    retention guards treat it like any other dead chain."""
    by_name = {os.path.basename(p): p for _s, p in files}
    parent: dict = {}
    for _s, p in files:
        if not p.endswith(resilience.DELTA_SUFFIX):
            continue
        pf = None
        try:
            rec = resilience.read_sidecar(p)
            d = rec.get("delta") if rec else None
            pf = d["parent"]["file"] if d else None
        except resilience.CheckpointCorruptionError:
            pf = None
        target = by_name.get(pf) if pf else None
        if target is not None and target != p:
            parent[p] = target
    root_of: dict = {}
    for _s, p in files:
        trail, seen, q = [], set(), p
        while q in parent and q not in root_of and q not in seen:
            seen.add(q)
            trail.append(q)
            q = parent[q]
        r = root_of.get(q, q)  # a cycle roots at its entry point
        for t in trail:
            root_of[t] = r
        root_of.setdefault(p, r)
    chains: dict = {}
    for s, p in files:
        chains.setdefault(root_of[p], []).append((s, p))
    for r in chains:
        chains[r].sort()
    return chains


def chain_report(dirpath: str, stem: str | None = None) -> list:
    """Every keyframe->delta chain in ``dirpath`` with per-link
    verification status: ``[(stem, [(step, path, kind, status)])]``,
    newest chain first per stem, links oldest-first. ``status`` is
    ``OK`` (the link's whole sub-chain verifies), ``CORRUPT`` (this
    link's own bytes/sidecar fail) or ``BROKEN(<link>)`` (an ancestor
    fails, naming it). The ``python -m dccrg_tpu_torch.resilience chain``
    subcommand prints this."""
    groups: dict = {}
    for stem_name, step, path in _scan_checkpoints(dirpath):
        if stem is not None and stem_name != stem:
            continue
        groups.setdefault(stem_name, []).append((step, path))
    out = []
    for stem_name in sorted(groups):
        files = sorted(groups[stem_name])
        chains = _chain_index(files)
        memo: dict = {}
        for root in sorted(chains, key=lambda r: -chains[r][-1][0]):
            links = []
            for s, p in chains[root]:
                kind = ("delta" if p.endswith(resilience.DELTA_SUFFIX)
                        else "keyframe")
                try:
                    resilience.verify_chain(p, _memo=memo)
                    status = "OK"
                except resilience.DeltaChainError as e:
                    if e.link and os.path.abspath(e.link) == \
                            os.path.abspath(p):
                        status = "CORRUPT"
                    else:
                        status = ("BROKEN("
                                  + (os.path.basename(e.link)
                                     if e.link else "?") + ")")
                except resilience.CheckpointCorruptionError:
                    status = "CORRUPT"
                links.append((s, p, kind, status))
            out.append((stem_name, links))
    return out


@telemetry.traced("ckpt.gc")
def gc_checkpoints(dirpath: str, keep_last: int = 3, keep_every: int = 0,
                   stem: str | None = None, apply: bool = False,
                   assume_ok: int | None = None) -> GCReport:
    """Prune a checkpoint directory by the keep-last-K / keep-every-N
    retention policy (:func:`retention_plan`) — DRY-RUN unless
    ``apply`` — CHAIN-AWARE over keyframe+delta chains.

    Safety properties, regardless of policy (pinned by the fuzzed
    retention tests):

    - **Never orphan a delta.** Chains are pruned WHOLE or kept whole:
      a chain any of whose members the step policy keeps is kept
      entirely (a kept delta needs every ancestor down to its
      keyframe), and a dropped chain is deleted deltas-newest-first
      with the keyframe LAST, so a crash (or injected
      ``checkpoint.gc`` fault) mid-prune can only shorten a chain,
      never strand a delta without its keyframe.
    - **Never drop the only verifying chain.** A chain counts as
      verifying when any of its links' sub-chains verifies end to end
      (= something is strictly resumable from it). If no kept chain
      verifies, the newest verifying dropped chain is rescued whole;
      when NOTHING verifies the GC refuses to prune at all — a
      salvage load may still need any of those bytes.

    Checkpoint files are removed before their sidecars, so a crash
    mid-prune can only leave a harmless orphan sidecar. Stale
    save/salvage/chain-scratch temp files of dead runs are swept too
    (:func:`dccrg_tpu_torch.checkpoint.stale_temp_files`).

    ``assume_ok`` lets the process that JUST saved (and sidecar-
    verified) a step vouch for that step's file AND, when that step
    heads a kept chain, for the chain it extended (the same process
    wrote and verified every link), so the per-save GC path stays
    zero-read in the common case; chains the vouching process did not
    just extend verify normally.

    With ``stem=None`` each stem in the directory is an INDEPENDENT
    checkpoint sequence: the retention policy and the only-verifiable
    guard run per stem, so one run's files can never shadow or doom
    another's."""
    groups: dict = {}
    for stem_name, step, path in _scan_checkpoints(dirpath):
        if stem is not None and stem_name != stem:
            continue
        groups.setdefault(stem_name, []).append((step, path))
    kept, dropped = [], []
    rescued = refused = None
    for stem_name in sorted(groups):
        files = sorted(groups[stem_name])
        chains = _chain_index(files)
        keep_steps, _drop_steps = retention_plan(
            {s for s, _p in files}, keep_last, keep_every)
        keep_set = set(keep_steps)
        heads = sorted(chains, key=lambda r: -chains[r][-1][0])
        kept_chains = [r for r in heads
                       if any(s in keep_set for s, _p in chains[r])]
        drop_chains = [r for r in heads if r not in kept_chains]
        if drop_chains:
            memo: dict = {}
            assume = {p for s, p in files
                      if assume_ok is not None and s == int(assume_ok)}

            def _chain_ok(root):
                # the process that JUST saved (and whose earlier saves
                # built the links the new one chains to) vouches for
                # the chain it extended — the zero-read common path:
                # in steady state every sweep drops an aged-out chain,
                # and re-reading the kept chain's multi-GB keyframe
                # each time is exactly the I/O delta saves exist to
                # avoid. Every OTHER chain still byte-verifies.
                if (assume_ok is not None
                        and chains[root][-1][0] == int(assume_ok)):
                    return True
                # resumable = some link's whole sub-chain verifies
                for _s, p in reversed(chains[root]):
                    try:
                        resilience.verify_chain(p, assume_ok=assume,
                                                _memo=memo)
                        return True
                    except resilience.CheckpointCorruptionError:
                        continue
                return False

            if not any(_chain_ok(r) for r in kept_chains):
                for r in drop_chains:  # newest chain first
                    if _chain_ok(r):
                        rescued = chains[r][-1][0]
                        drop_chains = [d for d in drop_chains if d != r]
                        kept_chains.append(r)
                        break
                else:
                    refused = (
                        f"no {stem_name!r} checkpoint chain passes "
                        "verification; refusing to prune that "
                        "sequence — a salvage load may still need "
                        "any of them")
                    kept_chains += drop_chains
                    drop_chains = []
        stem_kept = sorted((e for r in kept_chains for e in chains[r]),
                           key=lambda e: (-e[0], e[1]))
        kept.extend(stem_kept)
        # whole chains only, deltas first, keyframe last — in every
        # chain independently (report order = deletion order)
        for r in sorted(drop_chains, key=lambda r: -chains[r][-1][0]):
            dropped.extend(reversed(chains[r]))
    stale = checkpoint_mod.stale_temp_files(dirpath)
    if apply:
        for s, path in dropped:
            # fault-injection site: an I/O error (or crash) here may
            # shorten a chain but can never orphan a delta — its
            # ancestors, the keyframe included, are deleted after it
            faults.fire("checkpoint.gc", path=path, step=s)
            _unlink(path)  # the checkpoint first: a crash leaves only
            _unlink(resilience.sidecar_path(path))  # an orphan sidecar
        for path in stale:
            faults.fire("checkpoint.gc", path=path, step=None)
            _unlink(path)
        telemetry.inc("dccrg_gc_pruned_total",
                      len(dropped) + len(stale))
    return GCReport(kept=kept, dropped=dropped, stale_temps=stale,
                    rescued=rescued, refused=refused,
                    applied=bool(apply))


class CheckpointStore:
    """A directory of numbered checkpoints, one file per checkpointed
    step — ``<stem>_<step:08d>.dc`` keyframes and ``.dcd`` dirty-field
    deltas, each with a CRC sidecar: the disk layout retention GC and
    :func:`resume_latest` operate on.

    :meth:`save` implements the incremental-save policy: a periodic
    save becomes a delta (only the fields whose bytes changed since
    the last save, tracked by the grid) chained to the previous save,
    with a full keyframe forced every ``keyframe_every`` saves
    (``DCCRG_KEYFRAME_EVERY``), after any structural mutation or
    shape/partition change (deltas are only valid within one structure
    epoch), when ragged (variable-size) fields are dirty, and on
    ``DCCRG_DELTA=0`` (opt-out: every save a keyframe)."""

    def __init__(self, dirpath, stem: str = "ckpt",
                 keyframe_every: int | None = None):
        self.dir = str(dirpath)
        self.stem = str(stem)
        self.keyframe_every = (keyframe_every_default()
                               if keyframe_every is None
                               else max(1, int(keyframe_every)))
        # the last save THIS process made: the next delta's parent
        # (path, step, grid structure epoch, chain length so far)
        self._parent = None
        # async-save writer (DCCRG_ASYNC_SAVE): at most one write in
        # flight per store; drain() is the barrier every reader takes
        self._saver = background.AsyncSaver()
        os.makedirs(self.dir, exist_ok=True)

    def drain(self) -> None:
        """Async-save barrier: block until this stem's in-flight write
        (if any) is durable, re-raising its failure (see
        :class:`~dccrg_tpu_torch.background.AsyncSaver`). Every reader of
        the store — rollback, resume, retention GC, digest comparisons
        — must pass through here first."""
        self._saver.drain()

    def pending(self) -> bool:
        """True while an async write of this stem is in flight."""
        return self._saver.pending()

    def path_for(self, step: int, delta: bool = False) -> str:
        ext = resilience.DELTA_SUFFIX if delta else ".dc"
        return os.path.join(self.dir, f"{self.stem}_{int(step):08d}{ext}")

    def _delta_fields(self, grid, variable, force_keyframe,
                      dirty_override=None):
        """The dirty-field list for a delta save, or None when this
        save must be a full keyframe. Every input is replicated state
        (dirty set, structure epoch, save counters), so multi-process
        ranks reach the identical decision without a collective."""
        if force_keyframe or not delta_enabled():
            return None
        last = self._parent
        if last is None:
            return None  # nothing to chain to in this process
        if getattr(grid, "_ckpt_epoch", 0) != last["epoch"]:
            return None  # structural mutation / repartition: new epoch
        if last["chain_len"] + 1 >= self.keyframe_every:
            return None  # periodic keyframe cadence
        dirty = (set(dirty_override) if dirty_override is not None
                 else getattr(grid, "_ckpt_dirty", None))
        if dirty is None:
            return None  # conservative: everything may have changed
        # ragged payloads resize with their counts: a dirty variable
        # field (or count field) moves the offset table, which only a
        # keyframe may capture
        var = variable or {}
        if dirty & (set(var) | set(var.values())):
            return None
        if set(dirty) >= set(grid.fields):
            return None  # a delta of everything is a keyframe + overhead
        return sorted(dirty)

    def save(self, grid, step: int, header: bytes = b"", variable=None,
             force_keyframe: bool = False, dirty_fields=None,
             post=None) -> str:
        """Periodic save at ``step``: a dirty-field delta chained to
        this process's previous save when safe (see class docstring),
        else a full keyframe. Atomic either way; on success the grid's
        dirty tracking is
        re-baselined to this save. Returns the path written.
        ``dirty_fields`` overrides the grid's own dirty tracking — the
        fleet layer saves ONE batch slot through a shared scratch grid
        whose tracking reflects whatever slot passed through last, but
        it knows exactly which fields its step program writes.

        With ``DCCRG_ASYNC_SAVE=1`` the write runs on a background
        thread against a frozen snapshot (:func:`~dccrg_tpu_torch.background
        .freeze_grid`), overlapped with the next steps; the chain policy,
        the parent link and the dirty re-baseline are all resolved
        synchronously here, so the published bytes are bitwise
        identical to a synchronous save's. ``post`` (the retention-GC
        hook) runs after the write — on the writer thread when async,
        inline otherwise — so GC never races a publish."""
        # one write in flight per stem: an earlier failure surfaces at
        # this save boundary (its on_fail already forced the next save
        # to a keyframe and dropped the unpublishable parent link)
        self.drain()
        fields = self._delta_fields(grid, variable, force_keyframe,
                                    dirty_override=dirty_fields)
        if not background.async_save_enabled():
            if fields is not None:
                path = self.path_for(step, delta=True)
                try:
                    resilience.save_delta_checkpoint(
                        grid, path, parent_path=self._parent["path"],
                        parent_step=self._parent["step"], step=step,
                        fields=fields, header=header, variable=variable)
                except resilience.CheckpointCorruptionError as e:
                    # the parent's sidecar went bad under us (external
                    # damage): save a keyframe, don't fail the run
                    logger.warning(
                        "delta save at step %d fell back to a keyframe "
                        "(%s)", step, e)
                    fields = None
            if fields is None:
                path = self.path_for(step)
                resilience.save_checkpoint(grid, path, header=header,
                                           variable=variable)
            self._record_parent(grid, path, step, fields)
            if post is not None:
                post()
            return path

        # async: resolve the delta parent link NOW (the drain above
        # made the parent durable), then hand the frozen snapshot to
        # the writer thread
        extra = None
        if fields is not None:
            try:
                extra = resilience.delta_sidecar_extra(
                    self._parent["path"], parent_step=self._parent["step"],
                    step=step, fields=fields, variable=variable)
            except resilience.CheckpointCorruptionError as e:
                logger.warning("delta save at step %d fell back to a "
                               "keyframe (%s)", step, e)
                fields = None
        path = self.path_for(step, delta=fields is not None)
        # a grid under a process split freezes through freeze_grid_mp:
        # the two-phase commit's barriers are store traffic, safe on the
        # writer thread, and the snapshot removes the save's device
        # reads (host copies of the local partitions, the key-value CRC
        # exchange, frozen count pulls)
        frozen = (background.freeze_grid_mp(grid, fields=fields,
                                            variable=variable)
                  if grid._multiproc
                  else background.freeze_grid(grid, fields=fields))

        def _write(path=path, fields=fields, extra=extra):
            resilience.save_checkpoint(frozen, path, header=header,
                                       variable=variable, fields=fields,
                                       sidecar_extra=extra)
            if post is not None:
                post()

        def _on_fail(_err):
            # the write never published: nothing may chain to it, and
            # the dirty set can no longer prove a proper delta subset
            # relative to a durable parent — force the next save to a
            # full keyframe
            self._parent = None
            grid._ckpt_dirty = None

        self._saver.submit(_write, on_fail=_on_fail, label=path)
        self._record_parent(grid, path, step, fields)
        return path

    def _record_parent(self, grid, path, step, fields) -> None:
        self._parent = {
            "path": path, "step": int(step),
            "epoch": getattr(grid, "_ckpt_epoch", 0),
            "chain_len": (0 if fields is None
                          else self._parent["chain_len"] + 1),
        }
        # re-baseline the dirty tracking: subsequent changes are
        # relative to THIS save (the next delta's parent)
        grid._ckpt_dirty = set()

    def list(self) -> list:
        """``[(step, path)]``, newest first (keyframes and deltas)."""
        return list_checkpoints(self.dir, self.stem)

    def gc(self, keep_last: int = 3, keep_every: int = 0,
           apply: bool = True, assume_ok: int | None = None) -> GCReport:
        # drain barrier: GC must never race an in-flight publish (a
        # no-op on the writer thread itself, where post-save GC is
        # already ordered after the write)
        self.drain()
        return gc_checkpoints(self.dir, keep_last=keep_last,
                              keep_every=keep_every, stem=self.stem,
                              apply=apply, assume_ok=assume_ok)


@dataclass
class ResumeInfo:
    """What :func:`resume_latest` restored: the reconstructed grid,
    the user header, the completed-step count the checkpoint
    captured, and how trustworthy it is (``salvaged=True``: corrupt
    ranges were zeroed / no sidecar existed — ``report`` lists the
    damage)."""

    grid: object
    header: bytes
    step: int
    path: str
    report: "resilience.SalvageReport"
    salvaged: bool = False


def resume_latest(dirpath, cell_data, *, stem: str | None = None,
                  device=None, header_size: int = 0, variable=None,
                  salvage: bool = True):
    """Resume from the best checkpoint in ``dirpath``: the newest one
    that passes CRC verification, falling back to older verified ones,
    and — with ``salvage`` (default) — last to a salvage load
    (``strict=False``) of the newest salvageable file. Returns a
    :class:`ResumeInfo` (grid reconstructed from nothing but the
    file, via :func:`dccrg_tpu_torch.resilience.load_checkpoint` /
    ``load_grid``) or None when the directory holds no usable
    checkpoint.

    CHAIN-AWARE: a delta entry loads by verifying and replaying its
    whole keyframe+delta chain, bitwise identical to an uninterrupted
    run's full save. A broken link surfaces as a typed
    :class:`~dccrg_tpu_torch.resilience.DeltaChainError` naming the link;
    the walk then continues to OLDER entries — which IS the fall-back
    to the last verifying chain prefix (the delta just before the
    break) and ultimately the keyframe."""
    entries = list_checkpoints(dirpath, stem)
    skipped = []
    for step, path in entries:  # newest first: strict, CRC-verified
        try:
            grid, header, report = resilience.load_checkpoint(
                path, cell_data, device=device, header_size=header_size,
                variable=variable, strict=True)
        except resilience.CheckpointCorruptionError as e:
            skipped.append((path, str(e)))
            continue
        except Exception as e:  # noqa: BLE001 - fall back to older
            skipped.append((path, f"failed to load: {e}"))
            continue
        if skipped:
            logger.warning(
                "resume_latest: skipped %d newer checkpoint(s) that "
                "failed verification: %s", len(skipped),
                [p for p, _ in skipped])
        return ResumeInfo(grid, header, step, path, report)
    if salvage:
        for step, path in entries:  # newest first: salvage what loads
            try:
                grid, header, report = resilience.load_checkpoint(
                    path, cell_data, device=device, header_size=header_size,
                    variable=variable, strict=False)
            except Exception as e:  # noqa: BLE001 - keep walking back
                skipped.append((path, f"salvage failed: {e}"))
                continue
            logger.warning(
                "resume_latest: NO checkpoint verifies; salvaged %s "
                "(%d corrupt cell(s) restored with defaults)", path,
                len(report.corrupt_cells))
            return ResumeInfo(grid, header, step, path, report,
                              salvaged=True)
    if entries:
        logger.error("resume_latest: no usable checkpoint in %s (%s)",
                     dirpath, skipped)
    return None


# ---------------------------------------------------------------------
# the supervised runner
# ---------------------------------------------------------------------

class _StoreRunner(resilience.ResilientRunner):
    """A :class:`~dccrg_tpu_torch.resilience.ResilientRunner` whose periodic
    checkpoints land in the supervisor's :class:`CheckpointStore` as
    numbered per-step files — dirty-field DELTAS chained to periodic
    keyframes (:meth:`CheckpointStore.save`) — with rollback always
    targeting the newest save (chain-aware when it is a delta) and
    retention GC after each save."""

    def __init__(self, sup, grid, step_fn, **kw):
        self._sup = sup
        super().__init__(grid, step_fn, sup.store.path_for(0), **kw)

    def _write_checkpoint(self):
        # retention GC rides the save as its ``post`` hook: inline
        # after a synchronous save (the pre-async behavior), chained
        # onto the writer thread after an async one — either way GC
        # only ever sees a fully published store
        step = self.step
        return self._sup.store.save(
            self.grid, step, header=self.header, variable=self.variable,
            post=lambda: self._sup._after_save(step))

    def _active_saver(self, create: bool = False):
        return self._sup.store._saver


class SupervisedRunner:
    """Run a step loop that survives preemption, wedged steps and
    transient dispatch faults — :class:`~dccrg_tpu_torch.resilience
    .ResilientRunner` (watchdog, rollback, trip consensus) wrapped
    with the run-lifecycle machinery the module docstring describes.

    ``step_fn(grid, step_index)`` is the user's step, exactly as for
    ``ResilientRunner``; periodic checkpoints land in
    ``checkpoint_dir`` as numbered files. On preemption (SIGTERM /
    SIGINT / :func:`request_preempt` / a faked
    ``FaultPlan.preempt_signal``) the run stops at the next step
    boundary (consensus-agreed in a process group, so all ranks stop
    together), takes a CRC-verified emergency checkpoint inside
    the ``grace`` window and raises :class:`PreemptedError` (exit
    code :data:`RESUMABLE_EXIT`). Restart the job and pick the run
    back up with :func:`resume_latest` + ``start_step=info.step``; a
    resumed run reconverges bitwise with an uninterrupted one.

    Keyword knobs (None = the env default): ``step_timeout``
    (``DCCRG_STEP_TIMEOUT``; 0 disables the per-step deadline thread
    entirely), ``checkpoint_seconds`` (``DCCRG_CKPT_SECONDS``;
    wall-clock checkpoint cadence for uneven step times — monotonic
    clock, step boundaries only, 0 keeps the step-count cadence),
    ``grace`` (``DCCRG_PREEMPT_GRACE``), ``keep_last``
    (``DCCRG_KEEP_LAST``) / ``keep_every`` (retention),
    ``dispatch_retries`` / ``dispatch_backoff`` (transient-error
    retry). Remaining keyword arguments (``fields``, ``check_every``,
    ``checkpoint_every``, ``max_retries``, ``backoff``, ``header``,
    ``variable``, ``diagnostics_dir``) pass through to
    ``ResilientRunner``. Per-step wall times are recorded into
    :meth:`latency_histogram` log-spaced buckets."""

    def __init__(self, grid, step_fn, checkpoint_dir, *, stem="ckpt",
                 step_timeout=None, dispatch_retries=2,
                 dispatch_backoff=0.05, keep_last=None, keep_every=0,
                 grace=None, signals=None, install_signal_handlers=True,
                 start_step=0, checkpoint_seconds=None, **runner_kw):
        self.grid = grid
        self.step_fn = step_fn
        self.store = CheckpointStore(checkpoint_dir, stem=stem)
        self.step_timeout = (step_timeout_default() if step_timeout is None
                             else float(step_timeout))
        # wall-clock checkpoint cadence (DCCRG_CKPT_SECONDS): uneven
        # step times make a step-count cadence either too chatty or
        # too sparse; the runner checks the monotonic clock at step
        # boundaries only (never mid-step, consensus-agreed in a
        # process group; see ResilientRunner)
        runner_kw.setdefault(
            "checkpoint_seconds",
            ckpt_seconds_default() if checkpoint_seconds is None
            else float(checkpoint_seconds))
        self._latency = LatencyHistogram()
        self.dispatch_retries = int(dispatch_retries)
        self.dispatch_backoff = float(dispatch_backoff)
        self.keep_last = (keep_last_default() if keep_last is None
                          else max(1, int(keep_last)))
        self.keep_every = int(keep_every)
        self.grace = preempt_grace() if grace is None else float(grace)
        self.signals = (tuple(signals) if signals is not None
                        else (signal.SIGTERM, signal.SIGINT))
        self._install = bool(install_signal_handlers)
        runner_kw.setdefault("diagnostics_dir", self.store.dir)
        self._runner = _StoreRunner(self, grid, self._dispatch,
                                    interrupt_poll=self._poll,
                                    **runner_kw)
        self._runner.step = int(start_step)
        self.preempted = False
        self.emergency_checkpoint = None
        self.dispatch_retried = 0  # transient errors retried through

    # -- mirrors of the inner runner's story --------------------------

    @property
    def runner(self):
        return self._runner

    @property
    def step(self):
        return self._runner.step

    @property
    def trips(self):
        return self._runner.trips

    @property
    def rollbacks(self):
        return self._runner.rollbacks

    @property
    def checkpoints(self):
        return self._runner.checkpoints

    def latency_histogram(self) -> list:
        """Per-step wall-time distribution as ``[(lo_s, hi_s, count)]``
        log-spaced buckets (see :class:`LatencyHistogram`); a summary
        line is logged automatically when a step wedges into
        :class:`StepTimeoutError`, so the latency trend that preceded
        the wedge is on record."""
        return self._latency.buckets()

    # -- the lifecycle ------------------------------------------------

    def run(self, n_steps: int) -> "SupervisedRunner":
        """Advance to ``n_steps`` total steps under supervision.
        Raises :class:`PreemptedError` after the emergency checkpoint
        when preempted; :class:`StepTimeoutError` when a step wedges
        past the deadline; whatever ``ResilientRunner`` raises
        otherwise."""
        ctx = (preemption_handlers(self.signals) if self._install
               else nullcontext())
        with ctx:
            try:
                self._runner.run(n_steps)
            except resilience.RunInterrupted as e:
                path, clean = self._emergency_checkpoint(e.step)
                # the preemption has been honored (checkpoint taken):
                # consume the flag HERE, not only in the handler
                # context — with install_signal_handlers=False a stale
                # flag would otherwise re-preempt every later run in
                # this process at its first boundary
                clear_preempt()
                self.preempted = True
                self.emergency_checkpoint = path
                raise PreemptedError(e.step, checkpoint=path,
                                     clean=clean) from e
        return self

    # -- step dispatch: deadline + transient retry --------------------

    def _poll(self) -> bool:
        m = coord.get_membership()
        if m is not None:
            # elastic-fleet liveness at the supervision poll boundary
            # (throttled): a supervised run under a registered
            # membership keeps its heartbeat lease fresh even when
            # the inner runner loop is replaced/overridden
            m.heartbeat()
        if faults.take_preempt(self._runner.step):
            request_preempt()
        return _PREEMPT.is_set()

    def _dispatch(self, grid, i):
        # a real transient error typically surfaces at the
        # synchronization AFTER step_fn replaced grid.data's tensors,
        # so a blind re-dispatch would double-apply the step; the
        # dict-of-refs snapshot rewinds it. Writers that change a
        # tensor in place clone it first while its id is in
        # grid._txn_frozen (Grid._own), so the snapshot's tensors stay
        # unchanged through the step. (Structural mutations inside
        # step_fn are transactional and never classify as transient.)
        before = dict(grid.data)
        for attempt in range(self.dispatch_retries + 1):
            guard = not getattr(grid, "_txn_depth", 0)
            if guard:
                grid._txn_frozen = {id(t) for t in before.values()}
            try:
                faults.fire("supervise.dispatch", step=i, attempt=attempt)
                self._timed_step(grid, i)
                return
            except Exception as e:  # noqa: BLE001 - filtered just below
                if (not _is_transient_dispatch(e)
                        or attempt >= self.dispatch_retries):
                    raise
                grid.data = dict(before)
                self.dispatch_retried += 1
                delay = self.dispatch_backoff * (2 ** attempt)
                logger.warning(
                    "transient dispatch error at step %d (%s); retry "
                    "%d/%d in %.2fs", i, e, attempt + 1,
                    self.dispatch_retries, delay)
                time.sleep(delay)
            finally:
                if guard:
                    grid._txn_frozen = None

    def _timed_step(self, grid, i):
        t0 = time.perf_counter()
        try:
            with telemetry.span("step"):
                self._timed_step_inner(grid, i)
        except StepTimeoutError:
            self._record_latency(time.perf_counter() - t0)
            # the latency trend BEFORE the wedge is the diagnosis: a
            # slowly degrading interconnect shows as mass migrating
            # into the slow buckets over the preceding steps
            logger.warning("step %d wedged; latency so far: %s",
                           i, self._latency.summary())
            raise
        else:
            self._record_latency(time.perf_counter() - t0)

    def _record_latency(self, seconds: float) -> None:
        self._latency.record(seconds)
        # the same measurement feeds the process-wide registry, so
        # dump_prometheus carries the step-latency distribution too
        telemetry.observe("dccrg_step_seconds", seconds)

    def _timed_step_inner(self, grid, i):
        timeout = self.step_timeout
        hang = faults.take_step_hang(i)
        if timeout <= 0:
            if hang is not None and math.isinf(hang):
                raise RuntimeError(
                    "FaultPlan.step_hang fired but no step deadline is "
                    "configured (DCCRG_STEP_TIMEOUT / step_timeout): "
                    "the injected wedge would block forever")
            if hang:
                time.sleep(hang)
            self.step_fn(grid, i)  # zero-overhead path: no thread
            return

        def _one():
            if hang is not None:
                # the injected wedge replaces the dispatch inside the
                # worker thread (same discipline as barrier_hang), so
                # the deadline machinery itself is what gets
                # exercised; a finite hang below the deadline models
                # a slow-but-alive step that still completes
                time.sleep(min(hang, timeout + 30.0))
                if math.isinf(hang):
                    return
            dev = getattr(grid, "device", None)
            if dev is None or dev.type != "cuda":
                self.step_fn(grid, i)
                return
            # the worker thread's current card is the grid's; launches
            # are asynchronous and would hide a wedged step until
            # somebody blocks, so the deadline covers the synchronize
            with torch.cuda.device(dev):
                self.step_fn(grid, i)
                torch.cuda.synchronize(dev)

        _under_deadline(_one, timeout, f"step {i}", step=i)

    # -- preemption: the emergency checkpoint -------------------------

    def _emergency_checkpoint(self, step: int):
        """The whole emergency save (the ordinary atomic checkpoint,
        two-phase under a process split, plus its CRC verification)
        runs under the ``grace`` deadline with shortened barrier
        timeouts. If it cannot finish (a dead peer, a wedged device
        pull), the LAST PERIODIC checkpoint is the resume point: the
        grace window belongs to the exit, not to the save."""
        r = self._runner
        # drain the periodic writer first: the emergency save itself
        # stays SYNCHRONOUS (it is deadline-bounded and must be
        # durable before the resumable exit), and a failed in-flight
        # write re-points the fallback at the last durable checkpoint
        # (resumability outranks the report — swallow)
        r._drain_saves(swallow=True)
        path = self.store.path_for(step)

        def _save():
            dev = getattr(self.grid, "device", None)
            ctx = (torch.cuda.device(dev)
                   if dev is not None and dev.type == "cuda"
                   else nullcontext())
            with ctx:
                resilience.save_checkpoint(self.grid, path,
                                           header=r.header,
                                           variable=r.variable)
            bad = resilience.verify_checkpoint(path)
            if bad:
                raise resilience.CheckpointCorruptionError(
                    f"emergency checkpoint {path} failed its own "
                    f"verification (chunks {bad})", bad_chunks=bad)

        try:
            t0 = time.perf_counter()
            with telemetry.span("ckpt.emergency"), _grace_env(self.grace):
                _under_deadline(_save, self.grace,
                                f"emergency checkpoint at step {step}",
                                step=step)
            # the deadline-bounded save+verify cost, distinct from the
            # periodic kinds: how much of the grace window a preempt
            # actually spends (a controller/operator input)
            telemetry.observe("dccrg_ckpt_save_seconds",
                              time.perf_counter() - t0,
                              kind="emergency")
        except Exception as e:  # noqa: BLE001 - resumability outranks it
            logger.error(
                "emergency checkpoint failed (%s); the last periodic "
                "checkpoint %s (step %s) is the resume point", e,
                r.checkpoint_path, r._ckpt_step)
            return r.checkpoint_path, False
        logger.warning(
            "preempted: emergency checkpoint %s (step %d) verified; "
            "exiting resumable (%d)", path, step, RESUMABLE_EXIT)
        return path, True

    # -- retention ----------------------------------------------------

    def _after_save(self, step: int) -> None:
        """Retention GC after every periodic save. Filesystem-only (no
        barriers), so only one rank prunes; ``keep_last >= 1`` plus
        the only-verifiable guard means the newest checkpoint — the
        one a peer may be rolling back to — is never touched."""
        if self.grid._multiproc and coord.process_rank(self.grid) != 0:
            return
        try:
            rep = self.store.gc(keep_last=self.keep_last,
                                keep_every=self.keep_every, apply=True,
                                assume_ok=step)
        except OSError as e:  # GC must never kill the run
            logger.warning("retention GC failed (%s); continuing", e)
            return
        if rep.dropped or rep.stale_temps:
            logger.info(
                "retention GC: pruned %d checkpoint(s) and %d stale "
                "temp file(s); %d kept", len(rep.dropped),
                len(rep.stale_temps), len(rep.kept))
        # save boundaries are the supervised loop's natural metrics
        # cadence (one None check without DCCRG_METRICS_FILE)
        telemetry.maybe_export_metrics()
