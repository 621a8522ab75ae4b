"""Warm-start resilience: a crash-consistent cache of kernel builds and
pre-warmed bucket program pools.

A fresh or rejoining host of the elastic fleet pays for its programs
before its first dispatch: an ``nvcc`` build of each CUDA kernel its
buckets launch (seconds each) and each bucket's program construction
(the template grid's plan, the step closures). Churn puts that cost
exactly where the fleet is weakest. This module closes the cold-start
half of the streaming front door:

**Persistent build cache** — ``DCCRG_COMPILE_CACHE=<dir>`` points the
kernel builds (:mod:`dccrg_tpu_torch.ops._build`) at ``<dir>/build``:
libraries keep their source-and-flags hash names and their
temp-then-rename publish, so two processes sharing the directory race
safely and a host that finds a library there loads it without
``nvcc``. Next to it lives the **program-key manifest**: one
CRC-framed record per (shape, periodicity, schema, kernel, dtype,
capacity, integrity-flag, bulk) bucket key ever served, with the file
name of the kernel library a bulk bucket launches, written with the
intake spool's durability discipline (temp sibling + fsync + atomic
rename — :func:`dccrg_tpu_torch.coord.atomic_file_write`), so two ranks
on one host race safely (last complete writer wins) and a crashed
writer leaves either the old intact record or invisible temp litter,
never a torn visible one. Every record is stamped with a **cache
epoch** derived from the torch/CUDA/package versions: a drifted cache
is *rejected to a cold build*, never trusted. A torn or corrupt record
is convicted by its CRC frame (typed :class:`WarmCacheError`),
quarantined under ``<dir>/quarantine/`` and degraded to cold — no
crash, no wrong program, no silent warm claim.

**Warm bucket pools** — at boot (and on an elastic rejoin) a
:class:`WarmPool` replays the manifest most-recently-served first and
builds each known bucket's programs on a background thread
(:class:`dccrg_tpu_torch.background.PrewarmWorker`: abortable,
bitwise-neutral, host work only). A prewarm builds the bucket's
template grid on the host, constructs the program tuple
``GridBatch._build_programs`` returns (the same function, so the same
programs: bitwise pin in tests/test_torch_warmstart.py) and loads —
building when ``build/`` lacks it — the kernel library a bulk bucket
launches. It launches nothing on the device: a table program uploads
its neighbour tables at its first dispatch, on the serving thread. The
fleet's program cache consults :func:`take_prewarmed` before building,
so a warm host's first dispatch skips the build.
:class:`~dccrg_tpu_torch.scheduler.SLOPolicy` consults
:meth:`WarmPool.projection_cost` so an un-warmed bucket's projected
completion is charged its measured cold-build cost up front instead of
discovering it mid-tick.

Every warm/cold/reject/quarantine decision is journaled through the
autopilot (``warmstart.cache`` / ``warmstart.gc`` rules) and
replayable via ``python -m dccrg_tpu_torch.autopilot explain``.
Retention GC (``python -m dccrg_tpu_torch.warmstart gc``, dry-run by
default) prunes least-recently-hit entries and the oldest libraries
under size/age bounds, sweeps dead-pid temp litter (the
``checkpoint.stale_temp_files`` pattern) and never touches a key
currently being pre-warmed.

OFF by default: with ``DCCRG_COMPILE_CACHE`` unset nothing here is
constructed, kernels build into ``dccrg_tpu_torch/_build/`` and the
serving stack is bitwise identical to before (the negative pin).
``DCCRG_WARM_POOL=0`` keeps the persistent cache but disables the
background prewarm pool.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time

from . import background, coord, faults, telemetry
from .autopilot import key_id

logger = logging.getLogger("dccrg_tpu_torch.warmstart")

#: manifest record layout version — part of the cache epoch, so a
#: layout change rejects old records instead of misreading them
MANIFEST_SCHEMA = 1

MANIFEST_DIR = "manifest"
BUILD_DIR = "build"
QUARANTINE_DIR = "quarantine"
RECORD_SUFFIX = ".rec"


class WarmCacheError(RuntimeError):
    """A persisted warm-start artifact could not be trusted (torn or
    corrupt manifest record, cache-epoch drift, registry drift, I/O
    failure, a failed prewarm build). Always degrades to a cold build —
    the error names the
    convicted entry and why; it is never allowed to take serving
    down."""

    def __init__(self, key: str, detail: str):
        super().__init__(f"warm cache entry {key!r}: {detail}")
        self.key = str(key)
        self.detail = str(detail)


# ---------------------------------------------------------------------
# env knobs
# ---------------------------------------------------------------------

def cache_dir_default():
    """``DCCRG_COMPILE_CACHE``: the persistent cache directory, or
    None (the negative pin: unset means nothing here exists)."""
    v = os.environ.get("DCCRG_COMPILE_CACHE", "").strip()
    return v or None


def warm_pool_default(default: bool = True) -> bool:
    """``DCCRG_WARM_POOL``: whether an attached pool starts the
    background prewarm sweep (default on when a cache dir is
    configured; ``0`` keeps the disk cache only)."""
    v = os.environ.get("DCCRG_WARM_POOL", "").strip().lower()
    if v in ("0", "off", "false", "no"):
        return False
    if v in ("1", "on", "true", "yes"):
        return True
    return default


def gc_max_bytes_default():
    """``DCCRG_WARM_GC_BYTES``: retention size bound (0/unset =
    unbounded)."""
    try:
        v = int(os.environ.get("DCCRG_WARM_GC_BYTES", "0"))
    except ValueError:
        return None
    return v if v > 0 else None


def gc_max_age_default():
    """``DCCRG_WARM_GC_AGE_S``: retention age bound in seconds
    (0/unset = unbounded)."""
    try:
        v = float(os.environ.get("DCCRG_WARM_GC_AGE_S", "0"))
    except ValueError:
        return None
    return v if v > 0 else None


def cache_epoch() -> str:
    """The version fingerprint every manifest record is stamped with.
    Any drift — torch, its CUDA, the package, the record layout —
    changes the epoch, and a record from another epoch is REJECTED to a
    cold build: a persisted program key must never vouch for a build a
    different stack made."""
    import hashlib

    import torch

    tv = str(torch.__version__)
    cv = str(torch.version.cuda)
    pkg = sys.modules.get(__package__)
    pv = str(getattr(pkg, "__version__", "0"))
    seed = f"torch={tv}:cuda={cv}:pkg={pv}:schema={MANIFEST_SCHEMA}"
    return hashlib.sha1(seed.encode("utf-8")).hexdigest()[:16]


# ---------------------------------------------------------------------
# bucket-key (de)serialization
# ---------------------------------------------------------------------

def bucket_payload(bucket_key):
    """The JSON-faithful form of a :meth:`~dccrg_tpu_torch.fleet.FleetJob
    .bucket_key`, or None for a callable kernel (identity-bucketed
    callables cannot survive a process restart, so they are never
    manifested — they simply stay cold)."""
    (length, periodic, hood_len, schema, kernel,
     fin, fout, n_params) = bucket_key
    if callable(kernel):
        return None
    return {
        "length": [int(v) for v in length],
        "periodic": [bool(v) for v in periodic],
        "hood_len": int(hood_len),
        "schema": [[str(n), [int(s) for s in shape], str(d)]
                   for n, shape, d in schema],
        "kernel": str(kernel),
        "fields_in": [str(f) for f in fin],
        "fields_out": [str(f) for f in fout],
        "n_params": int(n_params),
    }


def bucket_from_payload(p) -> tuple:
    """Invert :func:`bucket_payload` back to the hashable tuple form
    (raises KeyError/TypeError on a malformed payload — the loader
    maps those to :class:`WarmCacheError`)."""
    return (
        tuple(int(v) for v in p["length"]),
        tuple(bool(v) for v in p["periodic"]),
        int(p["hood_len"]),
        tuple(sorted((str(n), tuple(int(s) for s in shape), str(d))
                     for n, shape, d in p["schema"])),
        str(p["kernel"]),
        tuple(str(f) for f in p["fields_in"]),
        tuple(str(f) for f in p["fields_out"]),
        int(p["n_params"]),
    )


def job_for_bucket(bucket_key):
    """Reconstruct a prototype :class:`~dccrg_tpu_torch.fleet.FleetJob`
    from a manifested bucket key, and PROVE the reconstruction by
    round-tripping its own ``bucket_key()`` — if the kernel-spec
    registry drifted since the record was written (renamed kernel,
    changed schema), the mismatch is a typed :class:`WarmCacheError`
    and the key falls cold instead of pre-compiling a wrong
    program."""
    from . import fleet

    (length, periodic, hood_len, schema, kernel,
     fin, fout, n_params) = bucket_key
    cell_data = {n: (tuple(shape), d) for n, shape, d in schema}
    try:
        job = fleet.FleetJob(
            "_warm", length=length, kernel=kernel,
            cell_data=cell_data, fields_in=fin, fields_out=fout,
            params=(0.0,) * int(n_params), periodic=periodic,
            hood_len=hood_len, n_steps=0)
        job.resolved_kernel()  # an unknown kernel name fails HERE
    except Exception as e:  # noqa: BLE001 - registry drift
        raise WarmCacheError(str(kernel),
                             f"job reconstruction failed: {e}") from e
    if job.bucket_key() != bucket_key:
        raise WarmCacheError(
            str(kernel),
            "kernel registry drift: reconstructed bucket key differs")
    return job


# ---------------------------------------------------------------------
# the manifest (per-entry sealed records, atomic rename)
# ---------------------------------------------------------------------

def ensure_cache(directory: str) -> str:
    """Create the cache directory tree (idempotent) and point the kernel
    builds at its ``build/`` half."""
    from .ops import _build

    directory = str(directory)
    for d in ("", MANIFEST_DIR, QUARANTINE_DIR, BUILD_DIR):
        os.makedirs(os.path.join(directory, d), exist_ok=True)
    _build.set_build_dir(os.path.join(directory, BUILD_DIR))
    return directory


def entry_path(directory: str, kid: str) -> str:
    return os.path.join(directory, MANIFEST_DIR, kid + RECORD_SUFFIX)


def write_entry(directory: str, kid: str, entry: dict) -> str:
    """Durably land one manifest record (concurrent writers safe: the
    per-entry atomic rename makes the last COMPLETE writer win). The
    injected fault sites land the three damage classes a reader must
    convict — a torn frame, a corrupted payload byte, a drifted
    epoch."""
    faults.fire("warm.cache.io", op="write")
    rec = dict(entry)
    rec.setdefault("epoch", cache_epoch())
    if faults.take_warm_stale(key=kid):
        rec["epoch"] = "0" * 16  # a run on some other compiler stack
    sealed = coord.seal_record(json.dumps(rec, sort_keys=True))
    if faults.take_warm_torn(key=kid):
        sealed = sealed[:max(1, len(sealed) // 2)]
    elif faults.take_warm_corrupt(key=kid):
        # flip one payload byte INSIDE the frame: the record still
        # parses as crc:len:payload, the CRC no longer matches
        b = bytearray(sealed.encode("utf-8"))
        b[-1] ^= 0x01
        sealed = b.decode("utf-8", errors="replace")
    path = entry_path(directory, kid)
    return coord.atomic_file_write(
        path, sealed, tmp_dir=os.path.dirname(path))


def read_entry(path: str) -> dict:
    """Read + verify one manifest record; raises
    :class:`WarmCacheError` naming the record for every way it can be
    untrustworthy (torn frame, bad JSON, epoch drift, malformed
    key)."""
    kid = os.path.basename(path)
    if kid.endswith(RECORD_SUFFIX):
        kid = kid[:-len(RECORD_SUFFIX)]
    faults.fire("warm.cache.io", op="read", key=kid)
    try:
        payload = coord.read_sealed_file(path, key=kid)
    except coord.TornRecordError as e:
        raise WarmCacheError(kid, f"torn record ({e})") from e
    try:
        rec = json.loads(payload)
    except ValueError as e:
        raise WarmCacheError(kid, f"undecodable payload ({e})") from e
    if rec.get("epoch") != cache_epoch():
        raise WarmCacheError(
            kid, f"cache epoch drift ({rec.get('epoch')!r} != "
                 f"{cache_epoch()!r})")
    try:
        rec["_bucket"] = bucket_from_payload(rec["key"])
        rec["capacity"] = int(rec["capacity"])
    except (KeyError, TypeError, ValueError) as e:
        raise WarmCacheError(kid, f"malformed key ({e})") from e
    rec["_kid"] = kid
    return rec


def quarantine_entry(directory: str, path: str, err) -> str:
    """Move a convicted record out of the manifest (best-effort: a
    second rank may have quarantined it first). Returns the
    quarantine path."""
    dst = os.path.join(directory, QUARANTINE_DIR,
                       os.path.basename(path))
    try:
        os.replace(path, dst)
    except OSError:
        pass
    telemetry.inc("dccrg_warm_quarantined_total")
    logger.warning("warmstart: quarantined %s (%s)", path, err)
    return dst


def load_manifest(directory: str):
    """Load every trustworthy manifest record. Returns ``(entries,
    rejects)``: ``entries`` maps kid -> record, ``rejects`` is
    ``[(path, WarmCacheError)]`` for every record that was convicted
    (the caller quarantines + journals them — the load itself never
    raises on damage, only on a missing directory)."""
    entries, rejects = {}, []
    mdir = os.path.join(str(directory), MANIFEST_DIR)
    try:
        faults.fire("warm.cache.io", op="scan")
        names = sorted(os.listdir(mdir))
    except OSError as e:
        return {}, [(mdir, WarmCacheError(mdir, f"scan failed: {e}"))]
    for name in names:
        if not name.endswith(RECORD_SUFFIX):
            continue
        path = os.path.join(mdir, name)
        try:
            rec = read_entry(path)
        except WarmCacheError as e:
            rejects.append((path, e))
            continue
        except OSError as e:
            rejects.append((path, WarmCacheError(
                name, f"unreadable ({e})")))
            continue
        entries[rec["_kid"]] = rec
    return entries, rejects


# ---------------------------------------------------------------------
# the active pool (consulted by fleet.GridBatch._programs)
# ---------------------------------------------------------------------

_POOL: "WarmPool | None" = None


def active() -> "WarmPool | None":
    return _POOL


def activate(pool) -> None:
    global _POOL
    _POOL = pool


def deactivate(pool=None) -> None:
    """Clear the active pool (idempotent; with ``pool`` given, only
    if it is still the active one — a newer pool wins)."""
    global _POOL
    if pool is None or _POOL is pool:
        _POOL = None


def take_prewarmed(prog_key, device=None):
    """The fleet program cache's warm lookup: the prewarmed program
    tuple for ``prog_key`` (what ``GridBatch._build_programs`` returned
    on the prewarm thread, its kernel library already loaded), or None —
    no pool, key not warmed yet, or a device other than the pool's (the
    caller then builds cold). Zero branches beyond a module-global None
    check when no cache is configured."""
    pool = _POOL
    if pool is None:
        return None
    return pool.take(prog_key, device=device)


class WarmPool:
    """The warm bucket pool over one persistent cache directory.

    Lifecycle: construct (loads + convicts the manifest),
    :meth:`attach` to a scheduler (adopts its autopilot/device, hooks
    the SLO policy's cold-cost projection, activates the module-level
    lookup and starts the background prewarm sweep), serve. All
    shared state is lock-guarded: the prewarm thread publishes
    finished programs while the serving thread takes them."""

    def __init__(self, directory, *, device=None, autopilot=None,
                 start_pool=None):
        self.dir = ensure_cache(directory)
        self.device = device
        self.autopilot = autopilot
        self.start_pool = (warm_pool_default() if start_pool is None
                           else bool(start_pool))
        self.t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._ready: dict = {}    # program key -> program tuple
        self._warm_buckets: set = set()  # bucket keys with a ready program
        self._served: set = set()        # program keys served warm
        self._inflight: set = set()      # kids being prewarmed (GC guard)
        self._worker = None
        self._first_ready = None
        self.errors: list = []    # [(kid, WarmCacheError)] degradations
        self.entries: dict = {}
        self._queue: list = []    # prewarm order (kids, front first)
        self._load()

    # -- construction -------------------------------------------------

    @staticmethod
    def from_env():
        """A pool over ``DCCRG_COMPILE_CACHE``, or None when unset —
        the negative pin: no env, no pool, no new branches
        anywhere."""
        d = cache_dir_default()
        return WarmPool(d) if d else None

    def _load(self) -> None:
        self.entries, rejects = load_manifest(self.dir)
        for path, err in rejects:
            self._degrade(err, path=path)
        # most-recently-served first: the keys live traffic needed
        # last are the ones a rejoining host needs first
        self._queue = [kid for kid, _e in sorted(
            self.entries.items(),
            key=lambda kv: (-float(kv[1].get("last_hit", 0.0)),
                            -int(kv[1].get("hits", 0)), kv[0]))]

    def attach(self, sched) -> None:
        """Adopt the scheduler's autopilot (one journal) and first
        device lane, charge un-warmed buckets their cold cost in its
        SLO projection, and start the prewarm sweep."""
        if self.autopilot is None:
            self.autopilot = sched.autopilot
        if self.device is None and sched.devices:
            self.device = sched.devices[0]
        sched.slo.warm_cost = self.projection_cost
        activate(self)
        if self.start_pool:
            self.prewarm()

    def close(self) -> None:
        """Abort the prewarm sweep and release the module-level
        lookup (tests construct many pools; the last closed must not
        leak into the next scheduler)."""
        if self._worker is not None:
            self._worker.stop()
        deactivate(self)

    # -- degradation + journaling -------------------------------------

    def _journal(self, decision: str, kid: str, **inputs) -> None:
        telemetry.inc("dccrg_warm_decisions_total", decision=decision)
        if self.autopilot is not None:
            self.autopilot.record_warm(decision, kid, inputs)

    def _degrade(self, err, *, path=None, kid=None) -> None:
        """A warm artifact could not be trusted: quarantine it (when
        it is a file), journal the decision, count it, keep serving —
        the typed error is recorded on :attr:`errors`, never
        raised."""
        kid = kid or getattr(err, "key", "?")
        telemetry.inc("dccrg_warm_cache_errors_total")
        self.errors.append((kid, err))
        decision = "quarantine" if path is not None else "reject"
        if path is not None:
            quarantine_entry(self.dir, path, err)
        self._journal(decision, kid,
                      error=type(err).__name__,
                      detail=str(getattr(err, "detail", err))[:200])

    # -- the prewarm sweep --------------------------------------------

    def prewarm(self, block: bool = False):
        """Prewarm every manifested bucket's programs, most recently
        served first. ``block=True`` runs inline (tests, CLI) and
        propagates an injected rank death; the default starts one
        abortable :class:`~dccrg_tpu_torch.background.PrewarmWorker`."""
        if block:
            self._prewarm_run(threading.Event())
            return None
        if self._worker is not None and not self._worker.ready():
            return self._worker
        self._worker = background.PrewarmWorker(self._prewarm_run)
        return self._worker.start()

    def _prewarm_run(self, abort) -> None:
        while True:
            with self._lock:
                if abort.is_set() or not self._queue:
                    return
                kid = self._queue.pop(0)
                entry = self.entries.get(kid)
            if entry is None:
                continue
            # a real death window between two prewarms: the
            # manifest + cache dir must stay loadable for the NEXT
            # boot (InjectedRankDeath propagates; everything else
            # degrades this one key to cold)
            faults.fire("warm.prewarm", key=kid)
            t0 = time.perf_counter()
            try:
                self._compile_one(kid, entry)
            except faults.InjectedRankDeath:
                raise
            except WarmCacheError as e:
                self._degrade(e, kid=kid)
                continue
            except Exception as e:  # noqa: BLE001 - degrade, never crash
                self._degrade(WarmCacheError(kid, f"prewarm failed: "
                                                  f"{e}"), kid=kid)
                continue
            telemetry.observe("dccrg_prewarm_seconds",
                              time.perf_counter() - t0, key=kid)

    def _compile_one(self, kid: str, entry: dict) -> None:
        from . import fleet

        with self._lock:
            self._inflight.add(kid)
        try:
            job = job_for_bucket(entry["_bucket"])
            # a skeleton batch: program-construction inputs only (the
            # template grid's host plan, the schema), no [capacity, R]
            # state; building its programs launches nothing on the
            # device and loads (or builds) a bulk bucket's kernel
            batch = fleet.GridBatch(job, entry["capacity"], self.device,
                                    skeleton=True,
                                    bulk=bool(entry.get("bulk", True)))
            key = batch._program_key()
            with self._lock:
                if key in self._ready:
                    return
            programs = batch._build_programs(key)
            with self._lock:
                self._ready[key] = programs
                self._warm_buckets.add(batch.key)
            telemetry.inc("dccrg_warm_prewarmed_total")
        finally:
            with self._lock:
                self._inflight.discard(kid)

    # -- serving-side hooks -------------------------------------------

    def take(self, prog_key, device=None):
        with self._lock:
            hit = self._ready.get(prog_key)
        if hit is None:
            return None
        if (device is not None and self.device is not None
                and _as_device(device) != _as_device(self.device)):
            return None
        with self._lock:
            self._served.add(prog_key)
        return hit

    def warm_ready(self, bucket_key) -> bool:
        """Whether a prewarmed program exists for this bucket key
        (any capacity variant) — the scheduler-admission signal."""
        with self._lock:
            return bucket_key in self._warm_buckets

    def projection_cost(self, bucket_key) -> float:
        """The :class:`~dccrg_tpu_torch.scheduler.SLOPolicy` hook: the
        extra seconds a job of this bucket key should be charged up
        front — 0.0 once a warm program is ready (or for a key the
        manifest has never measured), else the recorded cold-build
        cost (``compile_s``)."""
        if self.warm_ready(bucket_key):
            return 0.0
        best = 0.0
        with self._lock:
            for e in self.entries.values():
                if e.get("_bucket") == bucket_key:
                    best = max(best, float(e.get("compile_s", 0.0)))
        return best

    def note_incoming(self, bucket_key) -> None:
        """An intake admission saw this bucket key: move its
        manifest entries to the FRONT of the prewarm queue — the
        stream knows better than the hit counters what is about to
        dispatch."""
        payload = bucket_payload(bucket_key)
        if payload is None:
            return
        with self._lock:
            front = [kid for kid in self._queue
                     if self.entries.get(kid, {}).get("_bucket")
                     == bucket_key]
            if front:
                rest = [kid for kid in self._queue
                        if kid not in front]
                self._queue = front + rest

    def note_dispatch(self, batch, seconds: float) -> None:
        """The scheduler's first-dispatch hook for a batch instance:
        classify it warm (a prewarmed program was served — the
        dispatch paid no build) or cold (measured ``seconds``
        carries the build), journal the decision, publish the
        first-dispatch-ready gauge and upsert the manifest record —
        all best-effort: a failing cache/manifest write leaves
        serving at zero trips (the telemetry-exporter discipline)."""
        prog_key = batch._program_key()
        warm = prog_key in self._served
        kid = key_id((batch.key, batch.capacity))
        telemetry.inc("dccrg_warm_hits_total" if warm
                      else "dccrg_warm_misses_total")
        if self._first_ready is None:
            self._first_ready = time.perf_counter() - self.t0
            telemetry.set_gauge(
                "dccrg_warm_first_dispatch_ready_seconds",
                self._first_ready)
        self._journal("warm" if warm else "cold", kid,
                      seconds=round(float(seconds), 6),
                      capacity=int(batch.capacity))
        payload = bucket_payload(batch.key)
        if payload is None:
            return  # identity-bucketed callable: never manifested
        try:
            with self._lock:
                old = self.entries.get(kid, {})
                entry = {
                    "epoch": cache_epoch(),
                    "key": payload,
                    "capacity": int(batch.capacity),
                    "integrity": bool(prog_key[2]),
                    "bulk": bool(prog_key[3]),
                    # the kernel library a bulk bucket launches: a warm
                    # host whose build/ lacks it builds it in the sweep
                    "library": _library_name(batch),
                    "hits": int(old.get("hits", 0)) + 1,
                    "last_hit": round(time.time(), 3),
                    "compile_s": (float(old.get("compile_s", 0.0))
                                  if warm else round(float(seconds),
                                                     6)),
                }
                write_entry(self.dir, kid, entry)
                entry["_bucket"] = batch.key
                entry["_kid"] = kid
                self.entries[kid] = entry
        except (OSError, faults.InjectedIOError) as e:
            self._degrade(WarmCacheError(kid, f"manifest write "
                                              f"failed: {e}"),
                          kid=kid)

    # -- retention ----------------------------------------------------

    def gc(self, *, max_bytes=None, max_age_s=None, dry_run=True):
        """Size/age-bounded retention over this pool's cache dir.
        Keys currently being pre-warmed (or queued for it) are
        protected; applied prunes are journaled through the
        ``warmstart.gc`` rule."""
        with self._lock:
            protect = set(self._inflight) | set(self._queue)
        report = gc(self.dir, max_bytes=max_bytes,
                    max_age_s=max_age_s, dry_run=dry_run,
                    protect=protect)
        pruned = report["pruned"]
        if not dry_run:
            with self._lock:
                for kid in report["pruned_kids"]:
                    self.entries.pop(kid, None)
            if pruned and self.autopilot is not None:
                self.autopilot.record_warm_gc(
                    pruned, {"bytes_before": report["bytes_before"],
                             "bytes_after": report["bytes_after"]})
        return report


def _as_device(device):
    """``(type, index)`` of a device spelling: ``"cuda"`` and
    ``"cuda:0"`` name one card."""
    import torch

    d = torch.device(device)
    return d.type, d.index or 0


def _library_name(batch):
    """File name of the kernel library ``batch``'s bulk program
    launches, or None for a table program."""
    if not batch.bulk_active() or batch.device.type != "cuda":
        return None
    from .ops import roll_executor

    return roll_executor.fleet_library_name(
        batch.grid, batch.bulk_kernel, batch.fields_in, batch.fields_out,
        batch.n_extra)


# ---------------------------------------------------------------------
# retention GC
# ---------------------------------------------------------------------

def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True
    return True


def stale_temp_files(directory: str) -> list:
    """Dead-pid temp litter under the manifest dir — the
    ``checkpoint.stale_temp_files`` pattern applied to the
    :func:`~dccrg_tpu_torch.coord.atomic_file_write` temp names
    (``.<name>.tmp.<pid>``): a writer that died between write and
    rename. Never matches a landed record."""
    out = []
    mdir = os.path.join(str(directory), MANIFEST_DIR)
    try:
        names = sorted(os.listdir(mdir))
    except OSError:
        return out
    for name in names:
        idx = name.rfind(".tmp.")
        if idx < 0:
            continue
        pid = name[idx + len(".tmp."):]
        if pid.isdigit() and not _pid_alive(int(pid)):
            out.append(os.path.join(mdir, name))
    return out


def _dir_bytes(paths) -> int:
    total = 0
    for p in paths:
        try:
            total += os.path.getsize(p)
        except OSError:
            pass
    return total


def gc(directory, *, max_bytes=None, max_age_s=None, dry_run=True,
       protect=(), now=None):
    """Retention GC over one cache directory: sweep dead-pid temp
    litter, then prune manifest records least-recently-hit first (and
    the ``build/`` kernel libraries oldest first) until the age bound
    (``max_age_s`` since last hit / mtime) and size bound
    (``max_bytes`` across manifest + build) hold. ``dry_run=True`` (the
    default) only reports. ``protect`` is a set of kids that must
    never prune (the pool passes its in-flight prewarm keys).
    Returns a report dict; damage encountered while scanning is
    skipped, never raised."""
    directory = str(directory)
    now = time.time() if now is None else float(now)
    protect = set(protect)
    report = {"dry_run": bool(dry_run), "pruned": [],
              "pruned_kids": [], "swept_tmp": [], "kept": 0,
              "bytes_before": 0, "bytes_after": 0}
    try:
        faults.fire("warm.cache.io", op="gc")
    except OSError as e:
        # a cache-dir I/O failure degrades the GC pass to a no-op
        # report — retention is best-effort, never a crash
        telemetry.inc("dccrg_warm_cache_errors_total")
        report["error"] = str(e)
        return report
    for tmp in stale_temp_files(directory):
        report["swept_tmp"].append(tmp)
        if not dry_run:
            try:
                os.unlink(tmp)
            except OSError:
                pass
    mdir = os.path.join(directory, MANIFEST_DIR)
    bdir = os.path.join(directory, BUILD_DIR)
    recs = []  # (last_hit, path, kid, bytes)
    try:
        names = sorted(os.listdir(mdir))
    except OSError:
        names = []
    for name in names:
        if not name.endswith(RECORD_SUFFIX):
            continue
        path = os.path.join(mdir, name)
        kid = name[:-len(RECORD_SUFFIX)]
        last = 0.0
        try:
            rec = read_entry(path)
            last = float(rec.get("last_hit", 0.0))
        except (WarmCacheError, OSError):
            pass  # unreadable records sort oldest: pruned first
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        recs.append((last, path, kid, size))
    libs = []  # (mtime, path, bytes)
    try:
        for name in sorted(os.listdir(bdir)):
            path = os.path.join(bdir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            if os.path.isfile(path):
                libs.append((st.st_mtime, path, st.st_size))
    except OSError:
        pass
    recs.sort()
    libs.sort()
    total = sum(s for _t, _p, _k, s in recs) + sum(
        s for _t, _p, s in libs)
    report["bytes_before"] = total

    def prune(path, kid=None):
        report["pruned"].append(path)
        if kid is not None:
            report["pruned_kids"].append(kid)
        if not dry_run:
            try:
                os.unlink(path)
            except OSError:
                pass

    keep_recs = []
    for last, path, kid, size in recs:
        aged = (max_age_s is not None and now - last > max_age_s)
        if aged and kid not in protect:
            prune(path, kid)
            total -= size
        else:
            keep_recs.append((last, path, kid, size))
    keep_libs = []
    for mtime, path, size in libs:
        if max_age_s is not None and now - mtime > max_age_s:
            prune(path)
            total -= size
        else:
            keep_libs.append((mtime, path, size))
    if max_bytes is not None:
        # least-recently-hit records (with the oldest libraries
        # interleaved by time) go first until the budget holds
        pool = ([("rec", t, p, k, s) for t, p, k, s in keep_recs]
                + [("lib", t, p, None, s) for t, p, s in keep_libs])
        pool.sort(key=lambda e: e[1])
        for kind, _t, path, kid, size in pool:
            if total <= max_bytes:
                break
            if kind == "rec" and kid in protect:
                continue
            prune(path, kid)
            total -= size
    report["bytes_after"] = total
    report["kept"] = (len(keep_recs) + len(keep_libs)
                      - len(report["pruned"]))
    return report


# ---------------------------------------------------------------------
# CLI: python -m dccrg_tpu_torch.warmstart list|gc
# ---------------------------------------------------------------------

def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m dccrg_tpu_torch.warmstart",
        description="warm-start build cache inspection + retention GC")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_list = sub.add_parser("list", help="list manifest entries")
    p_gc = sub.add_parser("gc", help="retention GC (dry-run unless "
                                     "--apply)")
    for p in (p_list, p_gc):
        p.add_argument("--dir", default=None,
                       help="cache dir (default: "
                            "$DCCRG_COMPILE_CACHE)")
    p_gc.add_argument("--max-bytes", type=int,
                      default=None, help="size bound (default: "
                                         "$DCCRG_WARM_GC_BYTES)")
    p_gc.add_argument("--max-age-s", type=float,
                      default=None, help="age bound (default: "
                                         "$DCCRG_WARM_GC_AGE_S)")
    p_gc.add_argument("--apply", action="store_true",
                      help="actually prune (default: dry-run)")
    args = ap.parse_args(argv)
    d = args.dir or cache_dir_default()
    if not d:
        print("no cache dir (set DCCRG_COMPILE_CACHE or pass --dir)")
        return 2
    if args.cmd == "list":
        entries, rejects = load_manifest(d)
        for kid, e in sorted(entries.items()):
            k = e["key"]
            print(f"{kid}  {k['kernel']:<12} "
                  f"{'x'.join(str(v) for v in k['length']):<12} "
                  f"cap={e['capacity']:<4} hits={e.get('hits', 0):<5} "
                  f"compile_s={e.get('compile_s', 0.0):.3f}")
        for path, err in rejects:
            print(f"REJECT {path}: {err}")
        print(f"{len(entries)} entries, {len(rejects)} rejected, "
              f"epoch {cache_epoch()}")
        return 0
    mb = (args.max_bytes if args.max_bytes is not None
          else gc_max_bytes_default())
    ma = (args.max_age_s if args.max_age_s is not None
          else gc_max_age_default())
    report = gc(d, max_bytes=mb, max_age_s=ma,
                dry_run=not args.apply)
    verb = "pruned" if args.apply else "would prune"
    print(f"{verb} {len(report['pruned'])} file(s), swept "
          f"{len(report['swept_tmp'])} stale temp(s), "
          f"{report['bytes_before']} -> {report['bytes_after']} "
          f"bytes{' (dry-run)' if report['dry_run'] else ''}")
    for p in report["pruned"]:
        print(f"  {verb}: {p}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(_main())
