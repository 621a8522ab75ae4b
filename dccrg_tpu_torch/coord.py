"""Distributed coordination of the port: timeout-guarded barriers,
guarded ``torch.distributed`` bring-up, cross-rank trip consensus, the
coordination KV store and elastic membership.

Port of ``dccrg_tpu/coord.py``, whole, on ``torch.distributed`` in
place of ``jax.distributed``. A process group whose rank dies leaves
its peers blocked in the next collective, and a checkpoint save that
died on one rank leaves the others waiting forever; this module is the
layer the supervision paths (:class:`~dccrg_tpu_torch.resilience
.ResilientRunner`, :mod:`dccrg_tpu_torch.supervise`) put their rank
synchronization through:

- :func:`barrier`: a tagged barrier with a deadline. In a process group
  of several ranks it meets on the default group's store (an ``add``
  per rank on one key, then a poll until every rank arrived), on a
  worker thread bounded by :func:`run_with_deadline`; a lost rank
  surfaces as :class:`BarrierTimeoutError` naming the tag within the
  bound (``DCCRG_BARRIER_TIMEOUT``, default 120 s). An injected
  :meth:`~dccrg_tpu_torch.faults.FaultPlan.barrier_hang` replaces this
  rank's arrival with a sleep.
- :func:`distributed_init`: ``torch.distributed.init_process_group``
  with bounded retry and exponential backoff, raising
  :class:`DistributedInitError` when the budget is spent. The group is
  gloo unless the caller names a backend: every collective here is a
  host-side integer (NCCL also refuses two ranks on one card).
- :func:`trip_consensus`: a per-rank trip code reduced with MAX over
  the process group, so a rollback that originates on ONE rank is taken
  by every rank together. :func:`broadcast_fatal` is its
  deadline-bounded best-effort variant for a rank on its way out.
- :func:`seal_record` / :func:`unseal_record` / :func:`kv_barrier`:
  CRC-framed KV records (a torn write convicts as
  :class:`TornRecordError`) and a presence-key barrier over an explicit
  participant set that doubles as a small all-gather, watches an epoch
  fence (:class:`StaleFenceError`) and a peer abort marker
  (:class:`RemoteAbortError`), and upgrades expiry to
  :class:`PeerDeadError` under a membership lease view.
- :class:`Membership`: heartbeat leases in the KV store
  (``DCCRG_HEARTBEAT_S``, ``DCCRG_LEASE_S``), peers classified
  live/suspect/dead by the lease age the observer saw.
- :class:`InMemoryKV` / :class:`CoordKV`: the KV store the leases ride.
  :class:`CoordKV` wraps a ``torch.distributed`` store (the default
  group's, a ``TCPStore``); ``create`` is first-writer-wins through
  ``compare_set``, and since a store cannot list keys, every key is
  also appended to an index key of each of its parent directories,
  which :meth:`CoordKV.dir_get` reads.

Everything degrades to a no-op on a single process, so single-process
code pays one ``is_initialized`` check per call.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib

import torch

from . import faults

logger = logging.getLogger("dccrg_tpu_torch.coord")

DEFAULT_BARRIER_TIMEOUT = 120.0

# Barrier ids must be unique AND align across ranks. A PER-TAG counter
# (not one global sequence) keeps them aligned even when ranks' barrier
# histories diverge on OTHER tags; within one tag every rank calls it
# the same number of times (protocols that may fail asymmetrically fold
# an attempt epoch into the tag itself).
_tag_seq: dict = {}


def _next_seq(tag: str) -> int:
    seq = _tag_seq.get(tag, 0)
    _tag_seq[tag] = seq + 1
    return seq


class BarrierTimeoutError(RuntimeError):
    """A tagged barrier did not complete within its bound: a
    participating rank is gone (process death, hung collective, dead
    card). ``tag``/``timeout`` carry the details."""

    def __init__(self, tag: str, timeout: float):
        super().__init__(
            f"barrier {tag!r} did not complete within {timeout:g}s: a "
            "participating rank is unreachable (process death, hung "
            "collective, or dead accelerator tunnel)")
        self.tag = tag
        self.timeout = timeout


class DistributedInitError(RuntimeError):
    """``torch.distributed.init_process_group`` failed after every
    bounded retry."""


class CheckpointCommitError(RuntimeError):
    """The two-phase multi-process checkpoint commit aborted: one or
    more ranks' slices are missing or fail their CRC32, so the new file
    was NOT published and the previous checkpoint stays intact under
    the final name. ``ranks`` names the writers whose slices failed."""

    def __init__(self, msg, ranks=()):
        super().__init__(msg)
        self.ranks = sorted({int(r) for r in ranks})


class TornRecordError(RuntimeError):
    """A sealed coordination record (:func:`seal_record`) failed its
    CRC32 frame: the half-written record of a writer that died
    mid-write. The reader treats it as absent and poisoned: abort the
    round, never act on the payload. ``key`` names the record."""

    def __init__(self, key: str = "", detail: str = ""):
        super().__init__(
            f"coordination record {key!r} is torn (CRC mismatch"
            f"{': ' + detail if detail else ''})")
        self.key = key


class StaleFenceError(RuntimeError):
    """An epoch-fenced coordination point saw the fence move past the
    epoch this participant entered under: this process is a zombie
    (stopped while the others completed or re-formed the round). The
    only safe move is a full local rollback to the pre-round state."""

    def __init__(self, tag: str, expected, observed):
        super().__init__(
            f"fenced point {tag!r}: fence moved {expected!r} -> "
            f"{observed!r} while this rank was inside the round — this "
            "rank is a zombie; rolling back to the pre-round state")
        self.tag = tag
        self.expected = expected
        self.observed = observed


class RemoteAbortError(RuntimeError):
    """A PEER rank aborted the distributed transaction this rank is
    inside and posted an abort marker: every waiting participant raises
    this at once instead of burning its barrier timeout. ``rank`` names
    the aborter (-1 when the marker was unreadable), ``reason`` its
    message."""

    def __init__(self, tag: str, rank: int = -1, reason: str = ""):
        super().__init__(
            f"distributed commit {tag!r}: peer rank {rank} aborted"
            f"{' (' + reason + ')' if reason else ''} — rolling back")
        self.tag = tag
        self.rank = int(rank)
        self.reason = reason


class PeerDeadError(BarrierTimeoutError):
    """A coordination point failed because one or more PEER RANKS are
    dead by membership lease (no heartbeat within ``DCCRG_LEASE_S``).
    A :class:`BarrierTimeoutError`, so every timeout handler keeps
    working, but ``ranks`` names the culprits."""

    def __init__(self, tag: str, timeout: float, ranks, lease_s=None):
        ranks = sorted({int(r) for r in ranks})
        lease = "" if lease_s is None else f" within {lease_s:g}s"
        RuntimeError.__init__(
            self,
            f"barrier {tag!r}: peer rank(s) {ranks} are DEAD by "
            f"membership lease (no heartbeat observed{lease}); their "
            "jobs are reclaimable by the survivors")
        self.tag = tag
        self.timeout = timeout
        self.ranks = ranks


def barrier_timeout(default: float = DEFAULT_BARRIER_TIMEOUT) -> float:
    """The ``DCCRG_BARRIER_TIMEOUT`` env knob: seconds before a
    coordination barrier gives up on its peers."""
    try:
        return float(os.environ.get("DCCRG_BARRIER_TIMEOUT", "") or default)
    except ValueError:
        return default


def run_with_deadline(fn, timeout: float, name: str = "deadline"):
    """Run ``fn()`` on a daemon worker thread bounded by ``timeout``
    seconds: the watchdog primitive behind the barrier, the fatal-trip
    broadcast and the supervision layer's step and save deadlines.
    Returns ``(finished, result, error)``; on expiry the worker is
    abandoned (``finished=False``): a wedged callee cannot be
    cancelled, only reported."""
    box, err = [], []
    done = threading.Event()

    def _work():
        try:
            box.append(fn())
        except BaseException as e:  # noqa: BLE001 - caller's to re-raise
            err.append(e)
        finally:
            done.set()

    t = threading.Thread(target=_work, daemon=True, name=f"dccrg-{name}")
    t.start()
    if not done.wait(float(timeout)):
        return False, None, None
    return True, (box[0] if box else None), (err[0] if err else None)


def process_count() -> int:
    """Ranks of the default process group (1 without one)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def _default_store():
    """The default process group's store, or None (no group, or the
    private accessor moved)."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return None
    try:
        from torch.distributed import distributed_c10d

        return distributed_c10d._get_default_store()
    except Exception:  # pragma: no cover - torch internals drift
        return None


def _store_barrier(store, key: str, n: int, deadline: float,
                   poll_s: float = 0.005) -> bool:
    """Arrive at ``key`` (one ``add``) and poll its count until all
    ``n`` ranks arrived or ``deadline`` passes."""
    got = int(store.add(key, 1))
    while got < n:
        if time.monotonic() >= deadline:
            return False
        time.sleep(poll_s)
        got = int(store.add(key, 0))
    return True


def barrier(tag: str, timeout: float | None = None) -> None:
    """Synchronize every process at a tagged point, or raise
    :class:`BarrierTimeoutError` naming the tag within ``timeout``
    seconds (default: :func:`barrier_timeout`).

    One process returns at once. Several ranks meet on the default
    group's store, the wait running on a daemon watchdog thread so the
    caller can never block past the bound (a hung thread is abandoned:
    a barrier that lost a rank is only reportable). An injected
    :meth:`~dccrg_tpu_torch.faults.FaultPlan.barrier_hang` replaces the
    arrival with a sleep, exercising the watchdog on one process."""
    timeout = barrier_timeout() if timeout is None else float(timeout)
    faults.fire("coord.barrier", tag=tag)
    hang = faults.take_barrier_hang(tag)
    # the membership fast path: a peer the heartbeat leases already
    # declared dead will never reach this barrier
    _raise_if_peer_dead(tag, timeout, poll=False)
    n = process_count()
    real = n > 1
    if not real and hang is None:
        return
    seq = _next_seq(tag)
    deadline = time.monotonic() + timeout

    def _sync():
        if hang is not None:
            # a simulated lost rank: this rank never arrives; a finite
            # hang below the timeout models a slow-but-alive peer
            time.sleep(min(hang, timeout + 30.0))
            if not real:
                return True
            if time.monotonic() >= deadline:
                return False
        return _store_barrier(_default_store(), f"dccrg:{tag}:{seq}", n,
                              deadline)

    finished, ok, err = run_with_deadline(_sync, timeout, f"barrier:{tag}")
    if not finished or (err is None and not ok):
        _raise_if_peer_dead(tag, timeout, poll=True)
        raise BarrierTimeoutError(tag, timeout)
    if err is not None:
        raise err


def distributed_init(coordinator_address=None, num_processes=None,
                     process_id=None, *, retries: int = 3,
                     backoff: float = 0.5, **kwargs) -> None:
    """``torch.distributed.init_process_group`` with bounded retry and
    exponential backoff (the coordinator not listening yet, a port
    race). ``coordinator_address`` is ``host:port`` or a full
    ``init_method`` URL; the backend is gloo unless ``backend=`` says
    otherwise. Raises :class:`DistributedInitError` with the last
    failure chained once the budget is spent."""
    kwargs.setdefault("backend", "gloo")
    if coordinator_address is not None and "://" not in str(
            coordinator_address):
        coordinator_address = f"tcp://{coordinator_address}"
    last: Exception | None = None
    for attempt in range(retries + 1):
        try:
            faults.fire("coord.init", attempt=attempt)
            torch.distributed.init_process_group(
                init_method=coordinator_address, world_size=num_processes,
                rank=process_id, **kwargs)
            return
        except Exception as e:  # noqa: BLE001 - retried, then surfaced
            last = e
            if attempt < retries:
                delay = backoff * (2 ** attempt)
                logger.warning(
                    "distributed init failed (%s); retry %d/%d in %.1fs",
                    e, attempt + 1, retries, delay)
                time.sleep(delay)
    raise DistributedInitError(
        f"torch.distributed.init_process_group failed after {retries + 1} "
        f"attempt(s): {last}") from last


def process_rank(grid) -> int:
    """This process's rank for checkpoint coordination: the process
    group's rank, or the rank a faked test split pinned on the grid
    (``grid._ckpt_rank``)."""
    r = getattr(grid, "_ckpt_rank", None)
    if r is not None:
        return int(r)
    return process_index()


def trip_consensus(grid, code: int) -> int:
    """Reduce a per-rank trip code with MAX across the process group.

    :class:`~dccrg_tpu_torch.resilience.ResilientRunner` calls this
    every step so trip and rollback decisions that originate on ONE
    rank are taken by every rank together. Codes are small ints ordered
    by priority (0 = no trip; ``resilience._TRIP_INTERRUPT`` a
    step-boundary interrupt, outranked by any real trip; recoverable
    trips; >= ``resilience._TRIP_FATAL`` a non-recoverable failure);
    the max across ranks wins. A grid whose partitions are all this
    process's returns ``code`` unchanged; a grid split across processes
    (``_proc_local_dev`` partial) runs ``all_reduce(MAX)`` in a real
    group, and returns the local code when no group exists (a faked
    split has no second process to disagree)."""
    code = int(code)
    if not grid._multiproc:
        return code
    if process_count() <= 1:
        return code
    dist = torch.distributed
    dev = "cpu"
    if dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    t = torch.tensor([code], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def broadcast_fatal(grid, code: int, timeout: float | None = None) -> None:
    """Best-effort, deadline-bounded :func:`trip_consensus` broadcast
    for a rank on its way out of a non-recoverable error: it runs on a
    daemon watchdog thread and is abandoned after ``timeout`` seconds
    (default: :func:`barrier_timeout`), and its exceptions are
    swallowed: the caller is about to re-raise the error that
    matters."""
    timeout = barrier_timeout() if timeout is None else float(timeout)

    def _send():
        try:
            trip_consensus(grid, code)
        except Exception:  # noqa: BLE001 - the original error outranks it
            pass

    finished, _res, _err = run_with_deadline(_send, timeout,
                                             "fatal-broadcast")
    if not finished:  # pragma: no cover - needs a wedged group
        logger.warning(
            "fatal trip code %d could not be broadcast within %.0fs "
            "(the group itself is unreachable); peers must rely on "
            "their own barrier timeouts", code, timeout)


# ---------------------------------------------------------------------
# elastic membership: heartbeat leases over the coordination KV store
# ---------------------------------------------------------------------

DEFAULT_HEARTBEAT_S = 2.0
DEFAULT_LEASE_S = 8.0


def heartbeat_seconds(default: float = DEFAULT_HEARTBEAT_S) -> float:
    """The ``DCCRG_HEARTBEAT_S`` env knob: seconds between a rank's
    heartbeat-lease renewals in the coordination KV store."""
    try:
        v = float(os.environ.get("DCCRG_HEARTBEAT_S", "") or default)
    except ValueError:
        v = default
    return max(0.01, v)


def lease_seconds(default: float | None = None) -> float:
    """The ``DCCRG_LEASE_S`` env knob: seconds without an observed
    heartbeat before a peer is declared DEAD. Clamped to at least two
    heartbeats (a shorter lease would flap on scheduling jitter)."""
    hb = heartbeat_seconds()
    fallback = DEFAULT_LEASE_S if default is None else float(default)
    try:
        v = float(os.environ.get("DCCRG_LEASE_S", "") or fallback)
    except ValueError:
        v = fallback
    return max(2.0 * hb, v)


class InMemoryKV:
    """Process-local KV store with compare-and-set semantics
    (:meth:`create` is first-writer-wins). The single-process default,
    and the store the fake-clock lease tests share between in-process
    'ranks'."""

    def __init__(self):
        self._data: dict = {}
        self._lock = threading.Lock()

    def set(self, key: str, value: str) -> None:
        with self._lock:
            self._data[str(key)] = str(value)

    def create(self, key: str, value: str) -> bool:
        """Create ``key`` iff absent; False when another writer won."""
        with self._lock:
            if str(key) in self._data:
                return False
            self._data[str(key)] = str(value)
            return True

    def get(self, key: str):
        with self._lock:
            return self._data.get(str(key))

    def dir_get(self, prefix: str):
        """Every ``(key, value)`` under ``prefix`` as a dict."""
        prefix = str(prefix)
        with self._lock:
            return {k: v for k, v in self._data.items()
                    if k.startswith(prefix)}

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(str(key), None)


class CoordKV:
    """The KV store of a ``torch.distributed`` process group (a
    ``TCPStore``, or any ``torch.distributed.Store``).

    ``get`` checks the key first (the store's own ``get`` blocks until
    its timeout on an absent key); ``create`` is ``compare_set`` from
    the empty value, first writer wins (two writers racing to create
    the same key with the same value both see success, and the store
    holds that value); ``dir_get`` reads a per-directory index, since
    the store cannot list keys: each key's first write in this process
    appends it to the index key of every parent directory. Every
    operation swallows store errors into None/False: a dying store
    degrades into observed staleness, never a crash."""

    _INDEX = "__dccrg_kv_index__:"

    def __init__(self, store):
        self._store = store
        self._indexed: set = set()
        self._lock = threading.Lock()

    def _index(self, key: str) -> None:
        with self._lock:
            if key in self._indexed:
                return
            self._indexed.add(key)
        parts = key.split("/")
        for i in range(1, len(parts)):
            self._store.append(self._INDEX + "/".join(parts[:i]) + "/",
                               key + "\n")

    def set(self, key: str, value: str) -> None:
        try:
            self._store.set(str(key), str(value))
            self._index(str(key))
        except Exception:  # noqa: BLE001 - degrade to staleness
            pass

    def create(self, key: str, value: str) -> bool:
        key, value = str(key), str(value)
        try:
            if self._store.check([key]):
                return False
            won = self._store.compare_set(key, "", value) == value.encode()
            if won:
                self._index(key)
            return won
        except Exception:  # noqa: BLE001 - lost the CAS (or no store)
            return False

    def get(self, key: str):
        try:
            if not self._store.check([str(key)]):
                return None
            return self._store.get(str(key)).decode()
        except Exception:  # noqa: BLE001 - absent key / dead store
            return None

    def dir_get(self, prefix: str):
        """``{key: value}`` of every live key under ``prefix``, from
        the index of ``prefix``'s directory; None on a store error (the
        caller falls back to per-key reads)."""
        prefix = str(prefix)
        d = prefix if prefix.endswith("/") else prefix.rsplit("/", 1)[0] + "/"
        try:
            ikey = self._INDEX + d
            if not self._store.check([ikey]):
                return {}
            names = {k for k in self._store.get(ikey).decode().split("\n")
                     if k and k.startswith(prefix)}
            out = {}
            for k in sorted(names):
                if self._store.check([k]):
                    out[k] = self._store.get(k).decode()
            return out
        except Exception:  # noqa: BLE001 - degrade to per-key reads
            return None

    def delete(self, key: str) -> None:
        try:
            self._store.delete_key(str(key))
        except Exception:  # noqa: BLE001 - best effort
            pass


_LOCAL_KV: "InMemoryKV | None" = None


def default_kv():
    """The KV store leases ride: the process group's store when
    ``torch.distributed`` is initialized, else one process-global
    :class:`InMemoryKV`."""
    store = _default_store()
    if store is not None:
        return CoordKV(store)
    global _LOCAL_KV
    if _LOCAL_KV is None:
        _LOCAL_KV = InMemoryKV()
    return _LOCAL_KV


def prefix_census(kv, prefix: str):
    """One-call ``{full_key: value}`` snapshot of every key under
    ``prefix``, or None when the KV cannot list (callers then fall back
    to per-key reads). Relative child names are normalized back to full
    keys."""
    dir_get = getattr(kv, "dir_get", None)
    if dir_get is None:
        return None
    raw = dir_get(str(prefix))
    if raw is None:
        return None
    p = str(prefix).rstrip("/") + "/"
    return {(str(k) if str(k).startswith(p) else p + str(k)): v
            for k, v in raw.items()}


# ---------------------------------------------------------------------
# sealed records + fenced KV barrier
# ---------------------------------------------------------------------

def seal_record(payload: str) -> str:
    """Frame ``payload`` with its CRC32 (``crc:length:payload``) for a
    KV write that may be observed half-done: every reader can convict
    a damaged record instead of acting on it."""
    data = str(payload)
    raw = data.encode("utf-8")
    return f"{zlib.crc32(raw) & 0xFFFFFFFF:08x}:{len(raw)}:{data}"


def unseal_record(record: str, key: str = "") -> str:
    """Verify and strip a :func:`seal_record` frame; raises
    :class:`TornRecordError` naming ``key`` when the CRC or length does
    not match the payload."""
    try:
        crc_hex, length, data = str(record).split(":", 2)
        want_crc = int(crc_hex, 16)
        want_len = int(length)
    except (ValueError, AttributeError):
        raise TornRecordError(key, "unparseable frame") from None
    raw = data.encode("utf-8")
    if len(raw) != want_len:
        raise TornRecordError(key, f"length {len(raw)} != {want_len}")
    if (zlib.crc32(raw) & 0xFFFFFFFF) != want_crc:
        raise TornRecordError(key, "payload CRC mismatch")
    return data


def atomic_file_write(path: str, data: str, *, tmp_dir=None) -> str:
    """Durably land a small file: write a temp sibling (or into
    ``tmp_dir``), fsync, then ``os.replace`` onto ``path``. A crashed
    writer leaves the old complete file or an invisible temp, never a
    torn visible one; the temp name carries the writer's pid."""
    d = tmp_dir if tmp_dir is not None else (os.path.dirname(path)
                                             or ".")
    tmp = os.path.join(
        str(d), f".{os.path.basename(path)}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def write_sealed_file(path: str, payload: str, *, tmp_dir=None) -> str:
    """:func:`seal_record` + :func:`atomic_file_write`."""
    return atomic_file_write(path, seal_record(payload),
                             tmp_dir=tmp_dir)


def read_sealed_file(path: str, key: str = "") -> str:
    """Read and verify a :func:`write_sealed_file` record; raises
    :class:`TornRecordError` (naming ``key``, default the path) on a
    damaged frame. OSErrors propagate."""
    with open(path) as f:
        raw = f.read()
    return unseal_record(raw, key or str(path))


def kv_barrier(kv, tag: str, rank: int, ranks, timeout=None, *,
               value: str = "1", poll_s: float = 0.02, fence=None,
               abort_key=None, membership=None) -> dict:
    """Presence-key barrier over a KV store: each participant writes
    ``<tag>/<rank> = value`` and polls until every rank in ``ranks``
    arrived, then returns ``{rank: value}`` (an all-gather of one small
    record per rank).

    The participant set is explicit, so a collective that lost a rank
    can re-form over the survivors, and in-process fake ranks can meet
    at it. While polling it watches:

    - ``fence=(key, expected)``: raises :class:`StaleFenceError` the
      moment the fence moves off ``expected`` (the first element may be
      a zero-arg callable returning the current fence);
    - ``abort_key``: raises :class:`RemoteAbortError` the moment a peer
      posts an abort marker there; the marker also vetoes completion
      (arrivals of an aborted round may be ghosts).

    On expiry, a ``membership`` whose lease view declares a missing
    peer DEAD upgrades the timeout to :class:`PeerDeadError`; otherwise
    :class:`BarrierTimeoutError` names the tag. An injected
    :meth:`~dccrg_tpu_torch.faults.FaultPlan.barrier_hang` for the tag
    replaces this rank's arrival with a sleep."""
    timeout = barrier_timeout() if timeout is None else float(timeout)
    expected = sorted({int(r) for r in ranks})
    faults.fire("coord.barrier", tag=tag)
    hang = faults.take_barrier_hang(tag)
    deadline = time.monotonic() + timeout
    if hang is not None:
        # a lost or slow rank: never (or late) post the arrival
        time.sleep(min(float(hang), max(0.0, deadline - time.monotonic())))
    kv.set(f"{tag}/{int(rank)}", str(value))

    def _arrivals() -> dict:
        got = kv.dir_get(f"{tag}/")
        if got is None:  # store hiccup: per-key reads
            got = {}
            for r in expected:
                v = kv.get(f"{tag}/{r}")
                if v is not None:
                    got[f"{tag}/{r}"] = v
        arrived = {}
        for k, v in got.items():
            tail = k.rsplit("/", 1)[-1]
            try:
                arrived[int(tail)] = v
            except ValueError:
                continue
        return arrived

    def _abort_marker():
        got = kv.dir_get(abort_key.rsplit("/", 1)[0] + "/")
        if got is not None:
            return got.get(abort_key)
        return kv.get(abort_key)

    def _finish(arrived: dict) -> dict:
        if abort_key is not None:
            marker = _abort_marker()
            if marker is not None:
                raise _remote_abort(tag, abort_key, marker)
        return {r: arrived[r] for r in expected}

    last_live_check = 0.0
    while True:
        # completion before the fence: presence keys are monotonic
        # within a round, so a fence bump the winner performs right
        # after passing never strands a slower counted participant
        arrived = _arrivals()
        if all(r in arrived for r in expected):
            return _finish(arrived)
        if fence is not None:
            fkey, fexp = fence
            cur = fkey() if callable(fkey) else kv.get(fkey)
            if cur is not None and str(cur) != str(fexp):
                arrived = _arrivals()
                if all(r in arrived for r in expected):
                    return _finish(arrived)
                raise StaleFenceError(tag, fexp, cur)
        if abort_key is not None:
            marker = _abort_marker()
            if marker is not None:
                raise _remote_abort(tag, abort_key, marker)
        now = time.monotonic()
        if membership is not None and now - last_live_check > 0.25:
            last_live_check = now
            try:
                dead = set(membership.detect_dead_ranks())
            except Exception:  # noqa: BLE001 - view refresh is best-effort
                dead = set()
            missing_dead = [r for r in expected
                            if r not in arrived and r in dead]
            if missing_dead:
                raise PeerDeadError(tag, timeout, missing_dead,
                                    lease_s=membership.lease_s)
        if now >= deadline:
            raise BarrierTimeoutError(tag, timeout)
        time.sleep(poll_s)


def _remote_abort(tag: str, key: str, marker) -> RemoteAbortError:
    """Decode an abort marker into the typed error (a torn marker is
    still an abort)."""
    try:
        info = json.loads(unseal_record(marker, key))
        return RemoteAbortError(tag, rank=int(info.get("rank", -1)),
                                reason=str(info.get("reason", "")))
    except Exception:  # noqa: BLE001 - torn marker: abort anonymously
        return RemoteAbortError(tag, rank=-1, reason="torn abort marker")


class Membership:
    """Elastic fleet membership over heartbeat leases.

    Every rank :meth:`heartbeat`\\ s a monotonically bumped counter into
    the KV under ``<prefix>/<rank>`` at the ``heartbeat_s`` cadence.
    :meth:`poll` reads every peer's key under a deadline (a wedged KV
    read keeps the LAST view) and classifies each peer by how long ago
    the OBSERVER saw its value change: ``live`` (within ``suspect_s``),
    ``suspect``, or ``dead`` (stale for ``lease_s`` or more). Aging is
    strictly on the observer's clock, ``clock`` is injectable, and a
    peer that beats again flips back to live. Every poll exports
    ``dccrg_fleet_membership{state}`` gauges and logs transitions."""

    LIVE, SUSPECT, DEAD = "live", "suspect", "dead"

    def __init__(self, rank: int, n_ranks: int, *, kv=None,
                 heartbeat_s=None, lease_s=None, clock=time.monotonic,
                 prefix: str = "dccrg/hb"):
        self.rank = int(rank)
        self.n_ranks = max(1, int(n_ranks))
        self.kv = kv if kv is not None else default_kv()
        self.heartbeat_s = (heartbeat_seconds() if heartbeat_s is None
                            else max(0.01, float(heartbeat_s)))
        self.lease_s = max(2.0 * self.heartbeat_s,
                           lease_seconds() if lease_s is None
                           else float(lease_s))
        self.suspect_s = min(2.0 * self.heartbeat_s, self.lease_s / 2.0)
        self.clock = clock
        self.prefix = str(prefix)
        self._beat = 0
        self._last_beat_t = None
        self._auto = None
        now = self.clock()
        # a peer that has NEVER beaten gets the same full-lease grace
        # from construction as one that just stopped
        self._seen = {r: [None, now] for r in range(self.n_ranks)
                      if r != self.rank}
        self._state = {r: self.LIVE for r in self._seen}

    def _key(self, rank: int) -> str:
        return f"{self.prefix}/{int(rank)}"

    def heartbeat(self, force: bool = False) -> bool:
        """Renew this rank's lease (throttled to ``heartbeat_s`` unless
        ``force``); returns whether a write happened."""
        now = self.clock()
        if (not force and self._last_beat_t is not None
                and now - self._last_beat_t < self.heartbeat_s):
            return False
        self._beat += 1
        self.kv.set(self._key(self.rank), f"{self._beat}")
        self._last_beat_t = now
        return True

    def start_auto(self) -> None:
        """Start the daemon heartbeat thread (idempotent): liveness
        must not ride the step loop's stalls. Only meaningful under a
        real clock."""
        if self._auto is not None:
            return
        stop = threading.Event()

        def _beat():
            while not stop.wait(self.heartbeat_s):
                try:
                    self.heartbeat(force=True)
                except Exception:  # noqa: BLE001 - beats are best-effort
                    pass

        t = threading.Thread(target=_beat, daemon=True,
                             name="dccrg-heartbeat")
        t.start()
        self._auto = (t, stop)

    def stop_auto(self) -> None:
        if self._auto is not None:
            self._auto[1].set()
            self._auto = None

    def _classify(self, age: float) -> str:
        if age >= self.lease_s:
            return self.DEAD
        if age > self.suspect_s:
            return self.SUSPECT
        return self.LIVE

    def poll(self, timeout: float | None = None) -> dict:
        """One deadline-bounded membership scan; returns ``{rank:
        state}`` for every peer. The reads run under
        :func:`run_with_deadline` (budget ``timeout``, default one
        heartbeat, floor 50 ms); on expiry the previous observations
        stand and keep aging."""
        from . import telemetry

        budget = (max(0.05, self.heartbeat_s) if timeout is None
                  else max(0.01, float(timeout)))
        peers = list(self._seen)

        def _read():
            return [self.kv.get(self._key(r)) for r in peers]

        finished, vals, err = run_with_deadline(_read, budget,
                                                "membership-poll")
        now = self.clock()
        if finished and err is None and vals is not None:
            for r, v in zip(peers, vals):
                rec = self._seen[r]
                if v is not None and v != rec[0]:
                    rec[0], rec[1] = v, now
        else:
            telemetry.inc("dccrg_membership_poll_failures_total")
        for r, rec in self._seen.items():
            st = self._classify(now - rec[1])
            if st != self._state[r]:
                logger.warning(
                    "fleet membership: rank %d %s -> %s (lease age "
                    "%.2fs, lease bound %.2fs)", r, self._state[r], st,
                    now - rec[1], self.lease_s)
                telemetry.inc("dccrg_fleet_membership_transitions_total",
                              rank=str(r), state=st)
                self._state[r] = st
        counts = {self.LIVE: 1, self.SUSPECT: 0, self.DEAD: 0}  # self
        for st in self._state.values():
            counts[st] += 1
        for st, n in counts.items():
            telemetry.set_gauge("dccrg_fleet_membership", n, state=st)
        return dict(self._state)

    def detect_dead_ranks(self, timeout: float | None = None) -> list:
        """Deadline-bounded refresh + the ranks currently DEAD."""
        self.poll(timeout=timeout)
        return self.dead_ranks()

    def state(self, rank: int) -> str:
        """``live``/``suspect``/``dead`` (self is always live)."""
        if int(rank) == self.rank:
            return self.LIVE
        return self._state.get(int(rank), self.DEAD)

    def lease_age(self, rank: int) -> float:
        """Seconds since this observer saw ``rank``'s lease change."""
        rec = self._seen.get(int(rank))
        return 0.0 if rec is None else self.clock() - rec[1]

    def dead_ranks(self) -> list:
        return sorted(r for r, s in self._state.items()
                      if s == self.DEAD)

    def live_ranks(self) -> list:
        """Every rank not currently dead, self included."""
        return sorted([self.rank] + [r for r, s in self._state.items()
                                     if s != self.DEAD])


#: the process-wide membership barrier timeouts consult (None changes
#: nothing anywhere)
_MEMBERSHIP: list = [None]


def set_membership(m: "Membership | None") -> "Membership | None":
    """Register (or clear) the process-wide :class:`Membership` the
    barrier path consults; returns the previous one."""
    prev = _MEMBERSHIP[0]
    _MEMBERSHIP[0] = m
    return prev


def get_membership() -> "Membership | None":
    return _MEMBERSHIP[0]


def _raise_if_peer_dead(tag: str, timeout: float, poll: bool) -> None:
    """Raise :class:`PeerDeadError` when the registered membership (if
    any) knows of dead peers; ``poll=True`` refreshes the view first
    (bounded: this runs on the timeout path)."""
    m = _MEMBERSHIP[0]
    if m is None:
        return
    dead = (m.detect_dead_ranks(timeout=min(2.0, m.heartbeat_s * 2))
            if poll else m.dead_ranks())
    if dead:
        raise PeerDeadError(tag, timeout, dead, lease_s=m.lease_s)
