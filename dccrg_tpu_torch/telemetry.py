"""Telemetry of the port (counterpart of ``dccrg_tpu/telemetry.py``,
whole): one metrics registry and one span tracer for every layer.

**Metrics registry**: named counters, gauges and log-bucketed
histograms (:class:`LogHistogram`) with optional ``{label: value}``
dimensions, always on (an increment is a dict update).
:func:`dump_prometheus` renders the standard text exposition;
``DCCRG_METRICS_FILE`` (+ ``DCCRG_METRICS_EVERY`` seconds, default 10)
exports it periodically through :func:`maybe_export_metrics`.

**Span tracer**: :func:`span` is a context manager recording ``(name,
wall start, monotonic duration, rank, nesting, tags)`` into a bounded
ring (``DCCRG_TRACE_RING`` events, default 65536; the oldest dropped
and counted). Tracing is off by default: ``DCCRG_TRACE=1`` (or
:func:`configure`) enables it, and when off ``span()`` returns one
shared no-op singleton, so the instrumented hot paths
(``Grid.run_steps``, the AMR commit, checkpoint save and load) pay one
truthiness check. A span times the host's dispatch: PyTorch returns
before the device finishes, and no span synchronises the device.

**Trace export**: :func:`flush_trace` appends the ring as JSONL to
``DCCRG_TRACE_FILE`` (also at process exit), each event tagged with
its rank (``torch.distributed``'s, 0 without a process group), and
:func:`merge_traces` / ``python -m dccrg_tpu_torch.telemetry
merge|summary`` merge per-rank files into one timeline.

**Strictly best-effort**: every exporter write swallows I/O failures,
counts them in ``dccrg_telemetry_export_errors_total`` and carries on;
the ``telemetry.export`` fault site (:meth:`~dccrg_tpu_torch.faults
.FaultPlan.telemetry_io_error`) injects exactly that failure.
"""

from __future__ import annotations

import atexit
import collections
import json
import math
import os
import re
import threading
import time

from . import faults

logger = __import__("logging").getLogger("dccrg_tpu_torch.telemetry")


# ---------------------------------------------------------------------
# env knobs
# ---------------------------------------------------------------------

def trace_enabled_default(default: bool = False) -> bool:
    """The ``DCCRG_TRACE`` env knob: ``1`` records spans into the
    trace ring (and, with ``DCCRG_TRACE_FILE``, to disk). Off
    (default) the span API is a shared no-op singleton — zero
    allocation on the step path."""
    v = os.environ.get("DCCRG_TRACE", "")
    if v == "":
        return default
    return v not in ("0", "off", "false", "no")


def trace_ring_default(default: int = 65536) -> int:
    """The ``DCCRG_TRACE_RING`` env knob: how many span events the
    in-memory trace ring holds before the oldest are dropped."""
    try:
        return max(16, int(os.environ.get("DCCRG_TRACE_RING", "")
                           or default))
    except ValueError:
        return default


def trace_file_default():
    """The ``DCCRG_TRACE_FILE`` env knob: JSONL file span events are
    appended to by :func:`flush_trace` (and at process exit). On
    multi-process meshes give each rank its own path (the events
    carry the rank id either way; a literal ``{rank}`` in the value
    is substituted with the coord rank id)."""
    return os.environ.get("DCCRG_TRACE_FILE") or None


def metrics_file_default():
    """The ``DCCRG_METRICS_FILE`` env knob: where
    :func:`maybe_export_metrics` periodically writes the Prometheus
    text exposition."""
    return os.environ.get("DCCRG_METRICS_FILE") or None


def metrics_every_default(default: float = 10.0) -> float:
    """The ``DCCRG_METRICS_EVERY`` env knob: minimum seconds between
    periodic metrics-file exports."""
    try:
        return float(os.environ.get("DCCRG_METRICS_EVERY", "") or default)
    except ValueError:
        return default


# ---------------------------------------------------------------------
# the one histogram implementation (supervise.LatencyHistogram aliases)
# ---------------------------------------------------------------------

class LogHistogram:
    """Fixed log-spaced latency buckets.

    Bucket 0 covers ``[0, BASE)`` seconds and bucket ``i >= 1`` covers
    ``[BASE * 2**(i-1), BASE * 2**i)`` (the last absorbs the upper
    tail), so the whole histogram is ~30 ints — cheap enough to update
    every step forever, yet wide enough (100 us .. ~15 hours) that a
    slowly degrading interconnect shows up as mass migrating to the
    right long before anything actually wedges."""

    BASE = 1e-4  # seconds; bucket 0 = anything below 100 us
    N_BUCKETS = 30

    def __init__(self):
        self.counts = [0] * self.N_BUCKETS
        self.total = 0
        self.max_seconds = 0.0
        self.sum_seconds = 0.0

    def record(self, seconds: float) -> None:
        seconds = max(float(seconds), 0.0)
        i = 0 if seconds < self.BASE else int(
            math.log2(seconds / self.BASE)) + 1
        self.counts[min(max(i, 0), self.N_BUCKETS - 1)] += 1
        self.total += 1
        self.sum_seconds += seconds
        self.max_seconds = max(self.max_seconds, seconds)

    def buckets(self) -> list:
        """``[(lo_seconds, hi_seconds, count)]`` for every bucket."""
        out = []
        for i, c in enumerate(self.counts):
            lo = 0.0 if i == 0 else self.BASE * (2.0 ** (i - 1))
            hi = self.BASE * (2.0 ** i)
            out.append((lo, hi, c))
        return out

    def quantile(self, q: float) -> float:
        """Upper edge of the bucket holding the q-quantile (0 when
        nothing was recorded)."""
        if self.total == 0:
            return 0.0
        target = max(1, math.ceil(q * self.total))
        seen = 0
        for lo, hi, c in self.buckets():
            seen += c
            if seen >= target:
                return hi
        return self.buckets()[-1][1]

    def summary(self) -> str:
        if self.total == 0:
            return "no steps recorded"
        return (f"{self.total} steps, p50<={self.quantile(0.5):.3g}s, "
                f"p95<={self.quantile(0.95):.3g}s, "
                f"max={self.max_seconds:.3g}s")


# ---------------------------------------------------------------------
# the metrics registry
# ---------------------------------------------------------------------

def _key(name: str, labels: dict):
    return (name, tuple(sorted(labels.items())))


class Registry:
    """Process-wide metrics store: ``{(name, labels): value}`` maps
    for counters/gauges plus :class:`LogHistogram` instances. Plain
    GIL-atomic dict updates — telemetry is best-effort by contract,
    and a lost increment under a race is preferable to a lock on the
    step path."""

    def __init__(self):
        self.counters: dict = {}
        self.gauges: dict = {}
        self.histograms: dict = {}

    def inc(self, name: str, n=1, **labels) -> None:
        k = _key(name, labels)
        self.counters[k] = self.counters.get(k, 0) + n

    def set_gauge(self, name: str, value, **labels) -> None:
        self.gauges[_key(name, labels)] = float(value)

    def observe(self, name: str, seconds, **labels) -> None:
        k = _key(name, labels)
        h = self.histograms.get(k)
        if h is None:
            h = self.histograms[k] = LogHistogram()
        h.record(seconds)

    def counter_value(self, name: str, **labels):
        return self.counters.get(_key(name, labels), 0)

    def counter_total(self, name: str, **labels) -> float:
        """Sum of every series of ``name`` whose labels include the
        given ones (e.g. all ``kind=...`` series of one job)."""
        want = set(labels.items())
        return sum(v for (n, lab), v in self.counters.items()
                   if n == name and want <= set(lab))

    def histogram(self, name: str, **labels) -> "LogHistogram | None":
        return self.histograms.get(_key(name, labels))

    def histogram_total(self, name: str, **labels) -> "LogHistogram | None":
        """Merge every series of ``name`` whose labels include the
        given ones into one :class:`LogHistogram` (the counter_total
        analogue — e.g. the p99 queue age across all per-tenant
        intake series), or None when no series matches."""
        want = set(labels.items())
        merged = None
        for (n, lab), h in list(self.histograms.items()):
            if n != name or not want <= set(lab):
                continue
            if merged is None:
                merged = LogHistogram()
            merged.counts = [a + b for a, b in
                             zip(merged.counts, h.counts)]
            merged.total += h.total
            merged.sum_seconds += h.sum_seconds
            merged.max_seconds = max(merged.max_seconds, h.max_seconds)
        return merged

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()


_REGISTRY = Registry()


def registry() -> Registry:
    """The process-wide metrics registry."""
    return _REGISTRY


def inc(name: str, n=1, **labels) -> None:
    """Increment counter ``name`` (created on first use)."""
    _REGISTRY.inc(name, n, **labels)


def set_gauge(name: str, value, **labels) -> None:
    _REGISTRY.set_gauge(name, value, **labels)


def observe(name: str, seconds, **labels) -> None:
    """Record ``seconds`` into the log-bucketed histogram ``name``."""
    _REGISTRY.observe(name, seconds, **labels)


def _fmt_labels(lab) -> str:
    if not lab:
        return ""
    # label values are arbitrary user strings (job names): escape per
    # the exposition format or one odd name corrupts the whole file
    def esc(v):
        return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    inner = ",".join(f'{k}="{esc(v)}"' for k, v in lab)
    return "{" + inner + "}"


def dump_prometheus() -> str:
    """The registry as Prometheus text exposition: counters and gauges
    one sample per series, histograms in the standard
    ``_bucket{le=...}`` / ``_sum`` / ``_count`` cumulative form."""
    out = []
    seen = set()
    for (name, lab) in sorted(_REGISTRY.counters):
        if name not in seen:
            seen.add(name)
            out.append(f"# TYPE {name} counter")
        v = _REGISTRY.counters[(name, lab)]
        out.append(f"{name}{_fmt_labels(lab)} {v}")
    for (name, lab) in sorted(_REGISTRY.gauges):
        if name not in seen:
            seen.add(name)
            out.append(f"# TYPE {name} gauge")
        out.append(f"{name}{_fmt_labels(lab)} "
                   f"{_REGISTRY.gauges[(name, lab)]:g}")
    for (name, lab) in sorted(_REGISTRY.histograms):
        if name not in seen:
            seen.add(name)
            out.append(f"# TYPE {name} histogram")
        h = _REGISTRY.histograms[(name, lab)]
        cum = 0
        for _lo, hi, c in h.buckets():
            cum += c
            le = _fmt_labels(lab + (("le", f"{hi:g}"),))
            out.append(f"{name}_bucket{le} {cum}")
        le = _fmt_labels(lab + (("le", "+Inf"),))
        out.append(f"{name}_bucket{le} {h.total}")
        out.append(f"{name}_sum{_fmt_labels(lab)} {h.sum_seconds:.9g}")
        out.append(f"{name}_count{_fmt_labels(lab)} {h.total}")
    return "\n".join(out) + ("\n" if out else "")


# ---------------------------------------------------------------------
# the span tracer
# ---------------------------------------------------------------------

class _NullSpan:
    """The shared tracing-off no-op: entering/exiting records nothing
    and allocates nothing (one module-level instance, ever)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

#: tracing state, mutable at runtime via :func:`configure`. A dict so
#: instrumented modules can ``from . import telemetry`` once and still
#: observe later reconfiguration.
_TRACE = {
    "on": trace_enabled_default(),
    "ring": collections.deque(maxlen=trace_ring_default()),
    "dropped": 0,
}

_TLS = threading.local()
_RANK_CACHE = [None]  # resolved lazily; None until a process group exists


def _rank() -> int:
    """The rank events are tagged with: ``torch.distributed``'s rank
    once a process group is initialized (cached from then on), else 0
    and uncached, so a group initialized later still tags later events
    with its rank. torch is only consulted when already imported."""
    if _RANK_CACHE[0] is not None:
        return _RANK_CACHE[0]
    import sys

    if "torch" not in sys.modules:
        return 0
    try:
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return 0  # not (yet) distributed: do not cache
        rank = dist.get_rank()
    except (RuntimeError, ValueError):
        return 0
    _RANK_CACHE[0] = int(rank)
    return _RANK_CACHE[0]


def _stack() -> list:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


def _ambient_tags() -> dict:
    t = getattr(_TLS, "tags", None)
    return t if t else {}


def _ring_append(ev) -> None:
    """Append one event; a full ring evicts its oldest event, and the
    eviction is COUNTED (``dccrg_trace_dropped_total`` + the
    flush-time log) so a truncated trace never reads as complete."""
    ring = _TRACE["ring"]
    if len(ring) == ring.maxlen:
        _TRACE["dropped"] += 1
        _REGISTRY.inc("dccrg_trace_dropped_total")
    ring.append(ev)


class _Span:
    __slots__ = ("name", "tags", "t_wall", "t0")

    def __init__(self, name, tags):
        self.name = name
        self.tags = tags

    def __enter__(self):
        _stack().append(self.name)
        self.t_wall = time.time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        stack = _stack()
        stack.pop()
        ev = {
            "name": self.name,
            "ts": self.t_wall,
            "dur": dur,
            "rank": _rank(),
            "depth": len(stack),
        }
        if stack:
            ev["parent"] = stack[-1]
        amb = _ambient_tags()
        if amb:
            ev.update(amb)
        if self.tags:
            ev.update(self.tags)
        _ring_append(ev)
        return False


def span(name: str, tags: "dict | None" = None):
    """A tracing span: ``with telemetry.span("grid.step"): ...``
    records one ring event (name, wall-clock anchor, monotonic
    duration, rank, nesting depth/parent, tags) on exit. With tracing
    off this returns the shared no-op singleton — the hot-path
    contract is ONE dict lookup and no allocation, so instrumented
    step paths cost nothing in production. ``tags`` is an optional
    plain dict (not kwargs, so the off path never builds one)."""
    if not _TRACE["on"]:
        return _NULL_SPAN
    return _Span(name, tags)


def record_span(name: str, seconds: float,
                tags: "dict | None" = None) -> None:
    """Record an already-measured interval as a span event (the
    after-the-fact form for callers that timed themselves, e.g. the
    hybrid plan builder's phase marks). No-op with tracing off."""
    if not _TRACE["on"]:
        return
    ev = {"name": name, "ts": time.time() - seconds, "dur": float(seconds),
          "rank": _rank(), "depth": len(_stack())}
    amb = _ambient_tags()
    if amb:
        ev.update(amb)
    if tags:
        ev.update(tags)
    _ring_append(ev)


class _TagScope:
    __slots__ = ("kv", "prev")

    def __init__(self, kv):
        self.kv = kv

    def __enter__(self):
        self.prev = getattr(_TLS, "tags", None)
        merged = dict(self.prev) if self.prev else {}
        merged.update(self.kv)
        _TLS.tags = merged
        return self

    def __exit__(self, *exc):
        _TLS.tags = self.prev
        return False


def traced(name: str, tags: "dict | None" = None,
           counter: "str | None" = None):
    """Decorator form of :func:`span` for whole-function boundaries
    (checkpoint save/load/GC phases). With tracing off the wrapper is
    one dict lookup and a tail call. ``counter`` additionally bumps a
    registry counter on every call, traced or not (the metrics side
    is always on)."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if counter is not None:
                _REGISTRY.inc(counter)
            if not _TRACE["on"]:
                return fn(*a, **kw)
            with _Span(name, tags):
                return fn(*a, **kw)
        return wrapper
    return deco


def tags(**kv):
    """Thread-local ambient tags merged into every span recorded
    inside the context (the fleet layer tags checkpoint saves with the
    owning ``job=``). No-op singleton with tracing off."""
    if not _TRACE["on"]:
        return _NULL_SPAN
    return _TagScope(kv)


def trace_enabled() -> bool:
    return bool(_TRACE["on"])


def events() -> list:
    """Snapshot of the in-memory trace ring (oldest first)."""
    return list(_TRACE["ring"])


def clear_trace() -> None:
    _TRACE["ring"].clear()
    _TRACE["dropped"] = 0


def configure(trace=None, ring=None) -> None:
    """Runtime (re)configuration: ``trace=True/False`` toggles span
    recording; ``trace=None`` re-reads ``DCCRG_TRACE``. ``ring``
    resizes the event ring (dropping held events)."""
    if ring is not None:
        _TRACE["ring"] = collections.deque(_TRACE["ring"],
                                           maxlen=max(16, int(ring)))
    _TRACE["on"] = (trace_enabled_default() if trace is None
                    else bool(trace))


# ---------------------------------------------------------------------
# exporters — strictly best-effort, never raise
# ---------------------------------------------------------------------

def _best_effort_write(path: str, payload: str, append: bool) -> bool:
    """One exporter write. Failures (real I/O errors or the injected
    ``telemetry.export`` fault) are counted and swallowed: telemetry
    must NEVER trip, roll back or kill the run it observes."""
    try:
        faults.fire("telemetry.export", path=path)
        with open(path, "a" if append else "w") as f:
            f.write(payload)
        return True
    except Exception as e:  # noqa: BLE001 - best-effort by contract
        _REGISTRY.inc("dccrg_telemetry_export_errors_total")
        logger.debug("telemetry export to %s failed (%s); dropped",
                     path, e)
        return False


def flush_trace(path: "str | None" = None) -> int:
    """Append every ring event to ``path`` (default
    ``DCCRG_TRACE_FILE``, with ``{rank}`` substituted) as JSONL and
    clear the ring. Returns the number of events written (0 when no
    sink is configured or the write failed — the events are dropped
    either way, the ring must not grow into the run)."""
    if path is None:
        path = trace_file_default()
    ring = _TRACE["ring"]
    if not ring:
        return 0
    evs = list(ring)
    ring.clear()
    if _TRACE["dropped"]:
        logger.warning(
            "trace ring overflowed: %d span event(s) were dropped "
            "before this flush (raise DCCRG_TRACE_RING or flush more "
            "often)", _TRACE["dropped"])
        _TRACE["dropped"] = 0
    if path is None:
        return 0
    path = path.replace("{rank}", str(_rank()))
    payload = "".join(json.dumps(e, sort_keys=True) + "\n" for e in evs)
    return len(evs) if _best_effort_write(path, payload, append=True) \
        else 0


def read_trace(path: str) -> list:
    """Parse one JSONL trace file back into event dicts (lines that
    fail to parse — a torn tail from a killed run — are skipped)."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    return out


def merge_traces(paths) -> list:
    """Merge per-rank JSONL trace files into one timeline ordered by
    wall-clock ``ts`` (ties broken by rank then name — deterministic).
    The events already carry their rank tag, so the merged list IS the
    cross-rank story of one run."""
    evs = []
    for p in paths:
        evs.extend(read_trace(p))
    evs.sort(key=lambda e: (e.get("ts", 0.0), e.get("rank", 0),
                            e.get("name", "")))
    return evs


_METRICS_STATE = {"last": None}


def export_metrics(path: "str | None" = None) -> bool:
    """Write :func:`dump_prometheus` to ``path`` (default
    ``DCCRG_METRICS_FILE``). Best-effort; returns success."""
    if path is None:
        path = metrics_file_default()
    if path is None:
        return False
    return _best_effort_write(path, dump_prometheus(), append=False)


def maybe_export_metrics(now: "float | None" = None) -> bool:
    """Periodic metrics export: writes the exposition to
    ``DCCRG_METRICS_FILE`` at most every ``DCCRG_METRICS_EVERY``
    seconds (monotonic clock). The run/scheduler loops call this at
    their boundaries; without the env knob it is one None check."""
    path = metrics_file_default()
    if path is None:
        return False
    t = time.monotonic() if now is None else float(now)
    last = _METRICS_STATE["last"]
    if last is not None and t - last < metrics_every_default():
        return False
    _METRICS_STATE["last"] = t
    return export_metrics(path)


@atexit.register
def _flush_at_exit() -> None:  # pragma: no cover - process teardown
    try:
        if trace_file_default():
            flush_trace()
        if metrics_file_default():
            export_metrics()
    except Exception:  # noqa: BLE001 - never fail interpreter exit
        pass


# ---------------------------------------------------------------------
# trace analysis (shared by the CLI and the tests)
# ---------------------------------------------------------------------

def span_stats(evs) -> dict:
    """Per-span-name aggregates of a trace: ``{name: {count,
    total_s, p50_s, p99_s, max_s}}`` (log-bucket quantiles)."""
    hists: dict = {}
    for e in evs:
        h = hists.get(e.get("name"))
        if h is None:
            h = hists[e.get("name")] = LogHistogram()
        h.record(float(e.get("dur", 0.0)))
    return {n: {"count": h.total, "total_s": h.sum_seconds,
                "p50_s": h.quantile(0.5), "p99_s": h.quantile(0.99),
                "max_s": h.max_seconds}
            for n, h in sorted(hists.items())}


def root_coverage(evs, wall_s: float) -> float:
    """Fraction of ``wall_s`` accounted for by depth-0 spans — the
    "where did the step wall-clock go" acceptance metric (nested spans
    excluded so nothing double-counts)."""
    covered = sum(float(e.get("dur", 0.0)) for e in evs
                  if int(e.get("depth", 0)) == 0)
    return covered / wall_s if wall_s > 0 else 0.0


# ---------------------------------------------------------------------
# Prometheus exposition read-back: the histogram half of `summary`
# ---------------------------------------------------------------------

_PROM_LINE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)"
                        r"(?:\{(.*)\})?\s(\S+)$")
_PROM_LABEL = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)='
                         r'"((?:[^"\\]|\\.)*)"')


def _unescape_label(v: str) -> str:
    # single pass: sequential str.replace would corrupt values like
    # a\n-after-backslash (the \\ must not feed the \n rule)
    return re.sub(r"\\(.)",
                  lambda m: "\n" if m.group(1) == "n" else m.group(1),
                  v)


def parse_prometheus_histograms(text: str) -> dict:
    """Parse the histogram series back out of a Prometheus text
    exposition (a ``DCCRG_METRICS_FILE``): ``{(name, labels):
    {"count", "sum", "buckets": [(le, cumulative)]}}`` with the
    ``le`` label lifted out of the labels and ``+Inf`` mapped to
    ``math.inf``. Counters/gauges are ignored (they read directly);
    this is the read-back path for the numbers the registry's
    :class:`LogHistogram` wrote out."""
    series: dict = {}

    def ent(name, labels):
        key = (name, tuple(sorted(labels.items())))
        return series.setdefault(
            key, {"count": 0, "sum": 0.0, "buckets": []})

    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if m is None:
            continue
        name, labstr, sval = m.groups()
        try:
            val = float(sval)
        except ValueError:
            continue
        labels = {k: _unescape_label(v)
                  for k, v in _PROM_LABEL.findall(labstr or "")}
        if name.endswith("_bucket") and "le" in labels:
            le = labels.pop("le")
            ent(name[:-len("_bucket")], labels)["buckets"].append(
                (math.inf if le in ("+Inf", "+inf", "inf") else
                 float(le), val))
        elif name.endswith("_sum"):
            ent(name[:-len("_sum")], labels)["sum"] = val
        elif name.endswith("_count"):
            ent(name[:-len("_count")], labels)["count"] = int(val)
    out = {}
    for key, s in series.items():
        if not s["buckets"]:
            continue  # a counter that merely ends in _sum/_count
        s["buckets"].sort(key=lambda b: b[0])
        out[key] = s
    return out


def merge_prometheus_histograms(into: dict, more: dict) -> dict:
    """Accumulate one :func:`parse_prometheus_histograms` result into
    another IN PLACE (and return it): same-keyed series SUM their
    counts, sums and per-``le`` cumulative bucket counts — the
    correct merge for per-rank metrics files of one run (a plain
    dict update would silently keep only the last rank's series)."""
    for key, s in more.items():
        have = into.get(key)
        if have is None:
            into[key] = {"count": s["count"], "sum": s["sum"],
                         "buckets": list(s["buckets"])}
            continue
        have["count"] += s["count"]
        have["sum"] += s["sum"]
        by_le = dict(have["buckets"])
        for le, cum in s["buckets"]:
            by_le[le] = by_le.get(le, 0.0) + cum
        have["buckets"] = sorted(by_le.items(), key=lambda b: b[0])
    return into


def _bucket_quantile(buckets, total: int, q: float):
    """Upper bucket edge holding the q-quantile of a cumulative
    ``[(le, cum)]`` list (the same convention as
    :meth:`LogHistogram.quantile`); None when empty/unbounded."""
    if total <= 0:
        return 0.0
    target = max(1, math.ceil(q * total))
    for le, cum in buckets:
        if cum >= target:
            return None if le == math.inf else le
    le = buckets[-1][0]
    return None if le == math.inf else le


def histogram_stats(hists=None) -> dict:
    """Per-histogram ``{series: {count, sum_s, p50_s, p99_s}}`` — the
    same numbers the autopilot controller acts on, readable by
    operators. ``hists=None`` aggregates the LIVE registry histograms;
    otherwise pass a :func:`parse_prometheus_histograms` result (the
    offline ``summary`` CLI path over a metrics file)."""
    out = {}
    if hists is None:
        for (name, lab), h in sorted(_REGISTRY.histograms.items()):
            out[name + _fmt_labels(lab)] = {
                "count": h.total, "sum_s": h.sum_seconds,
                "p50_s": h.quantile(0.5), "p99_s": h.quantile(0.99),
                "max_s": h.max_seconds}
        return out
    for (name, lab), s in sorted(hists.items()):
        out[name + _fmt_labels(lab)] = {
            "count": s["count"], "sum_s": s["sum"],
            "p50_s": _bucket_quantile(s["buckets"], s["count"], 0.5),
            "p99_s": _bucket_quantile(s["buckets"], s["count"], 0.99)}
    return out


# ---------------------------------------------------------------------
# CLI: python -m dccrg_tpu_torch.telemetry merge|summary ...
# ---------------------------------------------------------------------

def _looks_like_prometheus(path: str) -> bool:
    """Sniff a summary input: a Prometheus exposition (a
    ``DCCRG_METRICS_FILE``) vs a JSONL trace. Traces are JSON object
    lines; expositions carry ``# TYPE`` comments / bare samples."""
    try:
        with open(path) as f:
            head = f.read(4096)
    except OSError:
        return False
    for line in head.splitlines():
        line = line.strip()
        if not line:
            continue
        return not line.startswith("{")
    return False


def _main(argv=None) -> int:
    """``python -m dccrg_tpu_torch.telemetry merge <trace.jsonl>...`` prints
    the rank-merged timeline as JSONL; ``summary <file>...`` prints
    per-span aggregates (count, total, p50/p99/max) of JSONL traces
    AND per-histogram p50/p99 of Prometheus metrics files
    (``DCCRG_METRICS_FILE`` expositions — sniffed apart
    automatically), so operators can read the same latency numbers
    the autopilot controller acts on. Works on per-rank files of one
    run (the events carry rank tags) without importing torch."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m dccrg_tpu_torch.telemetry",
                                 description=_main.__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("merge", help="merge per-rank JSONL traces into "
                                     "one ts-ordered timeline")
    m.add_argument("files", nargs="+")
    s = sub.add_parser("summary", help="per-span-name aggregates of "
                                       "traces and per-histogram "
                                       "p50/p99 of metrics files")
    s.add_argument("files", nargs="+")
    args = ap.parse_args(argv)
    if args.cmd == "merge":
        for e in merge_traces(args.files):
            print(json.dumps(e, sort_keys=True))
        return 0
    prom_files = [p for p in args.files if _looks_like_prometheus(p)]
    trace_files = [p for p in args.files if p not in prom_files]
    evs = merge_traces(trace_files)
    out = {"events": len(evs),
           "ranks": sorted({e.get("rank", 0) for e in evs}),
           "spans": span_stats(evs)}
    if prom_files:
        hists: dict = {}
        for p in prom_files:
            try:
                with open(p) as f:
                    merge_prometheus_histograms(
                        hists, parse_prometheus_histograms(f.read()))
            except OSError:
                continue
        out["histograms"] = histogram_stats(hists)
    print(json.dumps(out, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via CLI
    import sys

    sys.exit(_main())
