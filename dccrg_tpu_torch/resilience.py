"""Checkpoint integrity, delta checkpoints, the numerics watchdog, the
OOM fallback chain, the auto-rollback runner and the device probes of
the port (counterpart of ``dccrg_tpu/resilience.py``, whole but for the
multi-process save route).

**Checkpoint integrity**: :func:`save_checkpoint` writes the ``.dc``
bytes atomically (temp file in the same directory, fsync, rename, with
bounded retries on transient I/O errors), then a sidecar
``<file>.crc`` recording a CRC32 of the metadata block and one per
``chunk_bytes`` of payload, plus the payload fingerprint the live grid
held (the ``integrity`` record :func:`audit_checkpoint` re-derives from
the file). :func:`load_checkpoint` verifies the sidecar and raises
:class:`CheckpointCorruptionError` naming the bad chunk, or with
``strict=False`` salvages every intact chunk (corrupt cells come back
zeroed and are listed in the :class:`SalvageReport`). A delta
checkpoint (a ``.dcd`` chained to a keyframe through its sidecar,
written by :func:`save_delta_checkpoint`) loads chain-aware: the chain
is verified and materialized into a scratch file first.

**Numerics watchdog**: :func:`check_finite` is one device reduction
over the watched fields and one host read; :func:`assert_finite`
turns a trip into a :class:`NumericsError` naming fields and cells.
``DCCRG_WATCHDOG=N`` makes ``Grid.run_steps`` check every ~N steps
(off by default).

**OOM fallback chain**: :func:`guarded_step` (``Grid.run_steps_guarded``)
walks *current -> roll -> tables* on a device OOM (``torch.OutOfMemoryError``
or an injected ``RESOURCE_EXHAUSTED``): ``current`` is the caller's
``run_steps`` (kernel A on an eligible grid on the card), ``roll`` the
plain path on the grid's plan (``bulk=False``), ``tables`` the
dense-table plan (``DCCRG_FORCE_TABLES=1`` and a plan rebuild). A
downgrade to ``tables`` keeps the table plan for every later step,
guarded or plain, until a structural rebuild; a call in which every
mode fails puts back the plan it found.

**Auto-rollback**: :class:`ResilientRunner` checkpoints every
``checkpoint_every`` steps, probes for non-finite values (and, opted in,
conservation drift) every ``check_every`` steps, and on a trip rolls back
to the last verified checkpoint, bit for bit with an undisturbed run.

**Device probes**: :func:`safe_devices` asks a subprocess, killed on
timeout, how many cards answer before this process touches one.
``python -m dccrg_tpu_torch.resilience [--timeout S]`` is the probe for
shell scripts; ``verify``, ``chain``, ``audit`` and ``gc`` subcommands
maintain checkpoint directories without a card.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import subprocess
import sys
import time
import zlib
from contextlib import contextmanager
from dataclasses import dataclass, field as dataclass_field

import numpy as np
import torch

from . import background
from . import checkpoint as checkpoint_mod
from . import faults, telemetry

logger = logging.getLogger("dccrg_tpu_torch.resilience")

CRC_CHUNK = 1 << 20  # bytes per sidecar checksum chunk
SIDECAR_FORMAT = "dccrg-dc-crc-v1"
SIDECAR_SUFFIX = ".crc"
#: Incremental (delta) checkpoints of the reference: a ``.dcd`` file is
#: a valid ``.dc`` of the dirty-field sub-schema, chained to a parent
#: save through its sidecar's ``delta`` record.
DELTA_SUFFIX = ".dcd"
_MAX_CHAIN = 4096  # delta-chain depth bound (cycle backstop)


class CheckpointCorruptionError(ValueError):
    """A checkpoint failed integrity verification. ``bad_chunks`` holds
    the failing sidecar chunk indices (empty when the sidecar itself is
    missing/unreadable)."""

    def __init__(self, msg, bad_chunks=()):
        super().__init__(msg)
        self.bad_chunks = list(bad_chunks)


class DeltaChainError(CheckpointCorruptionError):
    """A delta checkpoint's keyframe+delta chain cannot be restored end
    to end. ``link`` names the broken file; ``chain`` lists the link
    paths resolved so far (keyframe first, when known)."""

    def __init__(self, msg, link=None, chain=()):
        super().__init__(msg)
        self.link = link
        self.chain = list(chain)


class NumericsError(RuntimeError):
    """The watchdog found non-finite values. ``details`` maps field
    name -> offending cell ids."""

    def __init__(self, msg, details=None):
        super().__init__(msg)
        self.details = details or {}


class ResilienceExhaustedError(RuntimeError):
    """Every bounded recovery attempt failed; the error is surfaced."""


class DeviceProbeError(RuntimeError):
    """The device backend did not answer a probe within its budget."""


class RunInterrupted(RuntimeError):
    """The step loop stopped cleanly at a step boundary because a
    preemption was requested; the grid holds exactly ``step``
    completed steps."""

    def __init__(self, step: int):
        super().__init__(
            f"run interrupted at the boundary after step {step} "
            "(preemption requested; state is consistent on every rank)")
        self.step = int(step)


# ---------------------------------------------------------------------
# checkpoint integrity: CRC sidecar + atomic save + verifying load
# ---------------------------------------------------------------------

def sidecar_path(filename: str) -> str:
    return filename + SIDECAR_SUFFIX


def _chunk_ranges(payload_start, file_bytes, chunk_bytes, n=None):
    """Byte ranges of the sidecar chunks: chunk 0 is exactly the
    metadata block [0, payload_start) — mapping / geometry / offset
    table, whose corruption is never salvageable — and chunks >= 1 tile
    the payload in ``chunk_bytes`` pieces, so a bad payload chunk maps
    onto a bounded set of cells."""
    ranges = [(0, payload_start)]
    pos = payload_start
    while pos < file_bytes or (n is not None and len(ranges) < n):
        ranges.append((pos, min(pos + chunk_bytes, file_bytes)))
        pos += chunk_bytes
    return ranges


def _range_crcs(path: str, ranges, block: int = CRC_CHUNK) -> list:
    """CRC32 of each ``[lo, hi)`` byte range of ``path``, streamed
    ``block`` bytes at a time (``zlib.crc32`` is incremental, so no
    range materializes in host memory). A range truncated away
    checksums only the bytes that exist, so it mismatches."""
    out = []
    with open(path, "rb") as f:
        for lo, hi in ranges:
            f.seek(int(lo))
            crc, left = 0, int(hi) - int(lo)
            while left > 0:
                buf = f.read(min(block, left))
                if not buf:
                    break
                crc = zlib.crc32(buf, crc)
                left -= len(buf)
            out.append(crc & 0xFFFFFFFF)
    return out


def _stream_crcs(path: str, chunk_ranges, spans, block: int = CRC_CHUNK):
    """One sequential pass computing the CRC32s of both the chunk
    tiling (``chunk_ranges``: contiguous, in order) and an overlay of
    ``spans`` (sorted by start, non-overlapping: the per-rank slice
    runs of a multi-process save). Returns ``(chunk_crcs, span_crcs)``."""
    chunk_crcs = []
    span_crcs = [0] * len(spans)
    si = 0
    with open(path, "rb") as f:
        for lo, hi in chunk_ranges:
            f.seek(int(lo))
            crc, pos, left = 0, int(lo), int(hi) - int(lo)
            while left > 0:
                buf = f.read(min(block, left))
                if not buf:
                    break
                crc = zlib.crc32(buf, crc)
                blo, bhi = pos, pos + len(buf)
                while si < len(spans) and spans[si][1] <= blo:
                    si += 1  # spans fully behind this block are done
                j = si
                while j < len(spans) and spans[j][0] < bhi:
                    s = max(int(spans[j][0]), blo)
                    e = min(int(spans[j][1]), bhi)
                    if s < e:
                        span_crcs[j] = zlib.crc32(buf[s - blo:e - blo],
                                                  span_crcs[j])
                    j += 1
                pos = bhi
                left -= len(buf)
            chunk_crcs.append(crc & 0xFFFFFFFF)
    return chunk_crcs, [c & 0xFFFFFFFF for c in span_crcs]


def _sidecar_record(path: str, header_size: int = 0,
                    chunk_bytes: int = CRC_CHUNK) -> dict:
    """The sidecar record for ``path``'s current bytes, checksummed in
    ``chunk_bytes`` streams (the metadata parse pages in only the head
    of a memory map)."""
    file_bytes = os.path.getsize(path)
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    payload_start = checkpoint_mod.payload_start(raw, header_size)
    del raw
    ranges = _chunk_ranges(payload_start, file_bytes, chunk_bytes)
    crcs = _range_crcs(path, ranges, chunk_bytes)
    return {"format": SIDECAR_FORMAT, "chunk_bytes": chunk_bytes,
            "file_bytes": file_bytes, "payload_start": payload_start,
            "header_size": header_size, "crc32": crcs}


def _write_sidecar_record(side: str, rec: dict) -> None:
    tmp = side + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(rec, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, side)


def write_sidecar(filename: str, header_size: int = 0,
                  chunk_bytes: int = CRC_CHUNK) -> str:
    """Checksum ``filename`` into its ``.crc`` sidecar: CRC32 of the
    metadata block (chunk 0), then one CRC32 per ``chunk_bytes`` of
    payload. The ``.dc`` file itself is untouched."""
    side = sidecar_path(filename)
    _write_sidecar_record(side, _sidecar_record(filename, header_size,
                                                chunk_bytes))
    return side


def read_sidecar(filename: str):
    """The parsed sidecar record, or None when none exists. An
    unparseable or implausible sidecar raises
    CheckpointCorruptionError (corruption hit the sidecar itself)."""
    side = sidecar_path(filename)
    if not os.path.exists(side):
        return None
    try:
        with open(side) as f:
            rec = json.load(f)
        if rec.get("format") != SIDECAR_FORMAT:
            raise ValueError(f"unknown sidecar format {rec.get('format')!r}")
        # a sidecar corrupted at rest can still parse as JSON: reject
        # implausible geometry before the chunk-range math runs on it
        cb = int(rec["chunk_bytes"])
        fb = int(rec["file_bytes"])
        ps = int(rec["payload_start"])
        crcs = rec["crc32"]
        if (cb <= 0 or fb < 0 or not 0 <= ps <= fb
                or not isinstance(crcs, list)
                or not all(isinstance(c, int) for c in crcs)):
            raise ValueError("implausible sidecar geometry")
        # the crc list must cover the whole recorded file, or trailing
        # payload chunks would go unverified
        want_chunks = 1 + max(0, -(-(fb - ps) // cb))
        if len(crcs) != want_chunks:
            raise ValueError(
                f"sidecar records {len(crcs)} chunk crc(s), geometry "
                f"implies {want_chunks}")
        # multi-process saves of the reference add a per-rank slice
        # table [dev, rank, lo, hi, crc]
        sl = rec.get("slices")
        if sl is not None and not (
                isinstance(sl, list)
                and all(isinstance(s, list) and len(s) == 5
                        and all(isinstance(v, int) for v in s)
                        and 0 <= s[2] <= s[3] <= fb
                        for s in sl)):
            raise ValueError("implausible per-rank slice table")
        # delta saves add the dirty-field list and the parent link
        d = rec.get("delta")
        if d is not None:
            p = d.get("parent") if isinstance(d, dict) else None
            if not (isinstance(d, dict)
                    and isinstance(d.get("fields"), list)
                    and all(isinstance(f, str) for f in d["fields"])
                    and isinstance(d.get("step"), int)
                    and isinstance(p, dict)
                    and isinstance(p.get("file"), str) and p["file"]
                    and os.path.basename(p["file"]) == p["file"]
                    and isinstance(p.get("step"), int)
                    and isinstance(p.get("digest"), int)):
                raise ValueError("implausible delta record")
        # the payload fingerprint {field: [s1, s2, nbytes]}
        integ = rec.get("integrity")
        if integ is not None and not (
                isinstance(integ, dict)
                and all(isinstance(k, str) and isinstance(v, list)
                        and len(v) == 3
                        and all(isinstance(x, int) for x in v)
                        and v[2] > 0
                        for k, v in integ.items())):
            raise ValueError("implausible integrity record")
        return rec
    except (ValueError, KeyError, TypeError) as e:
        raise CheckpointCorruptionError(
            f"unreadable checksum sidecar {side}: {e}") from e


def _rec_ranges(rec) -> list:
    return _chunk_ranges(int(rec["payload_start"]), int(rec["file_bytes"]),
                         int(rec["chunk_bytes"]), n=len(rec["crc32"]))


def _chunk_name(i: int, ranges) -> str:
    if i >= len(ranges):  # the trailing-garbage sentinel
        return "trailing bytes past the recorded file size"
    lo, hi = ranges[i]
    what = "metadata block" if i == 0 else f"payload chunk {i}"
    return f"{what} (bytes {lo}-{max(lo, hi - 1)})"


def _bad_chunks(filename: str, rec) -> list:
    """Indices of sidecar chunks whose CRC32 no longer matches,
    streamed ``chunk_bytes`` at a time. Chunks truncated away count as
    bad; garbage appended past the recorded size is reported as the
    sentinel index one past the last chunk (salvage just trims it)."""
    want = rec["crc32"]
    got = _range_crcs(filename, _rec_ranges(rec), int(rec["chunk_bytes"]))
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if g != (w & 0xFFFFFFFF)]
    if os.path.getsize(filename) > int(rec["file_bytes"]):
        bad.append(len(want))
    return bad


def _bad_slices(filename: str, rec) -> list:
    """Indices of per-rank slice entries (multi-process saves of the
    reference record ``[dev, rank, lo, hi, crc]`` per written run)
    whose bytes no longer match: whose write the damage was."""
    sl = rec.get("slices") or []
    if not sl:
        return []
    got = _range_crcs(filename, [(int(s[2]), int(s[3])) for s in sl])
    return [i for i, s in enumerate(sl)
            if got[i] != (int(s[4]) & 0xFFFFFFFF)]


def verify_checkpoint(filename: str, require_sidecar: bool = True) -> list:
    """Verify ``filename`` against its sidecar. Returns the bad chunk
    indices (empty = intact). Raises CheckpointCorruptionError when the
    sidecar is missing and ``require_sidecar``."""
    rec = read_sidecar(filename)
    if rec is None:
        if require_sidecar:
            raise CheckpointCorruptionError(
                f"{filename}: no checksum sidecar ({sidecar_path(filename)}); "
                "wrote with a pre-resilience save, or the sidecar was lost. "
                "Load with strict=False to proceed unverified."
            )
        return []
    return _bad_chunks(filename, rec)


# ---------------------------------------------------------------------
# delta chains (read side): sidecar parent links to a keyframe
# ---------------------------------------------------------------------

def record_digest(rec) -> int:
    """Content digest of a sidecar record: CRC32 over the per-chunk
    CRC list and the file size, chained with the parent's digest for
    delta records. Derived, never stored, so a replaced parent breaks
    its children's recorded links."""
    crcs = np.asarray([int(c) & 0xFFFFFFFF for c in rec["crc32"]],
                      dtype=np.uint32)
    d = zlib.crc32(crcs.tobytes(),
                   zlib.crc32(struct.pack("<Q", int(rec["file_bytes"]))))
    delta = rec.get("delta")
    if delta:
        d = zlib.crc32(
            struct.pack("<I", int(delta["parent"]["digest"]) & 0xFFFFFFFF),
            d)
    return d & 0xFFFFFFFF


def is_delta_checkpoint(filename: str, rec=None) -> bool:
    """True when ``filename`` is an incremental (delta) save — by its
    ``.dcd`` suffix or its sidecar's delta record."""
    if filename.endswith(DELTA_SUFFIX):
        return True
    if rec is None:
        try:
            rec = read_sidecar(filename)
        except CheckpointCorruptionError:
            return False
    return bool(rec and rec.get("delta"))


def chain_links(filename: str) -> list:
    """Resolve ``filename``'s keyframe+delta chain from sidecar parent
    links: ``[(path, record)]`` keyframe first (a full checkpoint is
    its own one-link chain). Every parent's content digest is checked
    against the child's link. Raises :class:`DeltaChainError` naming
    the broken link on a missing file or sidecar, a digest mismatch
    or a cycle."""
    links, seen = [], set()
    cur = os.path.abspath(filename)
    dirpath = os.path.dirname(cur)
    expect = None  # the child's recorded parent digest
    while True:
        done = [p for p, _r in reversed(links)]
        if cur in seen or len(links) >= _MAX_CHAIN:
            raise DeltaChainError(
                f"{filename}: delta parent links form a cycle at {cur}",
                link=cur, chain=done)
        seen.add(cur)
        if not os.path.exists(cur):
            raise DeltaChainError(
                f"{filename}: chain link {cur} is missing (its keyframe "
                "or an intermediate delta was deleted)", link=cur,
                chain=done)
        try:
            rec = read_sidecar(cur)
        except CheckpointCorruptionError as e:
            raise DeltaChainError(
                f"{filename}: chain link {cur} has an unreadable "
                f"sidecar ({e})", link=cur, chain=done) from e
        if rec is None:
            raise DeltaChainError(
                f"{filename}: chain link {cur} has no sidecar — a delta "
                "chain cannot be interpreted without one (the "
                "dirty-field list and parent link live there)",
                link=cur, chain=done)
        if expect is not None and record_digest(rec) != expect:
            raise DeltaChainError(
                f"{filename}: chain link {cur} does not match its "
                f"child's recorded parent digest {expect:#010x} — the "
                "parent was overwritten by a different save", link=cur,
                chain=done)
        links.append((cur, rec))
        delta = rec.get("delta")
        if not delta:
            break
        expect = int(delta["parent"]["digest"]) & 0xFFFFFFFF
        cur = os.path.join(dirpath, delta["parent"]["file"])
    links.reverse()
    return links


def verify_chain(filename: str, assume_ok=(), _memo=None) -> list:
    """Verify every link of ``filename``'s chain (bytes against each
    sidecar's chunk CRCs, plus the parent digest links) and return the
    link paths, keyframe first. Raises :class:`DeltaChainError` naming
    the FIRST broken link in chain order. ``assume_ok`` paths skip the
    byte pass; ``_memo`` caches per-file results across calls."""
    links = chain_links(filename)
    memo = _memo if _memo is not None else {}
    vouched = {os.path.abspath(p) for p in assume_ok}
    for path, rec in links:
        if path in vouched:
            continue
        bad = memo.get(path)
        if bad is None:
            bad = memo[path] = _bad_chunks(path, rec)
        if bad:
            names = ", ".join(_chunk_name(i, _rec_ranges(rec))
                              for i in bad)
            raise DeltaChainError(
                f"{filename}: chain link {path} fails verification "
                f"({names})", link=path, chain=[p for p, _r in links])
    return [p for p, _r in links]


def _chain_scratch(path: str) -> str:
    """Writable scratch path for a chain materialization: next to the
    checkpoint when its directory is writable (same filesystem), else
    the system temp dir (a read-only checkpoint directory stays
    loadable)."""
    dirpath = os.path.dirname(os.path.abspath(path))
    if os.access(dirpath, os.W_OK):
        return path + f".chain.{os.getpid()}"
    import tempfile

    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".chain.")
    os.close(fd)
    return tmp


def materialize_chain(filename: str, out_path: str, cell_data,
                      variable=None, verify: bool = True,
                      _memo=None) -> list:
    """Reconstruct the full checkpoint bytes of delta ``filename`` into
    ``out_path``: copy the keyframe, then overlay each delta's
    dirty-field columns in chain order (a strided byte scatter in
    bounded blocks). ``cell_data`` is the field schema (``Grid.fields``
    works too); returns the chain's link paths."""
    import shutil

    links = chain_links(filename)
    if verify:
        verify_chain(filename, _memo=_memo)
    key_path, key_rec = links[0]
    fields = checkpoint_mod.cell_data_fields(cell_data)
    fixed_spec, _fixed_bytes, _var = checkpoint_mod._payload_spec_of(
        fields, variable)
    col_of = {}
    col = 0
    for name, _shape, _dtype, nbytes in fixed_spec:
        col_of[name] = col
        col += nbytes

    shutil.copyfile(key_path, out_path)
    header_size = int(key_rec.get("header_size", 0))
    raw_out = np.memmap(out_path, dtype=np.uint8, mode="r+")
    try:
        meta = checkpoint_mod.parse_metadata(raw_out, header_size)
        cells_full, offs_full = meta[4], meta[5].astype(np.int64)
        for dpath, drec in links[1:]:
            dnames = list(drec["delta"]["fields"])
            if not dnames:
                continue
            raw_d = np.memmap(dpath, dtype=np.uint8, mode="r")
            dmeta = checkpoint_mod.parse_metadata(
                raw_d, int(drec.get("header_size", 0)))
            dcells, doffs = dmeta[4], dmeta[5].astype(np.int64)
            if not np.array_equal(dcells, cells_full):
                raise DeltaChainError(
                    f"{filename}: delta {dpath} records a different "
                    "cell list than its keyframe (a structural change "
                    "without a keyframe — the chain is inconsistent)",
                    link=dpath, chain=[p for p, _r in links])
            try:
                dspec, _db, _dv = checkpoint_mod._payload_spec_of(
                    {n: fields[n] for n in dnames}, None)
            except KeyError as e:
                raise DeltaChainError(
                    f"{filename}: delta {dpath} stores field {e} not in "
                    "the caller's schema", link=dpath,
                    chain=[p for p, _r in links]) from e
            src_col = 0
            for name, _shape, _dtype, nbytes in dspec:
                dst = offs_full + col_of[name]
                src = doffs + src_col
                span = np.arange(nbytes, dtype=np.int64)[None, :]
                blk = max(1, (8 << 20) // max(nbytes, 1))
                for s in range(0, len(cells_full), blk):
                    e = min(s + blk, len(cells_full))
                    raw_out[dst[s:e, None] + span] = \
                        raw_d[src[s:e, None] + span]
                src_col += nbytes
            del raw_d
        raw_out.flush()
    finally:
        del raw_out
    return [p for p, _r in links]


# ---------------------------------------------------------------------
# the atomic save and the at-rest audit
# ---------------------------------------------------------------------

@telemetry.traced("ckpt.save")
def save_checkpoint(grid, filename: str, header: bytes = b"",
                    variable=None, sidecar: bool = True, retries: int = 2,
                    backoff: float = 0.1, chunk_bytes: int = CRC_CHUNK,
                    *, fields=None, sidecar_extra=None) -> str:
    """Atomic checkpoint save: the ``.dc`` bytes stream into a temp
    file in the target directory, fsync, then one rename — a crash at
    any point leaves either the old or the new checkpoint complete,
    never a torn file under the final name. Transient I/O errors retry
    with exponential backoff. With ``sidecar`` (default) the per-chunk
    CRC32 sidecar, with the live grid's payload fingerprint, is
    written after the rename.

    ``fields`` restricts the save to a field subset and
    ``sidecar_extra`` merges extra keys (the delta parent link) into
    the sidecar record: the incremental-save plumbing; use
    :func:`save_delta_checkpoint` rather than passing them directly."""
    kind = ("delta" if sidecar_extra and "delta" in sidecar_extra
            else "keyframe")
    telemetry.inc("dccrg_saves_total", kind=kind)
    t_save = time.perf_counter()
    phase = checkpoint_mod.phase
    tmp = filename + f".tmp.{os.getpid()}"
    side = sidecar_path(filename)
    rec = None
    for attempt in range(retries + 1):
        try:
            with phase("write"):
                checkpoint_mod.save_grid_data(grid, tmp, header=header,
                                              variable=variable,
                                              fields=fields)
            faults.fire("checkpoint.write", path=filename, attempt=attempt)
            with phase("fsync"), open(tmp, "rb+") as f:
                f.flush()
                os.fsync(f.fileno())
            if sidecar:
                # checksum the TEMP bytes so the record always matches
                # the file the rename publishes
                with phase("sidecar"):
                    rec = _sidecar_record(tmp, header_size=len(header),
                                          chunk_bytes=chunk_bytes)
                if sidecar_extra:
                    rec.update(sidecar_extra)
                with phase("integrity"):
                    integ = _integrity_record(grid, fields, variable)
                if integ:
                    rec["integrity"] = integ
            # drop any previous sidecar BEFORE the rename: a crash in
            # this window leaves the new file with no sidecar (which
            # strict load refuses), never a new file paired with a
            # stale record. Keep the old record's bytes: if the rename
            # fails, the OLD checkpoint is still the one under the
            # final name and must stay verifiable.
            old_side = None
            if os.path.exists(side):
                with open(side, "rb") as f:
                    old_side = f.read()
                os.unlink(side)
            try:
                os.replace(tmp, filename)
            except OSError:
                _restore_sidecar(side, old_side)
                raise
            _fsync_dir(os.path.dirname(os.path.abspath(filename)))
            break
        except OSError as e:
            if os.path.exists(tmp):
                os.unlink(tmp)
            if attempt >= retries:
                raise
            delay = backoff * (2 ** attempt)
            logger.warning(
                "checkpoint save of %s failed (%s); retry %d/%d in %.2fs",
                filename, e, attempt + 1, retries, delay)
            time.sleep(delay)
    if rec is not None:
        _write_sidecar_record(side, rec)
    # post-write corruption injection happens AFTER the sidecar records
    # the good bytes: the at-rest corruption CRCs exist for
    faults.corrupt_file(filename)
    telemetry.observe("dccrg_ckpt_save_seconds",
                      time.perf_counter() - t_save, kind=kind)
    return filename


@telemetry.traced("ckpt.delta")
def save_delta_checkpoint(grid, filename: str, *, parent_path: str,
                          parent_step: int, step: int, fields,
                          header: bytes = b"", variable=None,
                          retries: int = 2, backoff: float = 0.1,
                          chunk_bytes: int = CRC_CHUNK) -> str:
    """Incremental checkpoint: save only ``fields`` (the dirty set
    since ``parent_path``) as a ``.dcd`` file, a valid ``.dc`` of the
    sub-schema saved with the same atomic temp + fsync + rename, whose
    sidecar records the parent link ``{file, step, digest}``. A chain
    is only valid within one structure epoch and with fixed-size fields
    (:meth:`dccrg_tpu_torch.supervise.CheckpointStore.save` forces a
    keyframe otherwise). Restored chain-aware by :func:`load_checkpoint`
    and ``resume_latest``, bit for bit an uninterrupted full save."""
    extra = delta_sidecar_extra(parent_path, parent_step=parent_step,
                                step=step, fields=fields,
                                variable=variable)
    return save_checkpoint(grid, filename, header=header,
                           variable=variable, retries=retries,
                           backoff=backoff, chunk_bytes=chunk_bytes,
                           fields=extra["delta"]["fields"],
                           sidecar_extra=extra)


def delta_sidecar_extra(parent_path: str, *, parent_step: int, step: int,
                        fields, variable=None) -> dict:
    """The delta save's ``sidecar_extra`` record: the sorted dirty
    field list plus the parent link ``{file, step, digest}`` (the digest
    of the parent's CURRENT sidecar, so a replaced parent is detected
    at load). Split out of :func:`save_delta_checkpoint` so the async
    save can resolve the link synchronously, while the drained parent
    is durable, before handing the write to its thread. Raises
    :class:`CheckpointCorruptionError` when the parent has no sidecar
    (the caller falls back to a keyframe)."""
    fields = sorted(fields)
    var = variable or {}
    ragged = set(var) | set(var.values())
    if ragged & set(fields):
        raise ValueError(
            f"delta fields {sorted(ragged & set(fields))} are ragged "
            "(or ragged counts): their per-cell byte sizes move the "
            "offset table — only a full keyframe may capture that")
    parent_rec = read_sidecar(parent_path)
    if parent_rec is None:
        raise CheckpointCorruptionError(
            f"{parent_path}: delta parent has no sidecar; save a "
            "keyframe instead")
    digest = record_digest(parent_rec)
    if faults.take_delta_parent_corrupt():
        digest ^= 0x5A5A5A5A  # injected parent-link corruption
    return {"delta": {
        "fields": fields, "step": int(step),
        "parent": {"file": os.path.basename(parent_path),
                   "step": int(parent_step),
                   "digest": int(digest)}}}


def _integrity_record(grid, fields, variable) -> dict:
    """The sidecar ``integrity`` record: the payload fingerprint
    ``{field: [s1, s2, nbytes]}`` of the grid's LIVE device state
    (:func:`dccrg_tpu_torch.integrity.grid_fingerprint`) for the saved
    fields, which :func:`audit_checkpoint` later re-derives from the
    file's payload columns alone. Ragged (variable) fields are
    excluded. Empty when ``DCCRG_INTEGRITY=0``."""
    from . import integrity

    if not integrity.integrity_enabled():
        return {}
    var = variable or {}
    names = [n for n in sorted(fields if fields is not None
                               else grid.fields) if n not in var]
    if not names:
        return {}
    out = {}
    fp = integrity.grid_fingerprint(grid, names)
    for n in names:
        shape, dtype = grid.fields[n]
        nbytes = int(np.prod(shape, dtype=np.int64) or 1) * \
            checkpoint_mod.storage_dtype(dtype).itemsize
        out[n] = [int(fp[n][0]), int(fp[n][1]), nbytes]
    return out


def audit_checkpoint(filename: str) -> "dict | None":
    """Offline at-rest audit: re-derive the payload fingerprint of
    ``filename`` from its bytes and compare it with the ``integrity``
    record its sidecar captured from the live device state at save
    time. Returns ``{field: (ok, got_pair, want_pair)}``, or None when
    the sidecar carries no integrity record. CRCs verify the file
    matches what was written; the fingerprint verifies what was written
    matches what the grid held."""
    from . import integrity

    rec = read_sidecar(filename)
    if rec is None:
        raise CheckpointCorruptionError(
            f"{filename}: no checksum sidecar; nothing to audit "
            "against")
    integ = rec.get("integrity")
    if not integ:
        return None
    # a bytes-only schema: the column walk needs each fixed field's
    # serialized width and the sorted-name order, both in the record
    fields = {n: ((int(v[2]),), np.uint8) for n, v in integ.items()}
    raw = np.memmap(filename, dtype=np.uint8, mode="r")
    try:
        meta = checkpoint_mod.parse_metadata(
            raw, int(rec.get("header_size", 0)))
        cols = checkpoint_mod.payload_columns(raw, meta, fields)
        out = {}
        for n, v in integ.items():
            got = integrity.fingerprint_rows(cols[n])
            want = (int(v[0]) & 0xFFFFFFFF, int(v[1]) & 0xFFFFFFFF)
            out[n] = (got == want, got, want)
        return out
    finally:
        del raw


def _restore_sidecar(side: str, old_side) -> None:
    """Put a displaced sidecar's bytes back after a failed rename:
    atomic (tmp + fsync + rename) and best effort — a torn restore must
    not shadow the original failure, and a missing sidecar is the
    conservative state."""
    if old_side is None:
        return
    try:
        rtmp = side + f".tmp.{os.getpid()}"
        with open(rtmp, "wb") as f:
            f.write(old_side)
            f.flush()
            os.fsync(f.fileno())
        os.replace(rtmp, side)
    except OSError:  # double fault
        pass


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # exotic filesystems
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# ---------------------------------------------------------------------
# the verifying load
# ---------------------------------------------------------------------

@dataclass
class SalvageReport:
    """What a non-strict load had to work around. ``bad_slices`` /
    ``dead_ranks`` attribute the damage when the sidecar carries a
    multi-process slice table; ``chain`` lists the keyframe+delta link
    paths a chain-aware load replayed (keyframe first)."""

    bad_chunks: list = dataclass_field(default_factory=list)
    corrupt_cells: np.ndarray = dataclass_field(
        default_factory=lambda: np.empty(0, np.uint64))
    sidecar_missing: bool = False
    bad_slices: list = dataclass_field(default_factory=list)
    dead_ranks: list = dataclass_field(default_factory=list)
    chain: list = dataclass_field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.bad_chunks and not self.sidecar_missing


@telemetry.traced("ckpt.load", counter="dccrg_loads_total")
def load_checkpoint_into(grid, filename: str, *, header_size: int = 0,
                         variable=None, verify: bool = True) -> None:
    """Load a checkpoint's exact bytes into an ALREADY-CONSTRUCTED
    grid of matching structure (the rollback primitive). A delta
    checkpoint verifies and materializes its whole chain into a scratch
    file first (a broken chain raises :class:`DeltaChainError`); a full
    checkpoint is CRC-verified against its sidecar (``verify=False``
    skips that for bytes the caller just wrote and verified)."""
    if is_delta_checkpoint(filename):
        tmp = _chain_scratch(filename)
        try:
            materialize_chain(filename, tmp, grid.fields,
                              variable=variable, verify=verify)
            checkpoint_mod.load_grid_data(grid, tmp,
                                          header_size=header_size,
                                          variable=variable)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    else:
        if verify:
            bad = verify_checkpoint(filename)
            if bad:
                raise CheckpointCorruptionError(
                    f"rollback target {filename} is itself "
                    f"corrupt (chunks {bad})", bad_chunks=bad)
        checkpoint_mod.load_grid_data(grid, filename,
                                      header_size=header_size,
                                      variable=variable)
    grid.update_copies_of_remote_neighbors()


@telemetry.traced("ckpt.load", counter="dccrg_loads_total")
def load_checkpoint(filename: str, cell_data, device=None,
                    header_size: int = 0, variable=None,
                    strict: bool = True):
    """Restart from a checkpoint with integrity verification; the grid
    is built from the file alone on ``device`` (the card unless the
    caller asks for the CPU).

    Returns ``(grid, header, report)``. With ``strict`` (default) any
    checksum mismatch — or a missing sidecar — raises
    :class:`CheckpointCorruptionError` naming the bad chunk. With
    ``strict=False`` intact chunks are salvaged: corrupt byte ranges
    are zeroed before the load, so affected cells come back with zero
    values (variable-size fields read a zero count) and are listed in
    ``report.corrupt_cells``. Corruption inside the metadata block is
    never salvageable and raises in both modes.

    A delta checkpoint loads chain-aware: the chain is verified,
    materialized into a scratch file (``<file>.chain.<pid>``, removed
    afterwards) and loaded; a broken chain raises
    :class:`DeltaChainError` naming the broken link in both modes."""
    rec = read_sidecar(filename)
    load = checkpoint_mod.load_grid
    if is_delta_checkpoint(filename, rec):
        if rec is None:
            raise DeltaChainError(
                f"{filename}: a delta checkpoint without its sidecar "
                "cannot be interpreted (the dirty-field list and parent "
                "link live there); resume from an older link instead",
                link=filename)
        tmp = _chain_scratch(filename)
        try:
            chain = materialize_chain(filename, tmp, cell_data,
                                      variable=variable)
            grid, header = load(tmp, cell_data, device=device,
                                header_size=header_size, variable=variable)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return grid, header, SalvageReport(chain=chain)
    if rec is None:
        if strict:
            raise CheckpointCorruptionError(
                f"{filename}: no checksum sidecar; load with strict=False "
                "to proceed unverified")
        logger.warning("%s: loading without checksum verification "
                       "(sidecar missing)", filename)
        grid, header = load(filename, cell_data, device=device,
                            header_size=header_size, variable=variable)
        return grid, header, SalvageReport(sidecar_missing=True)

    with checkpoint_mod.phase("verify"):
        bad = _bad_chunks(filename, rec)
    if not bad:
        grid, header = load(filename, cell_data, device=device,
                            header_size=header_size, variable=variable)
        return grid, header, SalvageReport()

    # attribution: which ranks' slices cover the damage
    bad_sl = _bad_slices(filename, rec)
    dead = sorted({int(rec["slices"][i][1]) for i in bad_sl})
    all_ranges = _rec_ranges(rec)
    names = ", ".join(_chunk_name(i, all_ranges) for i in bad)
    if dead:
        names += (f"; slice(s) written by rank(s) {dead} fail their "
                  "CRC32")
    if strict:
        raise CheckpointCorruptionError(
            f"{filename}: checksum mismatch in {names}", bad_chunks=bad)

    # -- salvage: zero the corrupt ranges, load, report the cells -----
    if 0 in bad:
        raise CheckpointCorruptionError(
            f"{filename}: corruption in the {names}; the metadata block "
            "(mapping/geometry/offset table) cannot be trusted — not "
            "salvageable", bad_chunks=bad)
    file_bytes = int(rec["file_bytes"])
    with open(filename, "rb") as f:
        raw = bytearray(f.read())
    # a truncated file is padded back to the recorded size with zeros
    # (the missing tail is inside a corrupt range anyway); trailing
    # garbage past the recorded size is trimmed
    if len(raw) < file_bytes:
        raw += bytes(file_bytes - len(raw))
    del raw[file_bytes:]

    ranges = [all_ranges[i] for i in bad if i < len(all_ranges)]
    try:
        meta = checkpoint_mod.parse_metadata(bytes(raw), header_size)
    except Exception as e:  # metadata CRC passed but parse still failed
        raise CheckpointCorruptionError(
            f"{filename}: metadata unreadable ({e}); corruption in {names} "
            "is not salvageable", bad_chunks=bad) from e
    cells, offsets = meta[4], meta[5]

    for lo, hi in ranges:
        raw[lo:hi] = bytes(hi - lo)

    # per-cell payload extents from the (intact) offset table
    offs = offsets.astype(np.int64)
    ends = np.empty_like(offs)
    ends[:-1] = offs[1:]
    if len(ends):
        ends[-1] = file_bytes
    hit = np.zeros(len(cells), dtype=bool)
    for lo, hi in ranges:
        hit |= (offs < hi) & (ends > lo)
    corrupt_cells = cells[hit].copy()

    tmp = filename + f".salvage.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(bytes(raw))
        grid, header = load(tmp, cell_data, device=device,
                            header_size=header_size, variable=variable)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    logger.warning(
        "%s: salvaged around %s — %d cell(s) restored with default "
        "values: %s", filename, names, len(corrupt_cells),
        corrupt_cells[:16].tolist())
    return grid, header, SalvageReport(bad_chunks=bad,
                                       corrupt_cells=corrupt_cells,
                                       bad_slices=bad_sl,
                                       dead_ranks=dead)


# ---------------------------------------------------------------------
# numerics watchdog
# ---------------------------------------------------------------------

def _inexact_fields(grid, fields=None):
    names = list(fields) if fields is not None else list(grid.fields)
    return [n for n in names
            if grid.fields[n][1].is_floating_point
            or grid.fields[n][1].is_complex]


def check_finite(grid, fields=None) -> bool:
    """The watchdog probe: every element of the watched fields is
    finite, reduced on the grid's device to ONE value read by the
    host. Cheap enough to run every few steps; :func:`assert_finite`
    locates the offenders only on a trip."""
    names = _inexact_fields(grid, fields)
    if not names:
        return True
    # every partition's all(isfinite), then one min over the partitions
    # (comm.all_finite, the reference's probe,
    # dccrg_tpu/resilience.py:1105-1136)
    from . import comm

    return bool(int(comm.all_finite([grid.data[n] for n in names])[0]))


def assert_finite(grid, fields=None, step=None) -> None:
    """Raise :class:`NumericsError` (naming fields and cell ids) when
    the watchdog probe trips."""
    if check_finite(grid, fields):
        return
    from . import verify

    details = verify.find_nonfinite_cells(grid, fields)
    where = "" if step is None else f" at step {step}"
    names = {n: ids[:8].tolist() for n, ids in details.items()}
    raise NumericsError(
        f"non-finite values{where} in {names or 'ghost/pad rows only'}",
        details=details)


def watchdog_interval(default: int = 0) -> int:
    """The DCCRG_WATCHDOG env knob: check every ~N steps (0 = off)."""
    try:
        return int(os.environ.get("DCCRG_WATCHDOG", "") or default)
    except ValueError:
        return default


# ---------------------------------------------------------------------
# OOM-aware step dispatch: the fallback chain
# ---------------------------------------------------------------------

_GATHER_ENV = ("DCCRG_FORCE_TABLES",)
FALLBACK_CHAIN = ("current", "roll", "tables")


def _is_resource_exhausted(e: BaseException) -> bool:
    """A device OOM: the caching allocator's ``torch.OutOfMemoryError``,
    an injected :class:`~dccrg_tpu_torch.faults.SimulatedResourceExhausted`,
    or an error carrying the reference's ``RESOURCE_EXHAUSTED`` marker."""
    return (isinstance(e, (torch.OutOfMemoryError,
                           faults.SimulatedResourceExhausted))
            or "RESOURCE_EXHAUSTED" in str(e))


# the env each forced mode pins (None = unset). The port reads
# DCCRG_FORCE_TABLES at plan build (uniform.py) and nothing of the
# reference's DCCRG_ROLL_STENCIL or DCCRG_BULK: both fallback modes
# leave the bulk executor (kernel A) through run_steps(bulk=False),
# "roll" on the plan the grid has, "tables" on a dense-table plan.
_MODE_ENV = {
    "roll": {"DCCRG_FORCE_TABLES": None},
    "tables": {"DCCRG_FORCE_TABLES": "1"},
}


def _plan_mode(mode: str):
    """The ``Grid._plan_gather_mode`` a mode's plan is built under."""
    return "tables" if mode == "tables" else None


def _apply_mode(grid, mode: str) -> None:
    """Pin the env for ``mode`` and rebuild the plan only when it was
    built under another ``DCCRG_FORCE_TABLES`` (``Grid._finish_plan``
    records it as ``_plan_gather_mode``). Cells and partitions (and the
    sticky capacity memo) are unchanged by the rebuild, so the row
    layout, and with it every field tensor, stays valid."""
    if mode == "current":
        return
    for v, val in _MODE_ENV[mode].items():
        if val is None:
            os.environ.pop(v, None)
        else:
            os.environ[v] = val
    if getattr(grid, "_plan_gather_mode", None) != _plan_mode(mode):
        grid._build_plan(grid.plan.cells, grid.plan.owner)


@contextmanager
def _restore_env():
    saved = {v: os.environ.get(v) for v in _GATHER_ENV}
    try:
        yield saved
    finally:
        for v, val in saved.items():
            if val is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = val


def guarded_step(grid, kernel, fields_in, fields_out, n_steps=1, *,
                 exchange_fields=None, neighborhood_id=None,
                 extra_args=()) -> str:
    """Dispatch ``Grid.run_steps`` with graceful OOM degradation.

    On a device OOM (:func:`_is_resource_exhausted`, real or injected
    through ``faults.resource_exhausted``) the dispatch walks the
    fallback chain *current -> roll -> tables*, logging each downgrade,
    and returns the mode that completed. ``current`` is ``run_steps``
    as the caller would call it (kernel A on an eligible grid on the
    card); ``roll`` runs ``bulk=False`` on the grid's plan, ``tables``
    ``bulk=False`` on a plan rebuilt under ``DCCRG_FORCE_TABLES=1``. A
    fallback that repeats the configuration that just failed is
    skipped: ``tables`` on a plan already built under
    ``DCCRG_FORCE_TABLES=1``, where ``current`` takes the same table
    path (the bulk executor declines a table plan). A successful
    downgrade is remembered on the grid: later guarded dispatches start
    from the working mode, and a ``tables`` plan stays for plain
    ``run_steps`` too until a structural rebuild. When every mode runs
    out of memory, the plan the call found is put back and
    :class:`ResilienceExhaustedError` surfaces with the last error
    chained. The caller's env is restored either way.

    A failed mode's exception is kept without its traceback: the
    traceback's frames hold the failed step's tensors, which must be
    freed before the next mode allocates its own."""
    from .grid import DEFAULT_NEIGHBORHOOD_ID

    hood = (DEFAULT_NEIGHBORHOOD_ID if neighborhood_id is None
            else neighborhood_id)
    entry = getattr(grid, "_plan_gather_mode", None)
    failed = []
    with _restore_env():
        sticky = getattr(grid, "_sticky_gather_mode", None)
        if sticky is not None:
            chain = [m for m in FALLBACK_CHAIN[1:]
                     if FALLBACK_CHAIN.index(m) >= FALLBACK_CHAIN.index(sticky)]
        else:
            chain = ["current", "roll"] + (
                [] if entry == _plan_mode("tables") else ["tables"])
        for mode in chain:
            try:
                _apply_mode(grid, mode)
                faults.fire("step.dispatch", mode=mode)
                grid.run_steps(kernel, fields_in, fields_out, n_steps,
                               exchange_fields=exchange_fields,
                               neighborhood_id=hood, extra_args=extra_args,
                               bulk=mode == "current")
                if mode != "current":
                    grid._sticky_gather_mode = mode
                if failed:
                    logger.warning(
                        "step completed in fallback mode %r (exhausted: "
                        "%s); the downgrade sticks for later guarded "
                        "dispatches", mode, [m for m, _ in failed])
                return mode
            except Exception as e:  # noqa: BLE001 - filtered just below
                if not _is_resource_exhausted(e):
                    raise
                logger.warning(
                    "device out of memory dispatching step in mode %r; "
                    "falling back (%s)", mode, e)
                e.__traceback__ = None
                failed.append((mode, e))
        # every mode failed: the grid goes back to the plan it came in
        # with, so a plain run_steps takes the caller's path again
        try:
            _apply_mode(grid, "tables" if entry == "tables" else "roll")
        except Exception as e:  # noqa: BLE001 - filtered just below
            if not _is_resource_exhausted(e):
                raise
            logger.warning("device out of memory putting back the "
                           "grid's plan (%s)", e)
            e.__traceback__ = None
    raise ResilienceExhaustedError(
        f"every mode in {[m for m, _ in failed]} exhausted device "
        "memory") from failed[-1][1]


# ---------------------------------------------------------------------
# the resilient step loop: watchdog + checkpoint + rollback
# ---------------------------------------------------------------------

# trip codes the per-step consensus reduces (max wins), by priority:
# _TRIP_INTERRUPT is a step-boundary interrupt (a preemption signal
# observed by dccrg_tpu_torch.supervise) any real trip outranks;
# _TRIP_ROLLBACK.._TRIP_OOM are recoverable (every rank rolls back
# together; _TRIP_CORRUPT is the integrity layer's verdict); >=
# _TRIP_FATAL means a rank hit a non-recoverable error and every other
# rank raises in sync
_TRIP_INTERRUPT = 1
_TRIP_ROLLBACK = 2   # MutationAbortedError
_TRIP_NUMERICS = 3
_TRIP_CORRUPT = 4    # integrity invariant (SDC) verdict
_TRIP_OOM = 5
_TRIP_FATAL = 6


class ResilientRunner:
    """Run a step loop that survives numerical blow-ups.

    ``step_fn(grid, step_index)`` advances the simulation by one step
    (typically a ``run_steps`` or :func:`guarded_step` call). Every
    ``checkpoint_every`` steps the state is checkpointed atomically
    (CRC sidecar included); every ``check_every`` steps the watchdog
    probes for non-finite values. On a trip the runner

    1. dumps a diagnostic bundle (step, offending fields, cell ids)
       into ``diagnostics_dir``,
    2. rolls the grid back to the last *verified* checkpoint,
    3. backs off exponentially and resumes.

    ``max_retries`` consecutive trips without passing the previous trip
    point raise :class:`ResilienceExhaustedError`. The checkpoint holds
    exact field bytes and the steps are deterministic, so a recovered
    run reconverges to the bitwise state of an undisturbed one.

    ``conserved_fields`` (opt-in) names fields whose global sum the step
    conserves: at every watchdog boundary their sums are compared with
    the values at the last checkpoint, and a drift past
    ``integrity.sum_tolerance`` trips a rollback (silent corruption the
    finite check cannot see). ``interrupt_poll`` is the supervision
    layer's step-boundary hook: truthy stops the loop with
    :class:`RunInterrupted`. ``checkpoint_seconds`` adds a wall-clock
    cadence (monotonic clock, step boundaries only)."""

    def __init__(self, grid, step_fn, checkpoint_path, *, fields=None,
                 check_every=None, checkpoint_every=10,
                 checkpoint_seconds=0.0, max_retries=3,
                 backoff=0.05, header=b"", variable=None,
                 diagnostics_dir=None, interrupt_poll=None,
                 conserved_fields=None):
        self.grid = grid
        self.step_fn = step_fn
        self.conserved_fields = tuple(conserved_fields or ())
        self._integrity_base = None  # sums at the rollback target
        self.interrupt_poll = interrupt_poll
        self.checkpoint_path = checkpoint_path
        self.fields = fields
        self.check_every = (check_every if check_every is not None
                            else (watchdog_interval(0) or 1))
        self.checkpoint_every = checkpoint_every
        self.checkpoint_seconds = float(checkpoint_seconds or 0.0)
        self._last_save_t = None
        self.max_retries = max_retries
        self.backoff = backoff
        self.header = header
        self.variable = variable
        self.diagnostics_dir = (diagnostics_dir
                                or os.path.dirname(os.path.abspath(
                                    checkpoint_path)))
        self.step = 0
        self.trips = []  # diagnostic bundles, newest last
        self.rollbacks = 0
        self.checkpoints = 0
        self._ckpt_step = None
        self._retry_streak = 0
        self._streak_step = -1

    # -- checkpoint plumbing ------------------------------------------

    def _write_checkpoint(self) -> str:
        """Write the periodic checkpoint; returns the path written. The
        supervision layer's store-backed runner overrides this to route
        through :meth:`dccrg_tpu_torch.supervise.CheckpointStore.save`.

        With ``DCCRG_ASYNC_SAVE=1`` the write runs on a writer thread
        against a :func:`dccrg_tpu_torch.background.freeze_grid`
        snapshot, overlapped with the following steps: the same bytes,
        published atomically; :meth:`_drain_saves` is the barrier every
        reader of the file (rollback, run end) takes first."""
        if background.async_save_enabled():
            saver = self._active_saver(create=True)
            saver.drain()  # one in flight; an earlier failure raises here
            frozen = background.freeze_grid(self.grid)
            path = self.checkpoint_path
            saver.submit(
                lambda: save_checkpoint(frozen, path, header=self.header,
                                        variable=self.variable),
                label=path)
            return path
        save_checkpoint(self.grid, self.checkpoint_path,
                        header=self.header, variable=self.variable)
        return self.checkpoint_path

    def _active_saver(self, create: bool = False):
        """The :class:`~dccrg_tpu_torch.background.AsyncSaver` carrying
        this runner's in-flight write, or None (the store-backed runner
        returns its store's saver)."""
        if create and getattr(self, "_saver", None) is None:
            self._saver = background.AsyncSaver()
        return getattr(self, "_saver", None)

    def _drain_saves(self, swallow: bool = False) -> None:
        """Block until no periodic write is in flight. ``swallow=True``
        (rollback and emergency paths) logs a writer failure instead of
        raising: its ``on_fail`` hooks already re-pointed the rollback
        target at the last durable save."""
        saver = self._active_saver()
        if saver is None:
            return
        try:
            saver.drain()
        except Exception as e:  # noqa: BLE001 - policy filter below
            if not swallow:
                raise
            logger.error("async checkpoint write failed (%s); the last "
                         "durable checkpoint is the rollback target", e)

    def _save(self) -> None:
        prev = (self.checkpoint_path, self._ckpt_step, self._last_save_t,
                self._integrity_base)
        self.checkpoint_path = self._write_checkpoint()
        self._ckpt_step = self.step
        self._last_save_t = time.monotonic()
        self.checkpoints += 1
        if self._integrity_on():
            # the conservation baseline, recorded at the rollback target
            self._integrity_base = self._conservation_sums()
        saver = self._active_saver()
        if saver is not None and saver.pending():
            # the bookkeeping above is speculative while the write is in
            # flight: a writer failure reverts the rollback target to
            # the last DURABLE checkpoint at the drain barrier
            def _restore(_err, prev=prev):
                (self.checkpoint_path, self._ckpt_step,
                 self._last_save_t, self._integrity_base) = prev
                self.checkpoints -= 1

            saver.add_on_fail(_restore)

    def _integrity_on(self) -> bool:
        from . import integrity

        return bool(self.conserved_fields) and integrity.integrity_enabled()

    def _conservation_sums(self):
        from . import integrity

        return integrity.conservation_sums(self.grid,
                                           self.conserved_fields)

    def _integrity_drift(self):
        """None when clean, else a details dict naming each conserved
        field whose global sum drifted beyond tolerance since the last
        checkpoint."""
        from . import integrity

        if not self._integrity_on() or self._integrity_base is None:
            return None
        telemetry.inc("dccrg_integrity_checks_total", where="runner")
        with telemetry.span("integrity.check"):
            now = self._conservation_sums()
        steps = max(1, self.step - (self._ckpt_step or 0))
        details = {}
        for i, name in enumerate(self.conserved_fields):
            shape, _dt = self.grid.fields[name]
            n_el = len(self.grid.plan.cells) * int(
                np.prod(shape, dtype=int) or 1)
            tol = integrity.sum_tolerance(self._integrity_base[i],
                                          n_el, steps)
            drift = abs(float(now[i]) - float(self._integrity_base[i]))
            if drift > tol:
                details[name] = np.empty(0, np.uint64)
                logger.warning(
                    "integrity drift in %r: conservation sum moved "
                    "%g (tolerance %g) since the step-%s checkpoint "
                    "— silent corruption", name, drift, tol,
                    self._ckpt_step)
        return details or None

    def _rollback(self) -> None:
        # chain-aware when the target is a delta (a broken chain
        # surfaces as DeltaChainError)
        t0 = time.perf_counter()
        self._drain_saves(swallow=True)
        with telemetry.span("runner.rollback"):
            load_checkpoint_into(self.grid, self.checkpoint_path,
                                 header_size=len(self.header),
                                 variable=self.variable)
        self.step = self._ckpt_step
        self.rollbacks += 1
        telemetry.inc("dccrg_rollbacks_total")
        telemetry.observe("dccrg_rollback_seconds",
                          time.perf_counter() - t0)

    # -- trip handling ------------------------------------------------

    def _dump_diagnostics(self, details) -> dict:
        bundle = {
            "step": self.step,
            "rollback_to": self._ckpt_step,
            "retry": self._retry_streak,
            "fields": {n: ids[:64].tolist() for n, ids in details.items()},
            "checkpoint": self.checkpoint_path,
            "wall_time": time.time(),
        }
        path = os.path.join(
            self.diagnostics_dir,
            f"dccrg_diag_step{self.step}_try{self._retry_streak}.json")
        try:
            with open(path, "w") as f:
                json.dump(bundle, f, indent=1)
            bundle["path"] = path
        except OSError as e:  # diagnostics must never kill recovery
            logger.warning("could not write diagnostic bundle: %s", e)
        self.trips.append(bundle)
        return bundle

    def _trip(self, details=None, kind="numerics") -> None:
        from . import verify

        if details is None:
            details = verify.find_nonfinite_cells(self.grid, self.fields)
        if self.step > self._streak_step:
            self._retry_streak = 0  # progress since the last trip
        self._streak_step = self.step
        self._retry_streak += 1
        telemetry.inc("dccrg_trips_total", kind=kind)
        bundle = self._dump_diagnostics(details)
        logger.warning(
            "watchdog trip (%s) at step %d (fields %s); rolling back "
            "to step %s (retry %d/%d)", kind, self.step,
            list(details) or "<ghost rows>", self._ckpt_step,
            self._retry_streak, self.max_retries)
        if self._retry_streak > self.max_retries:
            msg = (f"watchdog tripped {self._retry_streak} times at "
                   f"step {self.step} without progress; diagnostics: "
                   f"{bundle.get('path', '<unwritten>')}")
            if kind == "corrupt":
                from . import integrity

                raise integrity.IntegrityError(
                    "integrity invariants failed on every retry — "
                    "persistent silent corruption; " + msg,
                    details={n: "invariant drift" for n in details})
            raise ResilienceExhaustedError(msg)
        if self.backoff:
            time.sleep(self.backoff * (2 ** (self._retry_streak - 1)))
        self._rollback()

    # -- the loop -----------------------------------------------------

    def run(self, n_steps: int) -> "ResilientRunner":
        """Advance to ``n_steps`` total steps, recovering as needed.
        Returns self (``.step``, ``.trips``, ``.rollbacks``,
        ``.checkpoints`` carry the story).

        Every trip decision goes through
        :func:`dccrg_tpu_torch.coord.trip_consensus` (a MAX reduction of
        a per-rank trip code) before it is acted on, so in a process
        group every rank rolls back to the same checkpoint together."""
        from . import coord
        from .txn import MutationAbortedError

        if self._ckpt_step is None:
            self._save()  # a rollback target always exists
        membership = coord.get_membership()
        while self.step < n_steps:
            if membership is not None:
                # renew this rank's heartbeat lease at step boundaries
                # (throttled to the heartbeat cadence)
                membership.heartbeat()
            code, details = 0, None
            try:
                self.step_fn(self.grid, self.step)
            except MutationAbortedError as e:
                # a structural mutation inside the step failed and rolled
                # itself back: recover like a watchdog trip
                logger.warning("step %d: %s", self.step, e)
                code, details = _TRIP_ROLLBACK, {"mutation": np.asarray(
                    e.cells, dtype=np.uint64)}
            except NumericsError as e:
                # the DCCRG_WATCHDOG hook inside run_steps tripped
                logger.warning("step %d: %s", self.step, e)
                code, details = _TRIP_NUMERICS, (e.details if e.details
                                                 else None)
            except Exception as e:  # noqa: BLE001 - filtered just below
                if not _is_resource_exhausted(e):
                    # non-recoverable: tell the peers before dying (they
                    # wait in this step's consensus), deadline-bounded
                    coord.broadcast_fatal(self.grid, _TRIP_FATAL)
                    raise
                # a device OOM that escaped the step: recover like a
                # trip (the rollback frees the live tensors)
                logger.warning("step %d: %s", self.step, e)
                e.__traceback__ = None
                code, details = _TRIP_OOM, {"resource_exhausted":
                                            np.empty(0, np.uint64)}
            if (code == 0 and self.interrupt_poll is not None
                    and self.interrupt_poll()):
                # the step completed cleanly but an interrupt is pending
                # on this rank: the LOWEST-priority code, so a real trip
                # elsewhere still wins (the flag stays set)
                code = _TRIP_INTERRUPT
            agreed = coord.trip_consensus(self.grid, code)
            if agreed >= _TRIP_FATAL:
                raise ResilienceExhaustedError(
                    f"a peer rank failed fatally at step {self.step} "
                    "(non-recoverable exception on another rank; see "
                    "its log) — stopping in sync instead of hanging "
                    "in its abandoned collectives")
            if agreed >= _TRIP_ROLLBACK:
                if code in (0, _TRIP_INTERRUPT):
                    # another rank tripped; this one rolls back with it
                    details = {"remote_rank_trip": np.empty(0, np.uint64)}
                self._trip(details=details)
                continue
            if agreed == _TRIP_INTERRUPT:
                # every rank completed this step cleanly and agreed to
                # stop: the grid holds step+1 completed steps
                self.step += 1
                if not check_finite(self.grid, self.fields):
                    # never hand poisoned state to the emergency save:
                    # recover first; the pending interrupt stops the run
                    # at the first clean boundary after the rollback
                    self._trip()
                    continue
                raise RunInterrupted(self.step)
            self.step += 1
            faults.poison_step(self.grid, self.step)
            faults.flip_step(self.grid, self.step)
            ckpt_due = (bool(self.checkpoint_every)
                        and self.step % self.checkpoint_every == 0)
            if not ckpt_due and self.checkpoint_seconds > 0:
                due = (self._last_save_t is not None
                       and time.monotonic() - self._last_save_t
                       >= self.checkpoint_seconds)
                # clocks drift across ranks: any rank due -> all save
                ckpt_due = bool(coord.trip_consensus(self.grid, int(due)))
            # a checkpoint step ALWAYS checks first: the rollback target
            # never captures unverified state
            if (ckpt_due or self.step % self.check_every == 0
                    or self.step == n_steps):
                if not check_finite(self.grid, self.fields):
                    self._trip()
                    continue
                drift = self._integrity_drift()
                if self._integrity_on() and int(coord.trip_consensus(
                        self.grid,
                        _TRIP_CORRUPT if drift else 0)) >= _TRIP_CORRUPT:
                    self._trip(details=drift or {
                        "remote_rank_corrupt": np.empty(0, np.uint64)},
                        kind="corrupt")
                    continue
            if ckpt_due:
                self._save()
        # a write still in flight at the end must be durable before the
        # caller reads the files; a failure surfaces here
        self._drain_saves()
        return self


# ---------------------------------------------------------------------
# device probing that cannot hang
# ---------------------------------------------------------------------

def safe_devices(timeout: float = 90.0, retries: int = 2,
                 backoff: float = 2.0, platform=None):
    """The usable devices, found without risking a hang: a SUBPROCESS
    (killed on timeout) counts the cards with
    ``torch.cuda.device_count()`` first, with bounded retries and
    exponential backoff; only a probe that found a card lets this
    process return ``[torch.device("cuda", i), ...]``. ``platform="cpu"``
    probes only the interpreter and returns ``[torch.device("cpu")]``.
    Raises :class:`DeviceProbeError` when the budget is spent; a failed
    probe never falls back to the CPU."""
    cpu = platform == "cpu"
    if platform not in (None, "cpu", "cuda", "gpu"):
        raise ValueError(f"unknown platform {platform!r}")
    code = ("import torch; print(1)" if cpu else
            "import torch, sys; n = torch.cuda.device_count(); print(n); "
            "sys.exit(0 if n > 0 else 3)")
    last = "no probe attempted"
    for attempt in range(retries + 1):
        try:
            faults.fire("device.probe", attempt=attempt)
            out = subprocess.run(
                [sys.executable, "-c", code], timeout=timeout,
                capture_output=True, text=True)
            if out.returncode == 0:
                if cpu:
                    return [torch.device("cpu")]
                n = torch.cuda.device_count()
                if n > 0:
                    return [torch.device("cuda", i) for i in range(n)]
                last = "the probe saw a card this process does not"
            elif out.returncode == 3:
                last = "no CUDA device is available"
            else:
                last = (out.stderr or out.stdout).strip()[-200:]
        except (subprocess.TimeoutExpired, faults.InjectedProbeHang) as e:
            last = f"probe timed out after {timeout}s ({type(e).__name__})"
        if attempt < retries:
            delay = backoff * (2 ** attempt)
            logger.warning("device probe failed (%s); retry %d/%d in %.1fs",
                           last, attempt + 1, retries, delay)
            time.sleep(delay)
    raise DeviceProbeError(
        f"device backend unreachable after {retries + 1} probe(s): {last}")


_PROBED_DEVICES: dict = {}


def probed_devices(timeout: float = 120.0, retries: int = 1,
                   backoff: float = 2.0, platform=None) -> list:
    """Memoized :func:`safe_devices`: ONE subprocess probe per process
    and requested platform (the first caller's budget wins)."""
    if platform not in _PROBED_DEVICES:
        _PROBED_DEVICES[platform] = list(safe_devices(
            timeout=timeout, retries=retries, backoff=backoff,
            platform=platform))
    return _PROBED_DEVICES[platform]


def _tool_main(argv) -> int:
    """Checkpoint maintenance subcommands, callable without a card:
    ``verify <file>`` re-checksums one checkpoint against its sidecar
    (a delta verifies its whole chain); ``chain <dir>`` prints every
    keyframe->delta chain with per-link status; ``audit <file>``
    compares the payload fingerprint with the sidecar's record; ``gc
    <dir> --keep-last K --keep-every N`` applies the retention policy
    (a DRY RUN unless ``--apply``; it never deletes the only checkpoint
    that passes verification)."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m dccrg_tpu_torch.resilience",
                                 description=_tool_main.__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("verify", help="verify a checkpoint's CRC "
                                      "sidecar (a delta checkpoint "
                                      "verifies its WHOLE chain)")
    v.add_argument("file")
    c = sub.add_parser("chain", help="print every keyframe->delta "
                                     "chain in a checkpoint directory "
                                     "with per-link verification "
                                     "status")
    c.add_argument("dir")
    c.add_argument("--stem", default=None,
                   help="only checkpoints named <stem>_<step>.dc[d]")
    a = sub.add_parser("audit", help="at-rest audit: recompute a "
                                     "checkpoint's payload fingerprint "
                                     "and compare it with the record "
                                     "its sidecar captured from the "
                                     "live grid at save time")
    a.add_argument("file")
    g = sub.add_parser("gc", help="prune a checkpoint directory by the "
                                  "keep-last-K / keep-every-N retention "
                                  "policy, whole chains only (dry run "
                                  "unless --apply)")
    g.add_argument("dir")
    g.add_argument("--keep-last", type=int, default=3)
    g.add_argument("--keep-every", type=int, default=0)
    g.add_argument("--stem", default=None,
                   help="only checkpoints named <stem>_<step>.dc[d]")
    g.add_argument("--apply", action="store_true",
                   help="actually delete (default: report only)")
    args = ap.parse_args(argv)

    if args.cmd == "audit":
        # CRC pass first: a file that fails its chunk CRCs is plain
        # detectable corruption, not the silent class
        try:
            bad = verify_checkpoint(args.file)
        except CheckpointCorruptionError as e:
            print(f"CORRUPT {args.file}: {e}")
            return 1
        if bad:
            print(f"CORRUPT {args.file}: chunk CRC mismatch "
                  f"(chunks {bad}) — detectable corruption, not SDC")
            return 1
        try:
            rep = audit_checkpoint(args.file)
        except CheckpointCorruptionError as e:
            print(f"CORRUPT {args.file}: {e}")
            return 1
        if rep is None:
            print(f"NO-RECORD {args.file}: sidecar carries no "
                  "integrity fingerprint (pre-SDC save or "
                  "DCCRG_INTEGRITY=0)")
            return 2
        rc = 0
        for name in sorted(rep):
            ok, got, want = rep[name]
            if ok:
                print(f"OK {args.file}: field {name} fingerprint "
                      f"({got[0]:#010x}, {got[1]:#010x})")
            else:
                rc = 1
                print(f"SDC {args.file}: field {name} payload "
                      f"fingerprint ({got[0]:#010x}, {got[1]:#010x}) "
                      f"!= device-state record ({want[0]:#010x}, "
                      f"{want[1]:#010x}) — the CRCs sealed corrupted "
                      "bytes")
        return rc

    if args.cmd == "verify":
        if is_delta_checkpoint(args.file):
            try:
                links = verify_chain(args.file)
            except CheckpointCorruptionError as e:
                print(f"CORRUPT {args.file}: {e}")
                return 1
            print(f"OK {args.file} (chain of {len(links)}: "
                  + " -> ".join(os.path.basename(p) for p in links) + ")")
            return 0
        try:
            bad = verify_checkpoint(args.file)
        except CheckpointCorruptionError as e:
            print(f"CORRUPT {args.file}: {e}")
            return 1
        if bad:
            rec = read_sidecar(args.file)
            ranges = _rec_ranges(rec)
            names = ", ".join(_chunk_name(i, ranges) for i in bad)
            print(f"CORRUPT {args.file}: checksum mismatch in {names}")
            return 1
        print(f"OK {args.file}")
        return 0

    from . import supervise  # lazy: resilience imports standalone

    if args.cmd == "chain":
        chains = supervise.chain_report(args.dir, stem=args.stem)
        bad = 0
        for stem_name, links in chains:
            head = links[-1][0]
            print(f"chain {stem_name} @ step {head} "
                  f"({len(links)} link(s)):")
            for step, path, kind, status in links:
                if status != "OK":
                    bad += 1
                print(f"  {kind:<8} step {step:>8}  {status:<12} "
                      f"{os.path.basename(path)}")
        if not chains:
            print(f"no numbered checkpoints in {args.dir}")
        return 1 if bad else 0

    rep = supervise.gc_checkpoints(
        args.dir, keep_last=args.keep_last, keep_every=args.keep_every,
        stem=args.stem, apply=args.apply)
    verb = "pruned" if args.apply else "would prune"
    for step, path in rep.dropped:
        print(f"{verb} step {step}: {path}")
    for path in rep.stale_temps:
        print(f"{verb} stale temp file: {path}")
    if rep.rescued is not None:
        print(f"kept step {rep.rescued} beyond policy: it is the only "
              "checkpoint that passes verification")
    if rep.refused:
        print(f"REFUSED: {rep.refused}")
    print(f"{'applied' if rep.applied else 'dry-run'}: "
          f"{len(rep.kept)} kept, {len(rep.dropped)} "
          f"{'pruned' if rep.applied else 'prunable'}, "
          f"{len(rep.stale_temps)} stale temp file(s)"
          + ("" if args.apply else " — pass --apply to prune"))
    return 0


def _main(argv=None) -> int:
    """CLI probe for shell scripts: ``python -m
    dccrg_tpu_torch.resilience [--timeout S] [--retries N] [--platform
    P]`` exits 0 and prints the devices when the backend answers, 1
    otherwise, and never hangs. ``verify <file>``, ``audit <file>``,
    ``chain <dir>`` and ``gc <dir> [--keep-last K] [--keep-every N]
    [--apply]`` maintain checkpoints without touching a card (see
    :func:`_tool_main`)."""
    import argparse

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("verify", "gc", "chain", "audit"):
        return _tool_main(argv)
    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("--timeout", type=float, default=90.0)
    ap.add_argument("--retries", type=int, default=0)
    ap.add_argument("--backoff", type=float, default=2.0)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args(argv)
    try:
        devs = safe_devices(timeout=args.timeout, retries=args.retries,
                            backoff=args.backoff, platform=args.platform)
        print("OK", devs)
        return 0
    except DeviceProbeError as e:
        print("DOWN", e)
        return 1


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(_main())
