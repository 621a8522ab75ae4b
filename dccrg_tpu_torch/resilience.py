"""Checkpoint integrity and the numerics watchdog of the port
(counterpart of ``dccrg_tpu/resilience.py``, its one-device checkpoint
half, the read side of delta chains and the watchdog).

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
checkpoint of the reference (a ``.dcd`` chained to a keyframe through
its sidecar) loads chain-aware: the chain is verified and materialized
into a scratch file first.

**Numerics watchdog**: :func:`check_finite` is one device reduction
over the watched fields and one host read; :func:`assert_finite`
turns a trip into a :class:`NumericsError` naming fields and cells.
``DCCRG_WATCHDOG=N`` makes ``Grid.run_steps`` check every ~N steps
(off by default).

The delta saves, the auto-rollback runner, the OOM fallback chain and
the device probes are the reference's supervision layer, not ported
yet.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import time
import zlib
from dataclasses import dataclass, field as dataclass_field

import numpy as np
import torch

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
                    backoff: float = 0.1,
                    chunk_bytes: int = CRC_CHUNK) -> str:
    """Atomic checkpoint save: the ``.dc`` bytes stream into a temp
    file in the target directory, fsync, then one rename — a crash at
    any point leaves either the old or the new checkpoint complete,
    never a torn file under the final name. Transient I/O errors retry
    with exponential backoff. With ``sidecar`` (default) the per-chunk
    CRC32 sidecar, with the live grid's payload fingerprint, is
    written after the rename."""
    telemetry.inc("dccrg_saves_total", kind="keyframe")
    t_save = time.perf_counter()
    phase = checkpoint_mod.phase
    tmp = filename + f".tmp.{os.getpid()}"
    side = sidecar_path(filename)
    rec = None
    for attempt in range(retries + 1):
        try:
            with phase("write"):
                checkpoint_mod.save_grid_data(grid, tmp, header=header,
                                              variable=variable)
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
                with phase("integrity"):
                    integ = _integrity_record(grid, variable)
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
                      time.perf_counter() - t_save, kind="keyframe")
    return filename


def _integrity_record(grid, variable) -> dict:
    """The sidecar ``integrity`` record: the payload fingerprint
    ``{field: [s1, s2, nbytes]}`` of the grid's LIVE device state
    (:func:`dccrg_tpu_torch.integrity.grid_fingerprint`), which
    :func:`audit_checkpoint` later re-derives from the file's payload
    columns alone. Ragged (variable) fields are excluded. Empty when
    ``DCCRG_INTEGRITY=0``."""
    from . import integrity

    if not integrity.integrity_enabled():
        return {}
    var = variable or {}
    names = [n for n in sorted(grid.fields) if n not in var]
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


def find_nonfinite_cells(grid, fields=None) -> dict:
    """``{field: cell ids}`` for every watched inexact field holding a
    NaN/Inf in a local row (host-side and O(grid): run it only after
    :func:`check_finite` tripped). The reference's
    ``verify.find_nonfinite_cells``."""
    out = {}
    cells = grid.get_cells()
    for name in _inexact_fields(grid, fields):
        vals = np.asarray(grid.get(name, cells))
        bad = ~np.isfinite(vals)
        while bad.ndim > 1:
            bad = bad.any(axis=-1)
        if bad.any():
            out[name] = np.asarray(cells)[bad]
    return out


def assert_finite(grid, fields=None, step=None) -> None:
    """Raise :class:`NumericsError` (naming fields and cell ids) when
    the watchdog probe trips."""
    if check_finite(grid, fields):
        return
    details = find_nonfinite_cells(grid, fields)
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
