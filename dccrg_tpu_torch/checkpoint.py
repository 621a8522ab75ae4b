"""Checkpoint / restart of the port, one device (counterpart of
``dccrg_tpu/checkpoint.py``).

Byte-compatible with the reference's ``.dc`` format (dccrg.hpp:1109-2426;
pinned by ``tests/data/golden.dc``):

    [user header bytes]
    uint64 endianness magic 0x1234567890abcdef        (:1243)
    mapping record: 3 x uint64 level-0 lengths + int32 max_ref_lvl
    uint32 neighborhood length
    topology record: 3 x uint8 periodicity
    geometry record: int32 geometry id + parameters
    uint64 total cell count
    (uint64 cell id, uint64 data byte offset) pairs
    per-cell payloads

The per-cell payload is the grid's fields in sorted-name order. A save
streams the payload in chunks of :data:`CHUNK` cells: each chunk is
gathered on the device (one ``index_select`` per field, the fields'
bytes concatenated there) and crosses to the host in one copy, on a
worker thread, while the previous chunk is written. A load parses the
metadata from a memory map, rebuilds the grid from it alone
(:func:`load_grid`) and scatters each chunk's payload into host arrays
that are uploaded once per field.

bfloat16 columns are carried as their 2-byte words (numpy has no
bfloat16 without ``ml_dtypes``) and reinterpreted in torch, so their
file bytes equal the reference's.

**Variable-size payloads** (two-pass, dccrg.hpp:2108-2123):
``variable={"pos": "count"}`` stores only the first ``count`` rows of
each cell's ``pos`` buffer; a load reads the fixed parts (the counts
among them) first and the ragged rows second.

A partitioned grid saves and loads in one process: every partition's
rows are this process's, so the payload is gathered and scattered by
flat row (``partition * R + row``) and the file's bytes do not depend on
the partition.

**Under a process split** (``Grid._proc_local_dev`` partial: a process
group, or a test faking the split) a save takes the reference's
TWO-PHASE COMMIT (:func:`_save_process_slice`): every rank streams its
own partitions' payload runs into ``<file>.mp-tmp`` with a CRC32 per
run, a timeout-guarded commit barrier collects the CRCs (through the
group's ``all_gather_object``, the :mod:`coord` key-value store for a
:func:`~dccrg_tpu_torch.background.freeze_grid_mp` snapshot, or the
in-process stage of a faked split), and the committing rank verifies
every slice before the atomic rename. The file's bytes equal a
one-process save's. A load scatters only this rank's cells, and a
real group then meets at the load-done barrier.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import time
import zlib
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

from . import faults
from .geometry import StretchedCartesianGeometry, geometry_from_buffer
from .mapping import Mapping
from .topology import GridTopology

ENDIAN_MAGIC = 0x1234567890ABCDEF
CHUNK = 1 << 19  # cells per streamed payload chunk

# A list here collects ``(phase, seconds)`` of every save and load
# (serialize+write, fsync, sidecar, integrity, verify, parse,
# initialize, load_cells, scatter, upload); None records nothing.
_PHASE_SINK = None


@contextmanager
def phase(label: str):
    """Time the enclosed block into :data:`_PHASE_SINK` when it is a
    list; otherwise a bare pass-through."""
    if _PHASE_SINK is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _PHASE_SINK.append((label, time.perf_counter() - t0))


def dtype_name(dtype: torch.dtype) -> str:
    """The dtype's name as numpy and JAX print it ('float32',
    'bfloat16'), so digests equal the reference's on equal bytes."""
    return str(dtype).removeprefix("torch.")


def storage_dtype(dtype) -> np.dtype:
    """The numpy dtype a field's bytes are carried in on the host: the
    field's own type, except bfloat16 (a torch dtype, the name, or the
    reference's ml_dtypes type), which travels as its int16 words."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return np.dtype(np.int16)
        return torch.empty(0, dtype=dtype).numpy().dtype
    if str(dtype) == "bfloat16" or getattr(dtype, "__name__", "") == "bfloat16":
        return np.dtype(np.int16)
    return np.dtype(dtype)


def tensor_bytes(t: torch.Tensor) -> bytes:
    """The raw bytes of ``t`` in row-major order. bfloat16 goes through
    its int16 view, which carries the same bytes without needing a
    numpy bfloat16 type."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return np.ascontiguousarray(t.numpy()).tobytes()


def digest_update(h, name: str, shape, dtype, owned: torch.Tensor) -> None:
    """Fold one field's header ``repr((name, shape, dtype name))`` and
    its owned rows' bytes into the hash ``h``."""
    h.update(repr((name, tuple(shape), dtype_name(dtype))).encode())
    h.update(tensor_bytes(owned))


def owned_rows(grid, name) -> torch.Tensor:
    """The owned rows of field ``name``: each held partition's rows
    ``[0, n_local[p])`` in partition order (ghost and pad rows left
    out), on the grid's device. On a grid whose partitions span ranks,
    this rank's share."""
    x = grid.data[name]
    parts = [x[i, :int(grid.plan.n_local[p])]
             for i, p in enumerate(grid._held)]
    if grid._grouped:
        # the partitions span devices: they meet on the host
        parts = [t.cpu() for t in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def state_digest(grid, fields=None) -> str:
    """Deterministic SHA-256 over the grid's OWNED cell bytes (each
    partition's rows ``[0, n_local[p])`` in partition order; ghost and
    pad rows excluded), field-name sorted with the name, shape and
    dtype folded in. Equal to the reference's digest of a grid holding
    the same bytes on the same partition."""
    h = hashlib.sha256()
    for name in sorted(fields if fields is not None else grid.fields):
        shape, dtype = grid.fields[name]
        digest_update(h, name, shape, dtype, owned_rows(grid, name))
    return h.hexdigest()


# ---------------------------------------------------------------------
# payload layout
# ---------------------------------------------------------------------

def cell_data_fields(cell_data) -> dict:
    """Normalize a user ``cell_data`` spec (or ``Grid.fields``) into
    ``{name: (shape tuple, numpy storage dtype)}`` (bfloat16 as its
    int16 words)."""
    out = {}
    for name, spec in cell_data.items():
        if isinstance(spec, tuple):
            shape, dtype = spec
        else:
            shape, dtype = (), spec
        out[name] = (tuple(shape), storage_dtype(dtype))
    return out


def _payload_spec_of(fields, variable=None):
    """Split a ``{name: (shape, dtype)}`` field spec into fixed and
    variable parts (dtypes as torch dtypes, names or numpy dtypes).

    Returns ``(fixed_spec, fixed_bytes, var_spec)`` where fixed_spec is
    [(name, shape, dtype, nbytes)] in sorted-name order, and var_spec
    is [(name, count_field, row_shape, dtype, row_bytes, capacity)]
    for fields declared variable (stored truncated to their per-cell
    count); each dtype is the field's :func:`storage_dtype`."""
    variable = variable or {}
    fixed, var = [], []
    total = 0
    for n in sorted(fields):
        shape, dtype = fields[n]
        dtype = storage_dtype(dtype)
        if n in variable:
            if not shape:
                raise ValueError(f"variable field {n!r} must have a row axis")
            row_shape = tuple(shape[1:])
            row_bytes = int(np.prod(row_shape, dtype=np.int64)) * dtype.itemsize if row_shape else dtype.itemsize
            var.append((n, variable[n], row_shape, dtype, row_bytes, int(shape[0])))
        else:
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize if shape else dtype.itemsize
            fixed.append((n, tuple(shape), dtype, nbytes))
            total += nbytes
    for n, cf, *_ in var:
        if cf not in fields or tuple(fields[cf][0]) != ():
            raise ValueError(f"count field {cf!r} of {n!r} must be a scalar field")
        if cf in variable:
            raise ValueError(f"count field {cf!r} cannot itself be variable")
    return fixed, total, var


def parse_metadata(data, header_size: int = 0):
    """Parse a .dc file's metadata block (the format above): returns
    (mapping, hood_len, topology, geometry, cells, offsets,
    payload_start). ``data`` is a bytes-like (a memory map works)."""
    mapping, hood_len, topology, geometry, n_cells, pos = \
        _parse_records(data, header_size)
    pairs = np.frombuffer(data, dtype=np.uint64, count=2 * n_cells, offset=pos).reshape(-1, 2)
    cells = pairs[:, 0].copy()
    offsets = pairs[:, 1].copy()
    return mapping, hood_len, topology, geometry, cells, offsets, pos + 16 * n_cells


def payload_start(data, header_size: int = 0) -> int:
    """Where a .dc file's payload begins: the end of its offset table,
    found without reading the table."""
    *_records, n_cells, pos = _parse_records(data, header_size)
    return pos + 16 * n_cells


def _parse_records(data, header_size):
    """The metadata records up to the cell count: (mapping, hood_len,
    topology, geometry, n_cells, offset of the (id, offset) pairs)."""
    pos = header_size
    (magic,) = struct.unpack_from("<Q", data, pos)
    pos += 8
    if magic != ENDIAN_MAGIC:
        raise ValueError(
            f"bad endianness magic {magic:#x}: file written on an "
            "incompatible architecture or wrong header_size"
        )
    mapping = Mapping.from_bytes(bytes(data[pos : pos + 28]))
    pos += 28
    (hood_len,) = struct.unpack_from("<I", data, pos)
    pos += 4
    topology = GridTopology.from_bytes(bytes(data[pos : pos + 3]))
    pos += 3
    # the geometry record is self-describing via its id — no length
    # prefix, exactly the reference's layout (dccrg.hpp:1312-1323)
    try:
        geometry, geom_len = geometry_from_buffer(data, pos, mapping, topology)
    except (ValueError, struct.error):
        # legacy files of the reference package carried a u32
        # record-length prefix here; its value (>= 4) can never be a
        # valid geometry id, so falling back on that signature is
        # unambiguous (struct.error: a record truncated mid-way)
        try:
            (legacy_len,) = struct.unpack_from("<I", data, pos)
            (legacy_gid,) = struct.unpack_from("<i", data, pos + 4)
        except struct.error:
            raise ValueError(
                "unrecognized geometry record (file truncated mid-record)"
            ) from None
        if legacy_gid == 2:
            # legacy stretched records carried no coordinate counts;
            # sizes come from the mapping's level-0 lengths
            coords, off = [], pos + 8
            for d in range(3):
                n = int(mapping.length.get()[d]) + 1
                coords.append(np.frombuffer(
                    data, dtype=np.float64, count=n, offset=off).copy())
                off += 8 * n
            geometry = StretchedCartesianGeometry(mapping, topology, coords)
            geom_len = off - pos - 4
        else:
            try:
                geometry, geom_len = geometry_from_buffer(
                    data, pos + 4, mapping, topology)
            except (ValueError, struct.error):
                raise ValueError(
                    "unrecognized geometry record (neither the reference "
                    ".dc layout nor the legacy length-prefixed form)"
                )
        if geom_len != legacy_len:
            raise ValueError(
                f"legacy geometry length prefix {legacy_len} does not "
                f"match the parsed record ({geom_len} bytes)"
            )
        geom_len += 4
    pos += geom_len
    (n_cells,) = struct.unpack_from("<Q", data, pos)
    return mapping, hood_len, topology, geometry, n_cells, pos + 8


def _dense_block(buf, offs, nbytes: int):
    """``buf`` bytes of cells at byte offsets ``offs`` as a
    ``uint8[n, nbytes]`` view when the cells are packed back to back
    (every fixed-size save), else None. Equal to the fancy-index
    gather ``buf[offs[:, None] + arange(nbytes)]`` when it applies."""
    n = len(offs)
    if n == 0 or nbytes == 0:
        return None
    lo = int(offs[0])
    if lo + n * nbytes > buf.size:
        return None  # past the end: the gather raises as it would
    if n > 1 and not np.all(np.diff(offs) == nbytes):
        return None
    return buf[lo : lo + n * nbytes].reshape(n, nbytes)


def payload_columns(raw, meta, fields, variable=None) -> dict:
    """Per-field fixed-column bytes of a parsed .dc buffer:
    ``{name: uint8[n_cells, nbytes]}`` gathered from each cell's
    offset-table position (the read-side mirror of the save's
    interleave), read by the offline integrity audit
    (:func:`dccrg_tpu_torch.integrity.file_fingerprint`). Ragged
    (variable) fields are skipped: a corrupted count would make the
    walk ambiguous."""
    fixed_spec, fixed_bytes, _var = _payload_spec_of(fields, variable)
    offs = meta[5].astype(np.int64)
    n = len(offs)
    out = {}
    col = 0
    buf = np.asarray(raw, dtype=np.uint8)
    block = _dense_block(buf, offs, fixed_bytes)
    for name, _shape, _dtype, nbytes in fixed_spec:
        if block is not None:
            out[name] = block[:, col : col + nbytes]
            col += nbytes
            continue
        span = np.arange(nbytes, dtype=np.int64)[None, :]
        idx = offs[:, None] + col + span
        if n and int(idx.max()) >= buf.size:
            raise ValueError(
                f"payload column {name!r} extends past the end of the "
                "buffer (truncated file?)")
        out[name] = buf[idx]
        col += nbytes
    return out


# ---------------------------------------------------------------------
# save
# ---------------------------------------------------------------------

def _gather_bytes(grid, names, sel) -> np.ndarray:
    """``uint8[n, bytes]`` of the rows ``sel`` (``Grid._row_sel``) of
    fields ``names``, interleaved per row in the given order: in each
    storage group one ``index_select`` per field on the group's device,
    the byte views concatenated there, one blocking copy to the host."""
    from .grid import _flat, groups_of

    n = sum(len(idx) for _items, idx in sel)
    width = sum(int(np.prod(grid.fields[name][0], dtype=np.int64))
                * torch.empty((), dtype=grid.fields[name][1]).element_size()
                for name in names)
    out = np.empty((n, width), dtype=np.uint8)
    for g, (items, idx) in enumerate(sel):
        if not len(idx) or not names:
            continue
        cols = [_flat(groups_of(grid.data[name])[g]).index_select(0, idx)
                .contiguous().view(torch.uint8).reshape(len(idx), -1)
                for name in names]
        got = (cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)) \
            .cpu().numpy()
        if items is None:
            return got
        out[items] = got
    return out


def _chunk_bytes(grid, counts, start, fixed_spec, fixed_bytes, var_spec):
    """Serialize the cells at positions ``[start, start + CHUNK)`` of
    the grid's sorted cell list (device gather + host assembly). Runs
    on the save's worker thread, so the next chunk's device pull
    overlaps the file write of the current one."""
    idx = np.arange(start, min(start + CHUNK, len(grid.plan.cells)))
    # the single-controller pull: every partition's rows are this
    # process's, so a chunk is one gather over the rows of each
    # storage group
    sel = grid._row_sel(grid.plan.owner[idx],
                        grid.plan.row_of_pos[idx].astype(np.int64))
    card = grid._card
    with (torch.cuda.device(card) if card is not None
          else nullcontext()):
        return _chunk_payload(grid, counts, idx, sel, fixed_spec,
                              fixed_bytes, var_spec)


def _chunk_payload(grid, counts, idx, sel, fixed_spec, fixed_bytes,
                   var_spec):
    fixed = _gather_bytes(grid, [s[0] for s in fixed_spec], sel)
    if not var_spec:
        return fixed
    var_host = {name: _gather_bytes(grid, [name], sel)
                for name, *_ in var_spec}
    var_nbytes = {
        name: counts[name][idx].astype(np.int64) * row_bytes
        for name, count_field, row_shape, dtype, row_bytes, cap in var_spec
    }
    return _interleave(len(idx), fixed, var_host, var_nbytes, fixed_bytes,
                       var_spec)


def _interleave(nc, fixed, var_host, var_nbytes, fixed_bytes, var_spec):
    """Interleave fixed parts and ragged variable rows per cell —
    vectorized (repeat/cumsum scatter), no per-cell Python loop."""
    cell_total = np.full(nc, fixed_bytes, dtype=np.int64)
    for nb in var_nbytes.values():
        cell_total += nb
    out = np.empty(int(cell_total.sum()), dtype=np.uint8)
    cell_off = np.cumsum(cell_total) - cell_total
    out[cell_off[:, None] + np.arange(fixed_bytes, dtype=np.int64)] = fixed
    field_off = cell_off + fixed_bytes
    for name, *_ in var_spec:
        nb = var_nbytes[name]
        tot = int(nb.sum())
        if tot:
            vb = var_host[name].reshape(nc, -1).view(np.uint8)
            pos = np.arange(tot, dtype=np.int64) - np.repeat(
                np.cumsum(nb) - nb, nb
            )
            src_row = np.repeat(np.arange(nc, dtype=np.int64), nb)
            out[np.repeat(field_off, nb) + pos] = vb[src_row, pos]
        field_off = field_off + nb
    return out


def save_grid_data(grid, filename: str, header: bytes = b"",
                   variable=None, *, sidecar: bool = False,
                   sidecar_chunk_bytes: int | None = None,
                   fields=None, sidecar_extra=None) -> None:
    """Write the grid and all cell data (dccrg.hpp:1109-1736), the
    payload streamed in chunks of :data:`CHUNK` cells with the device
    pull of chunk k+1 (on a worker thread) overlapping the file write
    of chunk k. ``variable={"field": "count_field"}`` stores that field
    truncated to each cell's count (dccrg.hpp:2108-2123). ``fields``
    restricts the save to a subset of the grid's fields (the delta
    checkpoint's path): the file is a valid ``.dc`` of the sub-schema,
    in the byte layout of a full save.

    Under a process split the save takes the two-phase commit
    (:func:`_save_process_slice`); ``sidecar=True`` then has the
    committing rank write the resilience CRC32 sidecar, extended with
    the per-rank slice table, and ``sidecar_extra`` is merged into it.
    Without a split the sidecar is ``resilience.save_checkpoint``'s job
    and these keywords are ignored."""
    from concurrent.futures import ThreadPoolExecutor

    cells = grid.plan.cells
    schema = grid.fields
    if fields is not None:
        schema = {n: grid.fields[n] for n in fields}
        variable = {n: cf for n, cf in (variable or {}).items()
                    if n in schema}
    fixed_spec, fixed_bytes, var_spec = _payload_spec_of(schema, variable)

    meta = bytearray()
    meta += header
    meta += struct.pack("<Q", ENDIAN_MAGIC)
    meta += grid.mapping.to_bytes()
    meta += struct.pack("<I", grid._hood_len)
    meta += grid.topology.to_bytes()
    meta += grid.geometry.to_bytes()  # self-describing, no length prefix
    meta += struct.pack("<Q", len(cells))

    offset0 = len(meta) + 16 * len(cells)
    counts = {}
    sizes = None
    if var_spec or grid._multiproc:
        # per-cell byte sizes: variable fields add count * row bytes.
        # Counts must be the same on every rank (the offset table is
        # replicated): _replicated_pull
        sizes = np.full(len(cells), fixed_bytes, dtype=np.uint64)
        for name, count_field, row_shape, dtype, row_bytes, cap in var_spec:
            c = _replicated_pull(grid, count_field, cells).astype(np.int64)
            if np.any(c < 0) or np.any(c > cap):
                raise ValueError(f"count field {count_field!r} out of range for {name!r}")
            counts[name] = c
            sizes += (c * row_bytes).astype(np.uint64)
        if var_spec:
            offsets = offset0 + np.concatenate(
                [[np.uint64(0)], np.cumsum(sizes)[:-1]]).astype(np.uint64)
        else:  # packed cells, the cumulative sum in closed form
            offsets = (np.arange(len(cells), dtype=np.uint64)
                       * np.uint64(fixed_bytes) + np.uint64(offset0))
    else:
        offsets = None  # packed: cell i's payload at offset0 + i * fixed_bytes

    if grid._multiproc:
        _save_process_slice(grid, filename, bytes(meta), cells, offsets,
                            sizes, counts, fixed_spec, fixed_bytes,
                            var_spec, header_size=len(header),
                            sidecar=sidecar,
                            sidecar_chunk_bytes=sidecar_chunk_bytes,
                            sidecar_extra=sidecar_extra)
        return

    starts = list(range(0, len(cells), CHUNK))
    with open(filename, "wb") as f, ThreadPoolExecutor(1) as pool:
        f.write(bytes(meta))
        for pairs in _pair_chunks(cells, offsets, offset0, fixed_bytes):
            f.write(pairs)
        fut = None
        for i, start in enumerate(starts):
            if fut is None:
                fut = pool.submit(_chunk_bytes, grid, counts, start,
                                  fixed_spec, fixed_bytes, var_spec)
            buf = fut.result()
            fut = (pool.submit(_chunk_bytes, grid, counts, starts[i + 1],
                               fixed_spec, fixed_bytes, var_spec)
                   if i + 1 < len(starts) else None)
            # fault-injection site: a mid-stream write failure leaves a
            # torn file — resilience.save_checkpoint's atomic rename
            # guarantees it never carries the final checkpoint name
            # (leaving the pool's block waits for the worker's pull)
            faults.fire("checkpoint.chunk", chunk=i, path=filename)
            f.write(buf)


def _pair_chunks(cells, offsets, offset0, fixed_bytes):
    """The ``(uint64 cell id, uint64 offset)`` table in chunks of
    :data:`CHUNK` rows (``offsets`` None: packed cells)."""
    for start in range(0, len(cells), CHUNK):
        end = min(start + CHUNK, len(cells))
        pairs = np.empty((end - start, 2), dtype=np.uint64)
        pairs[:, 0] = cells[start:end]
        if offsets is None:
            pairs[:, 1] = np.arange(start, end, dtype=np.uint64) \
                * np.uint64(fixed_bytes) + np.uint64(offset0)
        else:
            pairs[:, 1] = offsets[start:end]
        yield pairs


def _replicated_pull(grid, field, cells) -> np.ndarray:
    """Per-cell host values that are the same on every rank (the
    offset table of a save under a process split depends on them; the
    reference allgathers its cell lists, dccrg.hpp:1109-1736). Without
    a split this is ``grid.get``. In a process group each rank reads
    its own partitions' rows and ``all_gather_object`` merges them; a
    faked split holds every row in its one process and reads them
    directly.

    A :func:`~dccrg_tpu_torch.background.freeze_grid_mp` snapshot
    carries the pull precomputed (``_frozen_pulls``, taken on the
    caller's thread at freeze time): the writer thread launches
    nothing and takes part in no collective."""
    from . import coord
    from .grid import _host_numpy

    frozen = getattr(grid, "_frozen_pulls", None)
    if frozen is not None and field in frozen \
            and len(frozen[field]) == len(cells):
        return frozen[field]
    if not grid._multiproc:
        return np.asarray(grid.get(field, cells))
    dev, rows = grid._host_rows(cells)
    if coord.process_count() <= 1:
        return _host_numpy(grid._take(grid.data[field],
                                      grid._row_sel(dev, rows)).host())
    mine = np.flatnonzero(grid._proc_local_dev[dev])
    vals = _host_numpy(grid._shard_read(field, dev[mine], rows[mine]))
    parts = [None] * coord.process_count()
    torch.distributed.all_gather_object(parts, (mine, vals))
    shape, dtype = grid.fields[field]
    out = np.zeros((len(cells),) + tuple(shape), dtype=vals.dtype)
    for pos, v in parts:
        out[pos] = v
    return out


_TMP_MARKERS = (".tmp.", ".salvage.", ".chain.")
MP_TMP_SUFFIX = ".mp-tmp"


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(int(pid), 0)
    except (ProcessLookupError, OverflowError, ValueError):
        return False
    except PermissionError:  # exists, not ours
        return True
    return True


def stale_temp_files(dirpath: str) -> list:
    """Orphaned save/salvage temp files in ``dirpath``, left behind by
    a run that died mid-save: ``<f>.mp-tmp`` (an unfinished
    multi-process save of the reference), and ``<f>.tmp.<pid>`` /
    ``<f>.salvage.<pid>`` / ``<f>.chain.<pid>`` whose owning pid is no
    longer alive. Never matches a finished checkpoint or its sidecar.
    Only call between runs, or from the process that owns the saves."""
    out = []
    try:
        names = sorted(os.listdir(dirpath))
    except OSError:
        return out
    for name in names:
        path = os.path.join(dirpath, name)
        if not os.path.isfile(path):
            continue
        if name.endswith(MP_TMP_SUFFIX):
            out.append(path)
            continue
        for marker in _TMP_MARKERS:
            idx = name.rfind(marker)
            if idx < 0:
                continue
            pid = name[idx + len(marker):]
            if pid.isdigit() and not _pid_alive(int(pid)):
                out.append(path)
            break
    return out


# ---------------------------------------------------------------------
# the two-phase multi-process save
# ---------------------------------------------------------------------

# Faked-split CRC staging: {tmp_path: {dev: (rank, [crc per run])}}.
# A process group never touches this (its CRCs cross ranks at the
# commit barrier); the table bridges the SEQUENTIAL per-rank passes of a
# faked split in one process. The meta-writing pass resets the entry,
# so an aborted earlier attempt never leaks stale CRCs into a later
# save.
_MP_CRC_STAGE: dict = {}


def _device_runs(n_dev, owner, offsets, sizes):
    """Per-partition contiguous payload runs ``[(dev, positions, lo,
    hi)]`` in partition order (each partition's runs in position
    order), derived from the replicated plan alone, so every rank
    computes the same run table (the frame of reference of the commit's
    CRC exchange). One pass over ``owner`` finds the runs; the
    reference's table (dccrg_tpu/checkpoint.py:499-515) exactly."""
    n = len(owner)
    if n == 0:
        return []
    starts = np.concatenate(
        [[0], np.flatnonzero(owner[1:] != owner[:-1]) + 1])
    ends = np.append(starts[1:], n)
    runs = []
    for lo, hi in zip(starts.tolist(), ends.tolist()):
        runs.append((int(owner[lo]), np.arange(lo, hi, dtype=np.int64),
                     int(offsets[lo]), int(offsets[hi - 1] + sizes[hi - 1])))
    runs.sort(key=lambda r: (r[0], r[2]))
    return runs


def _crc_kv_key(base, rank):
    return f"dccrg_crc:{base}:{rank}"


def _kv_wait(kv, key, timeout_s: float = 10.0):
    """``kv.get(key)``, polled until the key appears or ``timeout_s``
    passes (None then)."""
    deadline = time.monotonic() + timeout_s
    while True:
        val = kv.get(key)
        if val is not None or time.monotonic() >= deadline:
            return val
        time.sleep(0.01)


def _post_run_crcs_kv(grid, runs, local_crcs, rank, base):
    """Writer-thread half of the key-value CRC exchange: post this
    rank's per-run CRC32s under the attempt-tagged key BEFORE the
    commit barrier, so every posted record is visible once it releases.
    Store traffic only, no collective: what lets an
    :class:`~dccrg_tpu_torch.background.AsyncSaver` thread run the
    whole two-phase save. The record is CRC-framed
    (:func:`~dccrg_tpu_torch.coord.seal_record`): a rank that dies
    mid-post reads as a torn record, which the committer treats as a
    dead rank."""
    from . import coord

    by_dev: dict = {}
    for gri, (d, _seg, _lo, _hi) in enumerate(runs):
        by_dev.setdefault(d, []).append(gri)
    payload = {str(d): [int(local_crcs[g]) & 0xFFFFFFFF for g in gris]
               for d, gris in by_dev.items() if grid._proc_local_dev[d]}
    rec = coord.seal_record(
        json.dumps({"rank": int(rank), "devs": payload}, sort_keys=True))
    coord.default_kv().set(_crc_kv_key(base, rank), rec)


def _read_run_crcs_kv(grid, by_dev, base):
    """Committer half of the key-value CRC exchange: merge every rank's
    posted record into ``{dev: (rank, [crc, ...])}``. A rank that never
    posted, or posted a torn record, leaves its partitions absent; the
    committer's missing-slice check names it."""
    from . import coord

    kv = coord.default_kv()
    out: dict = {}
    for r in range(coord.process_count()):
        key = _crc_kv_key(base, r)
        rec = _kv_wait(kv, key)
        if rec is None:  # dead before posting: its partitions stay absent
            continue
        try:
            msg = json.loads(coord.unseal_record(rec, key=key))
        except coord.TornRecordError:
            continue  # a torn post is a dead rank to the committer
        for ds, crcs in msg["devs"].items():
            out[int(ds)] = (int(msg["rank"]), [int(c) for c in crcs])
    return out


def _gather_run_crcs(grid, runs, local_crcs, rank, tmp, real,
                     via_kv=False, base=""):
    """Collect every rank's per-run CRC32s into one table ``{dev: (rank,
    [crc, ...])}``. A process group exchanges through
    ``torch.distributed.all_gather_object`` after the commit barrier
    (the reference's ``comm.host_all_gather``); ``via_kv`` (a
    :func:`~dccrg_tpu_torch.background.freeze_grid_mp` snapshot) reads
    the key-value records every rank posted before the barrier instead,
    so the exchange is legal on a writer thread. A faked split merges
    the in-process stage table (its passes run one after the other)."""
    by_dev: dict = {}
    for gri, (d, _seg, _lo, _hi) in enumerate(runs):
        by_dev.setdefault(d, []).append(gri)
    if real and via_kv:
        return _read_run_crcs_kv(grid, by_dev, base)
    mine = {d: (rank, [int(local_crcs[g]) & 0xFFFFFFFF for g in gris])
            for d, gris in by_dev.items() if grid._proc_local_dev[d]}
    if not real:
        stage = _MP_CRC_STAGE.setdefault(tmp, {})
        stage.update(mine)
        return dict(stage)
    from . import coord

    parts = [None] * coord.process_count()
    torch.distributed.all_gather_object(parts, mine)
    out: dict = {}
    for part in parts:
        out.update(part or {})
    return out


def _mp_piece_bytes(grid, counts, idx, fixed_spec, fixed_bytes, var_spec):
    """Serialize the cells at sorted positions ``idx`` (all on this
    rank's partitions) through ``grid._shard_read``: the same layout
    as :func:`_chunk_payload`, read partition by partition."""
    dev = grid.plan.owner[idx]
    rows = grid.plan.row_of_pos[idx].astype(np.int64)
    n = len(idx)

    def column(name):
        t = grid._shard_read(name, dev, rows).contiguous()
        return t.view(torch.uint8).reshape(n, -1).numpy()

    if fixed_spec:
        fixed = np.concatenate([column(s[0]) for s in fixed_spec], axis=1)
    else:
        fixed = np.empty((n, 0), dtype=np.uint8)
    if not var_spec:
        return fixed
    var_host = {name: column(name) for name, *_ in var_spec}
    var_nbytes = {
        name: counts[name][idx].astype(np.int64) * row_bytes
        for name, count_field, row_shape, dtype, row_bytes, cap in var_spec
    }
    return _interleave(n, fixed, var_host, var_nbytes, fixed_bytes,
                       var_spec)


def _mp_piece(grid, counts, idx, fixed_spec, fixed_bytes, var_spec):
    card = grid._card
    with (torch.cuda.device(card) if card is not None
          else nullcontext()):
        return _mp_piece_bytes(grid, counts, idx, fixed_spec, fixed_bytes,
                               var_spec)


def _save_process_slice(grid, filename, meta, cells, offsets, sizes, counts,
                        fixed_spec, fixed_bytes, var_spec, header_size=0,
                        sidecar=False, sidecar_chunk_bytes=None,
                        sidecar_extra=None):
    """Two-phase-commit save under a process split
    (dccrg_tpu/checkpoint.py:593-783).

    Every rank writes its OWN partitions' payload runs (the reference
    dccrg's collective MPI-IO write with per-rank file views,
    dccrg.hpp:1594-1659), into ``<file>.mp-tmp``, never the final name,
    with a CRC32 per run:

    1. **prepare**: the meta-writing rank lays down the replicated
       metadata and cell/offset table and pre-sizes the temp file; a
       timeout-guarded barrier releases the slice writers; every rank
       writes its runs (the one-deep prefetch pipeline of the
       one-process save) and fsyncs.
    2. **commit**: a second barrier, then the CRC exchange
       (:func:`_gather_run_crcs`); the committing rank re-reads the temp
       file, verifies every slice against its writer's CRC (raising
       :class:`~dccrg_tpu_torch.coord.CheckpointCommitError` naming
       the dead or torn ranks), fsyncs and renames atomically.

    A rank death or I/O fault at any rank and phase leaves either the
    old or the new checkpoint intact under the final name; a lost rank
    becomes a :class:`~dccrg_tpu_torch.coord.BarrierTimeoutError`.
    With ``sidecar`` the committing rank also writes the CRC32 sidecar
    with the per-rank slice table ``[dev, rank, lo, hi, crc]``, so a
    salvage load can name a dead rank's cells."""
    from concurrent.futures import ThreadPoolExecutor

    from . import coord

    real = coord.process_count() > 1  # vs. a faked split
    rank = coord.process_rank(grid)
    writes_meta = getattr(grid, "_ckpt_writes_meta", None)
    if writes_meta is None:
        writes_meta = (coord.process_index() == 0) if real else True
    commits = getattr(grid, "_ckpt_commits", None)
    if commits is None:
        commits = writes_meta
    tmp = filename + MP_TMP_SUFFIX
    # a per-grid save-attempt epoch in every barrier tag: the ranks
    # enter a save together even after an attempt failed at different
    # points on different ranks, so tagging by attempt re-aligns the
    # barrier sequence on a collective retry. A freeze_grid_mp snapshot
    # counts through its SOURCE grid (_mp_epoch_src): bumping only the
    # shallow copy would hand the next save the same attempt number
    attempt_src = getattr(grid, "_mp_epoch_src", None) or grid
    attempt = getattr(attempt_src, "_mp_save_epoch", 0) + 1
    attempt_src._mp_save_epoch = attempt
    grid._mp_save_epoch = attempt
    base = f"{os.path.basename(filename)}#{attempt}"
    end = int(offsets[-1] + sizes[-1]) if len(cells) else len(meta)
    runs = _device_runs(grid.n_dev, grid.plan.owner, offsets, sizes)

    # -- phase 1: prepare: meta + slice runs into the temp file --------
    faults.fire("checkpoint.mp", phase="meta", rank=rank, path=filename)
    if writes_meta:
        _MP_CRC_STAGE.pop(tmp, None)  # a fresh attempt (faked split)
        with open(tmp, "wb") as f:
            f.write(meta)
            for pairs in _pair_chunks(cells, offsets, 0, 0):
                f.write(pairs)
            f.truncate(end)  # pre-size so every rank can write its runs
            f.flush()
            os.fsync(f.fileno())
    coord.barrier(f"save_prepare:{base}")

    mine = [g for g, r in enumerate(runs) if grid._proc_local_dev[r[0]]]
    local_crcs: dict = {g: 0 for g in mine}
    with phase("slices"), open(tmp, "r+b") as f, \
            ThreadPoolExecutor(1) as pool:
        # a run's pieces share one seek; the pull of piece k+1 (on the
        # worker) overlaps the write of piece k
        pieces = [
            (g, s == 0, runs[g][1][s : s + CHUNK], runs[g][2])
            for g in mine
            for s in range(0, len(runs[g][1]), CHUNK)
        ]

        def assemble(piece):
            return _mp_piece(grid, counts, piece[2], fixed_spec,
                             fixed_bytes, var_spec)

        fut = pool.submit(assemble, pieces[0]) if pieces else None
        for i, (g, is_run_start, _idx, lo) in enumerate(pieces):
            buf = fut.result()
            if i + 1 < len(pieces):
                fut = pool.submit(assemble, pieces[i + 1])
            faults.fire("checkpoint.mp", phase="slice", rank=rank,
                        piece=i, path=filename)
            if is_run_start:
                f.seek(lo)
            f.write(buf)
            local_crcs[g] = zlib.crc32(buf, local_crcs[g])
        f.flush()
        os.fsync(f.fileno())
    faults.fire("checkpoint.mp", phase="written", rank=rank, path=filename)

    # -- phase 2: commit barrier, CRC exchange, verify + publish ------
    via_kv = real and bool(getattr(grid, "_ckpt_crc_via_kv", False))
    if via_kv:
        # post BEFORE the barrier: once it releases, every surviving
        # rank's record is readable
        _post_run_crcs_kv(grid, runs, local_crcs, rank, base)
    coord.barrier(f"save_commit:{base}")
    crc_table = _gather_run_crcs(grid, runs, local_crcs, rank, tmp, real,
                                 via_kv=via_kv, base=base)
    status_key = f"dccrg_commit:{base}"
    kv = coord.default_kv() if real else None
    if commits:
        # the metadata and offset table are REPLICATED: the committer
        # recomputes their CRC locally, so a tear there needs no
        # exchange to be caught
        meta_crc = zlib.crc32(meta)
        for pairs in _pair_chunks(cells, offsets, 0, 0):
            meta_crc = zlib.crc32(pairs, meta_crc)
        commit_err = None
        try:
            with phase("commit"):
                _commit_process_slices(grid, filename, tmp, runs,
                                       crc_table, header_size, sidecar,
                                       sidecar_chunk_bytes, rank,
                                       meta_crc & 0xFFFFFFFF,
                                       len(meta) + 16 * len(cells),
                                       sidecar_extra=sidecar_extra)
        except faults.InjectedRankDeath:
            raise  # a dead rank coordinates nothing
        except Exception as e:  # noqa: BLE001 - re-raised below
            commit_err = e
        _MP_CRC_STAGE.pop(tmp, None)
        if kv is not None:
            # publish the outcome BEFORE the done barrier: the peers
            # read it right after and learn of an abort at once instead
            # of mistaking a live but aborted committer for a dead one
            kv.set(status_key,
                   "ok" if commit_err is None
                   else f"commit aborted on rank {rank}: {commit_err}")
        if commit_err is not None:
            try:
                coord.barrier(f"save_done:{base}")
            except Exception:  # the abort outranks a straggling peer
                pass
            raise commit_err
    coord.barrier(f"save_done:{base}")
    if not commits and kv is not None:
        status = _kv_wait(kv, status_key)  # None: the barrier governs
        if status is not None and status != "ok":
            raise coord.CheckpointCommitError(
                f"{filename}: {status}; the previous checkpoint is "
                "untouched")


def _commit_process_slices(grid, filename, tmp, runs, crc_table,
                           header_size, sidecar, sidecar_chunk_bytes, rank,
                           meta_crc, payload_start, sidecar_extra=None):
    """The committing rank's half of the two-phase save: verify the
    replicated metadata block (against ``meta_crc``, recomputed
    locally) and every payload slice of the temp file against its
    writer's CRC, then publish atomically (the old sidecar dropped, the
    rename, the directory fsync, the new sidecar), the rename discipline
    of ``resilience.save_checkpoint``."""
    from . import coord, resilience

    faults.fire("checkpoint.mp", phase="commit", rank=rank, path=filename)
    by_dev: dict = {}
    for gri, (d, _seg, lo, hi) in enumerate(runs):
        by_dev.setdefault(d, []).append((gri, lo, hi))
    missing = sorted(d for d in by_dev if d not in crc_table
                     or len(crc_table[d][1]) != len(by_dev[d]))
    if missing:
        raise coord.CheckpointCommitError(
            f"{filename}: commit aborted — no slice CRCs from device(s) "
            f"{missing} (their rank died before the commit barrier); the "
            "previous checkpoint is untouched",
            ranks=[crc_table[d][0] for d in missing if d in crc_table])
    # ONE sequential pass over the temp file gives all three CRC
    # layouts: the metadata block (chunk 0 of the tiling), the
    # sidecar's chunks and the per-rank slice spans (sorted by start
    # for the streaming overlay, then put back in run order)
    entries = [(d, k, lo, hi)
               for d in sorted(by_dev)
               for k, (_gri, lo, hi) in enumerate(by_dev[d])]
    order = sorted(range(len(entries)), key=lambda i: entries[i][2])
    cb = sidecar_chunk_bytes or resilience.CRC_CHUNK
    file_bytes = os.path.getsize(tmp)
    chunk_ranges = resilience._chunk_ranges(payload_start, file_bytes, cb)
    chunk_crcs, sorted_crcs = resilience._stream_crcs(
        tmp, chunk_ranges, [(entries[i][2], entries[i][3]) for i in order],
        cb)
    got = [0] * len(entries)
    for k, i in enumerate(order):
        got[i] = sorted_crcs[k]
    if chunk_crcs[0] != meta_crc:
        raise coord.CheckpointCommitError(
            f"{filename}: commit aborted — the metadata/offset-table "
            "block of the temp file does not match its replicated bytes "
            "(torn prepare write); the previous checkpoint is untouched")
    slices = []  # [dev, rank, lo, hi, crc] rows for the sidecar
    torn = []
    for i, (d, k, lo, hi) in enumerate(entries):
        wrank, want = crc_table[d]
        if got[i] != (want[k] & 0xFFFFFFFF):
            torn.append((d, wrank))
        slices.append([int(d), int(wrank), int(lo), int(hi),
                       int(want[k] & 0xFFFFFFFF)])
    if torn:
        devs = sorted({d for d, _r in torn})
        ranks = sorted({r for _d, r in torn})
        raise coord.CheckpointCommitError(
            f"{filename}: commit aborted — slice(s) of device(s) {devs} "
            f"(written by rank(s) {ranks}) fail their CRC32 in the temp "
            "file (torn write / rank died mid-slice); the previous "
            "checkpoint is untouched", ranks=ranks)
    rec = None
    if sidecar:
        rec = {"format": resilience.SIDECAR_FORMAT, "chunk_bytes": cb,
               "file_bytes": file_bytes, "payload_start": payload_start,
               "header_size": header_size, "crc32": chunk_crcs,
               "slices": slices}
        if sidecar_extra:
            rec.update(sidecar_extra)
    # drop any previous sidecar BEFORE the rename (never a new file
    # under a stale record), keeping its bytes to put back if the
    # rename itself fails
    side = resilience.sidecar_path(filename)
    old_side = None
    if os.path.exists(side):
        with open(side, "rb") as sf:
            old_side = sf.read()
        os.unlink(side)
    try:
        os.replace(tmp, filename)
    except OSError:
        resilience._restore_sidecar(side, old_side)
        raise
    resilience._fsync_dir(os.path.dirname(os.path.abspath(filename)))
    faults.fire("checkpoint.mp", phase="publish", rank=rank, path=filename)
    if rec is not None:
        resilience._write_sidecar_record(side, rec)


# ---------------------------------------------------------------------
# load
# ---------------------------------------------------------------------

def _grid_skeleton_matches(grid, mapping, hood_len, topology, geometry):
    if mapping != grid.mapping:
        raise ValueError(f"file grid {mapping} does not match {grid.mapping}")
    if topology != grid.topology:
        raise ValueError("file periodicity does not match the grid")
    if hood_len != grid._hood_len:
        raise ValueError(
            f"file neighborhood length {hood_len} != grid {grid._hood_len}"
        )
    if geometry.geometry_id != grid.geometry.geometry_id:
        raise ValueError("file geometry kind does not match the grid")
    if geometry.to_bytes() != grid.geometry.to_bytes():
        raise ValueError(
            "file geometry parameters do not match the grid (same kind, "
            "different start/cell lengths or coordinate arrays)"
        )


def _assign_rows(host, dev, rows, vals) -> None:
    """``host[dev, rows] = vals``, as a slice when the cells are one run
    of rows of one partition."""
    if len(rows) and int(rows[-1]) - int(rows[0]) == len(rows) - 1 and (
            len(rows) == 1 or np.all(np.diff(rows) == 1)) and (
            dev[0] == dev[-1] and np.all(dev == dev[0])):
        host[int(dev[0]), int(rows[0]) : int(rows[0]) + len(rows)] = vals
    else:
        host[dev, rows] = vals


def _scatter_payloads(grid, raw, cells, offsets, fixed_spec, fixed_bytes,
                      var_spec):
    """Stream payloads from ``raw`` (a memory map) into host
    ``[n_dev, R]`` arrays, each cell at its owner's row, and upload one
    tensor per field (the reference's single-controller path,
    dccrg_tpu/checkpoint.py:921-1000). Two passes when variable fields
    exist: fixed parts (counts among them) first, then the ragged rows
    (dccrg.hpp:2108-2123).

    Under a process split only this rank's cells are scattered (the
    reference dccrg's per-rank collective read, dccrg.hpp:2108-2390):
    the other ranks' rows of the uploaded tensors stay zero."""
    hosts = {}
    for name, (shape, dtype) in grid.fields.items():
        hosts[name] = np.zeros((len(grid._held), grid.plan.R) + shape,
                               dtype=storage_dtype(dtype))
    # the file's cells are the plan's (load_cells sorted them), so a
    # chunk's rows come straight from the plan's row table
    same = (len(cells) == len(grid.plan.cells)
            and np.array_equal(cells, grid.plan.cells))
    pos_of = None  # sorted positions of the scattered cells
    if grid._multiproc:
        owner = (grid.plan.owner if same else
                 grid.plan.owner[np.searchsorted(grid.plan.cells, cells)])
        keep = np.flatnonzero(grid._proc_local_dev[owner])
        cells = cells[keep]
        offsets = offsets[keep]
        if same:
            pos_of = keep

    def rows_of(start, ids):
        # (held slot, row) of each cell: the host arrays hold this
        # process's partitions (every one without a rank placement)
        if pos_of is not None:
            p = pos_of[start : start + len(ids)]
            dev, rows = grid.plan.owner[p], grid.plan.row_of_pos[p]
        elif same and not grid._multiproc:
            dev = grid.plan.owner[start : start + len(ids)]
            rows = grid.plan.row_of_pos[start : start + len(ids)]
        else:
            dev, rows = grid._host_rows(ids)
        return grid._slot[dev], np.asarray(rows, dtype=np.int64)

    with phase("scatter"):
        # pass 1: fixed-size parts at each cell's offset
        for start in range(0, len(cells), CHUNK):
            ids = cells[start : start + CHUNK]
            offs = offsets[start : start + CHUNK].astype(np.int64)
            dev, rows = rows_of(start, ids)
            payload = _dense_block(raw, offs, fixed_bytes)
            if payload is None:
                idx = offs[:, None] + np.arange(fixed_bytes, dtype=np.int64)[None, :]
                payload = raw[idx]
            col = 0
            for name, shape, dtype, nbytes in fixed_spec:
                vals = payload[:, col : col + nbytes].copy().view(dtype).reshape(
                    (len(ids),) + shape
                )
                _assign_rows(hosts[name], dev, rows, vals)
                col += nbytes

        # pass 2: ragged rows, sized by the counts read in pass 1
        for name, count_field, row_shape, dtype, row_bytes, cap in var_spec:
            for start in range(0, len(cells), CHUNK):
                ids = cells[start : start + CHUNK]
                offs = offsets[start : start + CHUNK].astype(np.int64)
                dev, rows = rows_of(start, ids)
                c = hosts[count_field][dev, rows].astype(np.int64)
                if np.any(c < 0) or np.any(c > cap):
                    raise ValueError(
                        f"corrupt counts for variable field {name!r} in file"
                    )
                # variable fields follow the fixed block; earlier
                # variable fields (sorted order) of the same cell first
                base = offs + fixed_bytes
                for vn, vcf, _rs, _dt, vrb, _cap in var_spec:
                    if vn == name:
                        break
                    base = base + hosts[vcf][dev, rows].astype(np.int64) * vrb
                total = int(c.sum())
                if total == 0:
                    continue
                cell_of_row = np.repeat(np.arange(len(ids)), c)
                row_within = (np.arange(total, dtype=np.int64)
                              - np.repeat(np.cumsum(c) - c, c))
                starts = base[cell_of_row] + row_within * row_bytes
                # the byte-index matrix is built in bounded sub-blocks
                # with the narrowest index type the file size allows
                idt = np.uint32 if raw.size < (1 << 32) else np.int64
                span = np.arange(row_bytes, dtype=idt)[None, :]
                blk = max(1, (8 << 20) // row_bytes)
                for s in range(0, total, blk):
                    e = min(s + blk, total)
                    idx = starts[s:e, None].astype(idt) + span
                    vals = raw[idx].copy().view(dtype).reshape(
                        (e - s,) + row_shape)
                    hosts[name][dev[cell_of_row[s:e]],
                                rows[cell_of_row[s:e]],
                                row_within[s:e]] = vals

    with phase("upload"):
        for name, (shape, dtype) in grid.fields.items():
            t = torch.from_numpy(hosts[name])
            if dtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
            grid.data[name] = grid._from_held(t)
            del hosts[name]
    # a wholesale load resets the delta-checkpoint baseline: every
    # field's saved bytes may now differ from the previous chain's
    grid._mark_ckpt_dirty()


def load_grid_data(grid, filename: str, header_size: int = 0,
                   variable=None) -> bytes:
    """Rebuild structure and data from a file written by
    save_grid_data into an ALREADY-CONSTRUCTED grid whose parameters
    are validated against the file (a mismatched restart fails loudly
    rather than corrupting). Returns the user header. For restart from
    nothing but the file, use :func:`load_grid` / ``Grid.from_file``."""
    raw = np.memmap(filename, dtype=np.uint8, mode="r")
    header = bytes(raw[:header_size])
    with phase("parse"):
        mapping, hood_len, topology, geometry, cells, offsets, _ = \
            parse_metadata(raw, header_size)
    _grid_skeleton_matches(grid, mapping, hood_len, topology, geometry)
    fixed_spec, fixed_bytes, var_spec = _payload_spec_of(grid.fields, variable)
    with phase("load_cells"):
        grid.load_cells(cells)
    _scatter_payloads(grid, raw, cells, offsets, fixed_spec, fixed_bytes,
                      var_spec)
    _load_done_barrier()
    return header


def _load_done_barrier():
    """In a process group, hold every rank until all have scattered
    their slices: a fast rank must not go on to overwrite or replace
    the file while a peer still reads it. One process returns at once.
    Tagged without the filename, since salvage loads read per-rank
    scratch names. Best effort: this rank's load is complete, so a
    peer that cannot answer (it died, which is when survivors load)
    must not turn it into a failure; the timeout is logged instead."""
    from . import coord

    if coord.process_count() > 1:
        import logging

        try:
            coord.barrier("load_done")
        except Exception as e:  # noqa: BLE001 - the load is locally done
            logging.getLogger("dccrg_tpu_torch.checkpoint").warning(
                "load_done barrier did not complete (%s); this rank's "
                "load IS complete — do not overwrite the file until "
                "the lost peers are accounted for", e)


def load_grid(filename: str, cell_data, device=None, header_size: int = 0,
              variable=None):
    """Restart from nothing but the file: reconstruct mapping,
    topology, geometry, neighborhood length and the AMR cell set from
    the metadata (the reference's start_loading_grid_data,
    dccrg.hpp:1815-2105), then stream the payloads in. ``cell_data`` is
    the field spec; ``device`` as for ``Grid.initialize`` (the card
    unless the caller asks for the CPU). Returns ``(grid, header)``."""
    from .grid import Grid

    raw = np.memmap(filename, dtype=np.uint8, mode="r")
    header = bytes(raw[:header_size])
    with phase("parse"):
        mapping, hood_len, topology, geometry, cells, offsets, _ = \
            parse_metadata(raw, header_size)
    kind, params = geometry.spec()
    with phase("initialize"):
        grid = (
            Grid(cell_data=cell_data)
            .set_initial_length(tuple(int(v) for v in mapping.length.get()))
            .set_maximum_refinement_level(mapping.max_refinement_level)
            .set_periodic(*(topology.is_periodic(d) for d in range(3)))
            .set_neighborhood_length(hood_len)
            .set_geometry(kind, **params)
            .initialize(device)
        )
    fixed_spec, fixed_bytes, var_spec = _payload_spec_of(grid.fields, variable)
    with phase("load_cells"):
        grid.load_cells(cells)
    _scatter_payloads(grid, raw, cells, offsets, fixed_spec, fixed_bytes,
                      var_spec)
    _load_done_barrier()
    return grid, header
