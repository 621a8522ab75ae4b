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
the partition. The reference's multi-process slice writers and the
load-done barrier wait for the multi-process slice of the port.
"""

from __future__ import annotations

import hashlib
import os
import struct
import time
from contextlib import contextmanager

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
    """The owned rows of field ``name``: each partition's rows
    ``[0, n_local[p])`` in partition order (ghost and pad rows left
    out), on the grid's device."""
    x = grid.data[name]
    parts = [x[p, :int(grid.plan.n_local[p])] for p in range(grid.n_dev)]
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

def _gather_bytes(grid, names, rows_t) -> np.ndarray:
    """``uint8[n, bytes]`` of the flat rows ``rows_t`` (``partition *
    R + row``) of fields ``names``, interleaved per row in the given
    order: one ``index_select`` per field on the grid's device, the
    byte views concatenated there, one blocking copy to the host."""
    from .grid import _flat

    n = int(rows_t.shape[0])
    if not names:
        return np.empty((n, 0), dtype=np.uint8)
    cols = [_flat(grid.data[name]).index_select(0, rows_t).contiguous()
            .view(torch.uint8).reshape(n, -1) for name in names]
    out = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
    return out.cpu().numpy()


def _chunk_bytes(grid, counts, start, fixed_spec, fixed_bytes, var_spec):
    """Serialize the cells at positions ``[start, start + CHUNK)`` of
    the grid's sorted cell list (device gather + host assembly). Runs
    on the save's worker thread, so the next chunk's device pull
    overlaps the file write of the current one."""
    idx = np.arange(start, min(start + CHUNK, len(grid.plan.cells)))
    # the single-controller pull: every partition's rows are this
    # process's, so a chunk is one gather over the flat rows
    rows_t = torch.as_tensor(
        grid.plan.owner[idx].astype(np.int64) * grid.plan.R
        + grid.plan.row_of_pos[idx], device=grid.device)
    if grid.device.type == "cuda":
        with torch.cuda.device(grid.device):
            return _chunk_payload(grid, counts, idx, rows_t, fixed_spec,
                                  fixed_bytes, var_spec)
    return _chunk_payload(grid, counts, idx, rows_t, fixed_spec,
                          fixed_bytes, var_spec)


def _chunk_payload(grid, counts, idx, rows_t, fixed_spec, fixed_bytes,
                   var_spec):
    fixed = _gather_bytes(grid, [s[0] for s in fixed_spec], rows_t)
    if not var_spec:
        return fixed
    var_host = {name: _gather_bytes(grid, [name], rows_t)
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
                   variable=None, *, fields=None) -> None:
    """Write the grid and all cell data (dccrg.hpp:1109-1736), the
    payload streamed in chunks of :data:`CHUNK` cells with the device
    pull of chunk k+1 (on a worker thread) overlapping the file write
    of chunk k. ``variable={"field": "count_field"}`` stores that field
    truncated to each cell's count (dccrg.hpp:2108-2123). ``fields``
    restricts the save to a subset of the grid's fields (the delta
    checkpoint's path): the file is a valid ``.dc`` of the sub-schema,
    in the byte layout of a full save."""
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
    if var_spec:
        # per-cell byte sizes: variable fields add count * row bytes
        sizes = np.full(len(cells), fixed_bytes, dtype=np.uint64)
        for name, count_field, row_shape, dtype, row_bytes, cap in var_spec:
            c = np.asarray(grid.get(count_field, cells)).astype(np.int64)
            if np.any(c < 0) or np.any(c > cap):
                raise ValueError(f"count field {count_field!r} out of range for {name!r}")
            counts[name] = c
            sizes += (c * row_bytes).astype(np.uint64)
        offsets = offset0 + np.concatenate(
            [[np.uint64(0)], np.cumsum(sizes)[:-1]]).astype(np.uint64)
    else:
        offsets = None  # packed: cell i's payload at offset0 + i * fixed_bytes

    starts = list(range(0, len(cells), CHUNK))
    with open(filename, "wb") as f, ThreadPoolExecutor(1) as pool:
        f.write(bytes(meta))
        for start in starts:
            end = min(start + CHUNK, len(cells))
            pairs = np.empty((end - start, 2), dtype=np.uint64)
            pairs[:, 0] = cells[start:end]
            if offsets is None:
                pairs[:, 1] = np.arange(start, end, dtype=np.uint64) \
                    * np.uint64(fixed_bytes) + np.uint64(offset0)
            else:
                pairs[:, 1] = offsets[start:end]
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
    (dccrg.hpp:2108-2123)."""
    hosts = {}
    for name, (shape, dtype) in grid.fields.items():
        hosts[name] = np.zeros((grid.n_dev, grid.plan.R) + shape,
                               dtype=storage_dtype(dtype))
    # the file's cells are the plan's (load_cells sorted them), so a
    # chunk's rows come straight from the plan's row table
    same = (len(cells) == len(grid.plan.cells)
            and np.array_equal(cells, grid.plan.cells))

    def rows_of(start, ids):
        if same:
            return (grid.plan.owner[start : start + len(ids)],
                    grid.plan.row_of_pos[start : start + len(ids)].astype(np.int64))
        return grid._host_rows(ids)

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
            grid.data[name] = t.to(grid.device)
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
    return header


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
    return grid, header
