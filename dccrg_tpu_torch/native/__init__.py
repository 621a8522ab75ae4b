"""ctypes loader for the port's native (C++) host engine.

``dccrg_native.cpp`` is the port's copy of the reference package's
host engine (dccrg_tpu/native/dccrg_native.cpp): the neighbor engine,
the bulk mapping and geometry queries, the one-pass uniform tables, the
hybrid plan's in-place table writers and the space-filling-curve keys,
all on the host CPU. Its results equal the NumPy paths of the modules
that call it, bit for bit.

Nothing is built on import. The first call of :func:`lib` compiles the
source with g++ into ``dccrg_tpu_torch/_build/`` (git-ignored), named by
a hash of the source, the flags, ``platform.machine()`` and the g++
version line, so a library built with ``-march=native`` on one host is
never loaded on another. The compile goes to a temporary name and is
published with ``os.replace`` under a file lock, so processes that
start at once build it once. Without OpenMP the build is retried
serially; if g++ is missing or the build fails, the compiler's error
is printed and :func:`lib` returns None: every caller then takes its
NumPy path.

Two switches select the NumPy paths: ``DCCRG_TPU_NATIVE=0`` for the
process, and ``with engine(False):`` for a block of code (the tests and
the chip smoke run both engines in one process that way).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "dccrg_native.cpp"
BUILD_DIR = _HERE.parent / "_build"
# no FMA contraction: the geometry kernels promise bit-identical
# results vs the NumPy paths
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         "-ffp-contract=off", "-fopenmp")
ABI_VERSION = 2

_UNSET = object()
_lib = _UNSET
_enabled = True
_lock = threading.Lock()

#: What the load found: ``path``, ``gxx`` (the g++ version line),
#: ``built`` (this process compiled it), ``seconds`` (the compile's
#: wall time, 0.0 when it was found built), ``openmp`` (libgomp linked)
#: and ``threads`` (OpenMP's thread count, 1 without it).
build_info: dict = {}


def lib():
    """The loaded engine, or None when the NumPy paths are selected
    (``DCCRG_TPU_NATIVE=0``, or inside ``engine(False)``) or the engine
    could not be built. Builds and loads it at the first call."""
    global _lib
    if not _enabled or os.environ.get("DCCRG_TPU_NATIVE", "1") == "0":
        return None
    if _lib is _UNSET:
        with _lock:
            if _lib is _UNSET:
                _lib = _load()
    return _lib


@contextlib.contextmanager
def engine(on: bool):
    """Run the block with the native engine (``True``) or with the NumPy
    paths (``False``); the previous choice is restored on exit."""
    global _enabled
    saved = _enabled
    _enabled = bool(on)
    try:
        yield
    finally:
        _enabled = saved


def _compile(cmd, tmp):
    """Run one g++ command; returns its stderr on failure, else None."""
    try:
        proc = subprocess.run(cmd + ["-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True)
    except OSError as exc:
        return str(exc)
    return None if proc.returncode == 0 else proc.stderr


def _build(so):
    """Compile the source into ``so`` unless another process already
    has (under an exclusive lock); returns the compile's seconds, or
    None when it failed (the compiler's errors printed)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".dccrg_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return 0.0
        tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        err = _compile(["g++", *FLAGS], tmp)
        if err is not None:
            # retry without OpenMP (a serial build still beats NumPy)
            err2 = _compile(["g++", *(f for f in FLAGS if f != "-fopenmp")],
                            tmp)
            if err2 is not None:
                print("dccrg_tpu_torch: native engine build failed, using "
                      f"the NumPy paths:\n{err}\n{err2}", file=sys.stderr)
                tmp.unlink(missing_ok=True)
                return None
        os.replace(tmp, so)
        return time.perf_counter() - t0


def _load():
    try:
        gxx = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True).stdout.splitlines()[0]
    except (OSError, IndexError) as exc:
        print(f"dccrg_tpu_torch: g++ not usable ({exc}); the native engine "
              "is off, using the NumPy paths", file=sys.stderr)
        return None
    fingerprint = (_SRC.read_bytes()
                   + f"|{platform.machine()}|{gxx}|{' '.join(FLAGS)}".encode())
    tag = hashlib.sha256(fingerprint).hexdigest()[:16]
    so = BUILD_DIR / f"dccrg_native-{tag}.so"
    seconds = 0.0 if so.exists() else _build(so)
    if seconds is None:
        return None
    try:
        dll = ctypes.CDLL(str(so))
    except OSError as exc:
        print(f"dccrg_tpu_torch: cannot load {so.name}: {exc}", file=sys.stderr)
        return None
    if dll.dn_abi_version() != ABI_VERSION:
        print(f"dccrg_tpu_torch: {so.name} has ABI {dll.dn_abi_version()}, "
              f"not {ABI_VERSION}", file=sys.stderr)
        return None
    _declare(dll)
    # dlsym on the library's handle searches its own dependencies only,
    # so the symbol is there exactly when libgomp was linked in
    openmp = hasattr(dll, "omp_get_max_threads")
    build_info.update(
        path=str(so), gxx=gxx, built=seconds > 0.0, seconds=seconds,
        openmp=openmp,
        threads=int(dll.omp_get_max_threads()) if openmp else 1)
    return dll


def _declare(dll):
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    sigs = {
        "dn_find_neighbors_of": (i64, [
            u64p, i32, u8p,             # grid_length, max_lvl, periodic
            u64p, i64,                  # cells_sorted, n_cells
            u64p, i64,                  # query, n_query
            i64p, i64,                  # hood, n_hood
            i64p, u64p, i64p, i64p,     # out src/nbr/off/item
            i64,                        # capacity
            u64p, i64p,                 # err_cell, err_item
        ]),
        "dn_find_neighbors_to_subset": (i64, [
            u64p, i32, u8p,             # grid_length, max_lvl, periodic
            u64p, i64,                  # cells_sorted, n_cells
            u64p, i64,                  # query, n_query
            i64p, i64,                  # hood, n_hood
            i64p, u64p, i64p, i64p,     # out q/src/off/item
            i64,                        # capacity
        ]),
        "dn_morton_keys": (None, [u64p, i64, i32, u64p]),
        "dn_hilbert_keys": (None, [u64p, i64, i32, u64p]),
        "dn_refinement_levels": (None, [u64p, i32, u64p, i64, i32p]),
        "dn_cell_indices": (None, [u64p, i32, u64p, i64, u64p]),
        "dn_geometry_min_len": (None, [u64p, i32, f64p, f64p, f64p,
                                       u64p, i64, f64p, f64p]),
        "dn_cell_lengths": (None, [u64p, i32, f64p, u64p, i64, f64p]),
        "dn_geometry_centers": (None, [u64p, i32, f64p, f64p, f64p,
                                       u64p, i64, f64p]),
        "dn_table_counts": (i64, [i32p, i32p, i64, i64, i64, i64p]),
        "dn_table_fill": (None, [i32p, i32p, i32p, i64p, i64, i64, i64,
                                 i64, i64p, i32p, i32p, u8p]),
        "dn_uniform_tables": (None, [
            i64, i64, i64,              # nx, ny, nz
            i32, i32, i32,              # periodic
            i64p, i64,                  # offs, k
            i32p, i32p,                 # row_of_pos, owner
            i32,                        # pad_row
            i32p, u8p,                  # rows_out, mask_out
        ]),
        "dn_sorted_positions": (None, [u64p, i64, u64p, i64, i64p]),
        "dn_level_lookup": (None, [
            i64, i64, i64,              # nxl, nyl, nzl
            i32, i32, i32,              # periodic
            i64p, i64, i64,             # lin, m, a
            u64p, i64, ctypes.c_uint64,  # cells, b, first
            i64p, i64,                  # offs, kb
            i32p, i64,                  # plat, n_lat
            i32p, u8p, u8p,             # pos, valid, exist
        ]),
        "dn_far_tables": (i64, [
            i64, i64, i64,              # nx, ny, nz
            i32, i32, i32,              # periodic
            i64p, i64,                  # offs, k
            i64p, i64, i64p,            # far_slots, nf, rowidx
            i32p, i32p,                 # row_of_pos0, owner0
            i32,                        # pad_row
            i32p, u8p,                  # rows_t, mask_t
            i64p, i64,                  # fix_out, fix_cap
        ]),
        "dn_easy_tables": (i64, [
            i64p, i64, i64p,            # ei, E, ridx
            i64p, i64,                  # sel, k
            i32p, u8p, i64,             # pos_all, valid_all, m
            i32p, i32p, i32p,           # row_of_pos, owner, edev
            i32,                        # pad_row
            i32p, u8p,                  # rows_t, mask_t
            i64p, i64,                  # fix_out, fix_cap
        ]),
        "dn_hard_counts": (None, [i64p, i64, i32p, i64, i64p]),
        "dn_hard_fill": (i64, [
            i64p, i64p, i64p, i64,      # s_p, s_n, s_off, nE
            i32p, i32p,                 # owner, row_of_pos
            i64, i64, i64,              # n_dev, Hmax, S
            i32, i32,                   # row_pad, nbr_pad
            i32p, i32p, i32p, u8p,      # rows/nbr/offs/mask
            i64p, i64,                  # fix_out, fix_cap
        ]),
        "dn_stream_remap_merge": (i64, [
            i64p, u8p,                  # old2new, reus_old
            i64p, i64p, i64p, i64p, i64,  # prev s/n/off/item
            i64p, i64p, i64p, i64p, i64,  # fresh s/n/off/item
            i64p, i64p, i64p, i64p, i64,  # merged + capacity
        ]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(dll, name)
        fn.restype = restype
        fn.argtypes = argtypes


def _need():
    """The engine, for wrappers whose callers checked ``lib()`` first."""
    dll = lib()
    if dll is None:
        raise RuntimeError("the native engine is not available")
    return dll


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _i32_ptr_or_null(arr):
    """int32 pointer, or a typed NULL when ``arr`` is None (optional
    owner/lattice parameters of the recommit kernels)."""
    if arr is None:
        return ctypes.cast(None, ctypes.POINTER(ctypes.c_int32))
    return _ptr(arr, ctypes.c_int32)


def _with_fixups(call, cap):
    """Run a table-writer kernel that appends cross-device fixup
    records into a caller-allocated buffer: retry with a bigger buffer
    until the count fits (the table writes themselves are idempotent).
    ``call(fix, cap)`` returns the total fixup count."""
    while True:
        fix = np.empty(cap, dtype=np.int64)
        n_fix = call(fix, cap)
        if n_fix <= cap:
            return fix[:n_fix]
        cap = int(n_fix)


def _grid_args(mapping, topology):
    length = np.ascontiguousarray(mapping.length.get(), dtype=np.uint64)
    periodic = np.array([topology.is_periodic(d) for d in range(3)],
                        dtype=np.uint8)
    return length, periodic


def find_neighbors_of(mapping, topology, all_cells_sorted, query_cells,
                      neighborhood):
    """Native find_neighbors_of; same contract as
    neighbors.find_neighbors_of before dedup. Raises
    neighbors.StructureError / ValueError with the same messages on
    invalid structure."""
    from ..neighbors import StructureError

    dll = _need()
    cells = np.ascontiguousarray(all_cells_sorted, dtype=np.uint64)
    query = np.ascontiguousarray(query_cells, dtype=np.uint64)
    hood = np.ascontiguousarray(neighborhood, dtype=np.int64).reshape(-1, 3)
    length, periodic = _grid_args(mapping, topology)
    n, k = len(query), len(hood)

    # headroom over the uniform-grid exact size (n*k) so the common
    # lightly-refined case doesn't pay a count-only pass plus a retry
    capacity = max(n * k + (n * k) // 4 + 64, 1)
    err_cell = np.zeros(1, dtype=np.uint64)
    err_item = np.zeros(1, dtype=np.int64)
    while True:
        src = np.empty(capacity, dtype=np.int64)
        nbr = np.empty(capacity, dtype=np.uint64)
        off = np.empty((capacity, 3), dtype=np.int64)
        item = np.empty(capacity, dtype=np.int64)
        total = dll.dn_find_neighbors_of(
            _ptr(length, ctypes.c_uint64), mapping.max_refinement_level,
            _ptr(periodic, ctypes.c_uint8),
            _ptr(cells, ctypes.c_uint64), len(cells),
            _ptr(query, ctypes.c_uint64), n,
            _ptr(hood, ctypes.c_int64), k,
            _ptr(src, ctypes.c_int64), _ptr(nbr, ctypes.c_uint64),
            _ptr(off, ctypes.c_int64), _ptr(item, ctypes.c_int64),
            capacity,
            _ptr(err_cell, ctypes.c_uint64), _ptr(err_item, ctypes.c_int64),
        )
        if total == -3:
            raise ValueError("invalid cell id in query")
        if total == -1:
            raise StructureError(
                f"no neighbor found for cell {err_cell[0]} at offset "
                f"{hood[err_item[0]]}: grid does not tile the domain"
            )
        if total == -2:
            lvl = mapping.get_refinement_level(err_cell[0])
            raise StructureError(
                f"cell {err_cell[0]} offset {hood[err_item[0]]}: window "
                f"neither tiled by level {lvl + 1} cells nor coarser "
                f"(2:1 balance violated or grid has gaps)"
            )
        if total <= capacity:
            return src[:total], nbr[:total], off[:total], item[:total]
        capacity = int(total)


def find_neighbors_to_subset_raw(mapping, topology, all_cells_sorted,
                                 query_cells, neighborhood):
    """Native raw to-subset enumeration: the candidate entries of
    neighbors.find_neighbors_to_subset's hard path, duplicates
    included (the caller dedups/orders exactly as the NumPy path).
    Returns (q_idx, src_id, off, item)."""
    dll = _need()
    cells = np.ascontiguousarray(all_cells_sorted, dtype=np.uint64)
    query = np.ascontiguousarray(query_cells, dtype=np.uint64)
    hood = np.ascontiguousarray(neighborhood, dtype=np.int64).reshape(-1, 3)
    length, periodic = _grid_args(mapping, topology)
    n, k = len(query), len(hood)
    capacity = max(2 * n * k + 64, 1)
    while True:
        q = np.empty(capacity, dtype=np.int64)
        srcs = np.empty(capacity, dtype=np.uint64)
        off = np.empty((capacity, 3), dtype=np.int64)
        item = np.empty(capacity, dtype=np.int64)
        total = dll.dn_find_neighbors_to_subset(
            _ptr(length, ctypes.c_uint64), mapping.max_refinement_level,
            _ptr(periodic, ctypes.c_uint8),
            _ptr(cells, ctypes.c_uint64), len(cells),
            _ptr(query, ctypes.c_uint64), n,
            _ptr(hood, ctypes.c_int64), k,
            _ptr(q, ctypes.c_int64), _ptr(srcs, ctypes.c_uint64),
            _ptr(off, ctypes.c_int64), _ptr(item, ctypes.c_int64),
            capacity,
        )
        if total == -3:
            raise ValueError("invalid cell id in query")
        if total <= capacity:
            return q[:total], srcs[:total], off[:total], item[:total]
        capacity = int(total)


def refinement_levels(mapping, cells) -> np.ndarray:
    """Native bulk refinement-level query (-1 for invalid ids)."""
    dll = _need()
    cells = np.ascontiguousarray(cells, dtype=np.uint64)
    length = np.ascontiguousarray(mapping.length.get(), dtype=np.uint64)
    out = np.empty(len(cells), dtype=np.int32)
    dll.dn_refinement_levels(
        _ptr(length, ctypes.c_uint64), mapping.max_refinement_level,
        _ptr(cells, ctypes.c_uint64), len(cells), _ptr(out, ctypes.c_int32),
    )
    return out.astype(np.int64)


def cell_indices(mapping, cells) -> np.ndarray:
    """Native bulk (n,3) min-corner indices (all-ones for invalid)."""
    dll = _need()
    cells = np.ascontiguousarray(cells, dtype=np.uint64)
    length = np.ascontiguousarray(mapping.length.get(), dtype=np.uint64)
    out = np.empty((len(cells), 3), dtype=np.uint64)
    dll.dn_cell_indices(
        _ptr(length, ctypes.c_uint64), mapping.max_refinement_level,
        _ptr(cells, ctypes.c_uint64), len(cells), _ptr(out, ctypes.c_uint64),
    )
    return out


def build_stencil_table(entry_dev, src_rows, nbr_rows, offs, n_dev, L, pad_row):
    """Pad the ragged per-cell neighbor entry stream into
    ([n_dev, L, S] rows, [n_dev, L, S, 3] offsets, [n_dev, L, S] mask)
    preserving per-cell entry order."""
    dll = _need()
    entry_dev = np.ascontiguousarray(entry_dev, dtype=np.int32)
    src_rows = np.ascontiguousarray(src_rows, dtype=np.int32)
    nbr_rows = np.ascontiguousarray(nbr_rows, dtype=np.int32)
    offs = np.ascontiguousarray(offs, dtype=np.int64).reshape(-1, 3)
    n = len(entry_dev)
    counts = np.zeros(n_dev * L, dtype=np.int64)
    S = int(dll.dn_table_counts(
        _ptr(entry_dev, ctypes.c_int32), _ptr(src_rows, ctypes.c_int32),
        n, n_dev, L, _ptr(counts, ctypes.c_int64),
    ))
    S = max(1, S)
    rows = np.full(n_dev * L * S, pad_row, dtype=np.int32)
    out_offs = np.zeros(n_dev * L * S * 3, dtype=np.int32)
    mask = np.zeros(n_dev * L * S, dtype=np.uint8)
    slots = np.zeros(n_dev * L, dtype=np.int64)
    dll.dn_table_fill(
        _ptr(entry_dev, ctypes.c_int32), _ptr(src_rows, ctypes.c_int32),
        _ptr(nbr_rows, ctypes.c_int32), _ptr(offs, ctypes.c_int64),
        n, n_dev, L, S,
        _ptr(slots, ctypes.c_int64), _ptr(rows, ctypes.c_int32),
        _ptr(out_offs, ctypes.c_int32), _ptr(mask, ctypes.c_uint8),
    )
    return (
        rows.reshape(n_dev, L, S),
        out_offs.reshape(n_dev, L, S, 3),
        mask.reshape(n_dev, L, S).astype(bool),
    )


def uniform_tables(dims, periodic, offs, row_of_pos, owner, pad_row):
    """One-pass uniform (level-0-only) gather tables: rows [n0, k] and
    mask [n0, k] in grid-index order. Cross-device entries carry the
    sentinel ``-2 - neighbor_gidx``; ``owner=None`` (one device) skips
    cross detection. Returns None when the engine is unavailable."""
    dll = lib()
    if dll is None:
        return None
    nx, ny, nz = (int(v) for v in dims)
    offs = np.ascontiguousarray(offs, dtype=np.int64).reshape(-1, 3)
    k = len(offs)
    row_of_pos = np.ascontiguousarray(row_of_pos, dtype=np.int32)
    n0 = nx * ny * nz
    rows = np.empty((n0, k), dtype=np.int32)
    mask = np.empty((n0, k), dtype=bool)
    own_arr = (np.ascontiguousarray(owner, dtype=np.int32)
               if owner is not None else None)
    dll.dn_uniform_tables(
        nx, ny, nz,
        int(bool(periodic[0])), int(bool(periodic[1])), int(bool(periodic[2])),
        _ptr(offs, ctypes.c_int64), k,
        _ptr(row_of_pos, ctypes.c_int32), _i32_ptr_or_null(own_arr),
        np.int32(pad_row),
        _ptr(rows, ctypes.c_int32), _ptr(mask, ctypes.c_uint8),
    )
    return rows, mask


def geometry_min_len(mapping, boundaries, cells):
    """Native (min corner, edge length) lookup: ``boundaries`` is the
    per-dimension level-0 boundary coordinate arrays."""
    dll = _need()
    cells = np.ascontiguousarray(cells, dtype=np.uint64)
    length = np.ascontiguousarray(mapping.length.get(), dtype=np.uint64)
    bd = [np.ascontiguousarray(b, dtype=np.float64) for b in boundaries]
    n = len(cells)
    out_min = np.empty((n, 3), dtype=np.float64)
    out_len = np.empty((n, 3), dtype=np.float64)
    dll.dn_geometry_min_len(
        _ptr(length, ctypes.c_uint64), mapping.max_refinement_level,
        _ptr(bd[0], ctypes.c_double), _ptr(bd[1], ctypes.c_double),
        _ptr(bd[2], ctypes.c_double),
        _ptr(cells, ctypes.c_uint64), n,
        _ptr(out_min, ctypes.c_double), _ptr(out_len, ctypes.c_double),
    )
    return out_min, out_len


def geometry_centers(mapping, boundaries, cells) -> np.ndarray:
    """Native (n,3) cell center coordinates."""
    dll = _need()
    cells = np.ascontiguousarray(cells, dtype=np.uint64)
    length = np.ascontiguousarray(mapping.length.get(), dtype=np.uint64)
    bd = [np.ascontiguousarray(b, dtype=np.float64) for b in boundaries]
    out = np.empty((len(cells), 3), dtype=np.float64)
    dll.dn_geometry_centers(
        _ptr(length, ctypes.c_uint64), mapping.max_refinement_level,
        _ptr(bd[0], ctypes.c_double), _ptr(bd[1], ctypes.c_double),
        _ptr(bd[2], ctypes.c_double),
        _ptr(cells, ctypes.c_uint64), len(cells), _ptr(out, ctypes.c_double),
    )
    return out


def cell_lengths(mapping, length_table, cells) -> np.ndarray:
    """Native (n,3) edge lengths from the per-level length table."""
    dll = _need()
    cells = np.ascontiguousarray(cells, dtype=np.uint64)
    length = np.ascontiguousarray(mapping.length.get(), dtype=np.uint64)
    tbl = np.ascontiguousarray(length_table, dtype=np.float64)
    out = np.empty((len(cells), 3), dtype=np.float64)
    dll.dn_cell_lengths(
        _ptr(length, ctypes.c_uint64), mapping.max_refinement_level,
        _ptr(tbl, ctypes.c_double),
        _ptr(cells, ctypes.c_uint64), len(cells), _ptr(out, ctypes.c_double),
    )
    return out


def sorted_positions(haystack, needles):
    """``np.searchsorted(haystack, needles)`` for SORTED needles as one
    linear native sweep. Returns None when the engine is unavailable."""
    dll = lib()
    if dll is None:
        return None
    hay = np.ascontiguousarray(haystack, dtype=np.uint64)
    nee = np.ascontiguousarray(needles, dtype=np.uint64)
    out = np.empty(len(nee), dtype=np.int64)
    dll.dn_sorted_positions(
        _ptr(hay, ctypes.c_uint64), len(hay),
        _ptr(nee, ctypes.c_uint64), len(nee), _ptr(out, ctypes.c_int64),
    )
    return out


def level_lookup(dims_l, periodic, lin, a, cells, b, first, offs,
                 plat, pos_out, valid_out, exist_out):
    """Batched level-block lookup (hybrid._LevelBlock): fill the
    caller's [kb, m] pos/valid/exist arrays for every offset at once.
    ``plat`` is the arena-held position-lattice scratch (int32,
    ``n_lat``) or None for the binary-search strategy. Returns False
    when the engine is unavailable (the caller takes its NumPy path)."""
    dll = lib()
    if dll is None:
        return False
    nxl, nyl, nzl = (int(v) for v in dims_l)
    lin = np.ascontiguousarray(lin, dtype=np.int64)
    offs = np.ascontiguousarray(offs, dtype=np.int64).reshape(-1, 3)
    dll.dn_level_lookup(
        nxl, nyl, nzl,
        int(bool(periodic[0])), int(bool(periodic[1])), int(bool(periodic[2])),
        _ptr(lin, ctypes.c_int64), len(lin), int(a),
        _ptr(cells, ctypes.c_uint64), int(b), ctypes.c_uint64(int(first)),
        _ptr(offs, ctypes.c_int64), len(offs),
        _i32_ptr_or_null(plat), 0 if plat is None else len(plat),
        _ptr(pos_out, ctypes.c_int32), _ptr(valid_out, ctypes.c_uint8),
        _ptr(exist_out, ctypes.c_uint8),
    )
    return True


def far_tables(dims, periodic, offs, far_slots, far_rowidx, row_of_pos0,
               owner0, pad_row, rows_t, mask_t):
    """Far-row gather tables written straight into the caller's
    [n_rows, k] tables at ``far_rowidx`` (no [n0, k] intermediate).
    Returns the packed ``i * k + j`` cross-device fixup indices (none
    when ``owner0`` is None), or None when the engine is unavailable."""
    dll = lib()
    if dll is None:
        return None
    nx, ny, nz = (int(v) for v in dims)
    offs = np.ascontiguousarray(offs, dtype=np.int64).reshape(-1, 3)
    far_slots = np.ascontiguousarray(far_slots, dtype=np.int64)
    far_rowidx = np.ascontiguousarray(far_rowidx, dtype=np.int64)
    return _with_fixups(
        lambda fix, cap: dll.dn_far_tables(
            nx, ny, nz,
            int(bool(periodic[0])), int(bool(periodic[1])),
            int(bool(periodic[2])),
            _ptr(offs, ctypes.c_int64), len(offs),
            _ptr(far_slots, ctypes.c_int64), len(far_slots),
            _ptr(far_rowidx, ctypes.c_int64),
            _ptr(row_of_pos0, ctypes.c_int32), _i32_ptr_or_null(owner0),
            np.int32(pad_row),
            _ptr(rows_t, ctypes.c_int32), _ptr(mask_t, ctypes.c_uint8),
            _ptr(fix, ctypes.c_int64), cap,
        ),
        1024 if owner0 is None else max(1024, len(far_slots) // 8))


def easy_tables(ei, ridx, sel, pos_all, valid_all, m, row_of_pos, owner,
                edev, pad_row, rows_t, mask_t):
    """Easy-row gather tables written straight into the caller's
    [n_rows, k] tables from the batched level-block lookup results.
    Returns the packed ``e * k + j`` cross-device fixup indices (none
    when ``owner`` is None), or None when the engine is unavailable."""
    dll = lib()
    if dll is None:
        return None
    ei = np.ascontiguousarray(ei, dtype=np.int64)
    ridx = np.ascontiguousarray(ridx, dtype=np.int64)
    sel = np.ascontiguousarray(sel, dtype=np.int64)
    return _with_fixups(
        lambda fix, cap: dll.dn_easy_tables(
            _ptr(ei, ctypes.c_int64), len(ei), _ptr(ridx, ctypes.c_int64),
            _ptr(sel, ctypes.c_int64), len(sel),
            _ptr(pos_all, ctypes.c_int32), _ptr(valid_all, ctypes.c_uint8),
            int(m),
            _ptr(row_of_pos, ctypes.c_int32), _i32_ptr_or_null(owner),
            _i32_ptr_or_null(edev),
            np.int32(pad_row),
            _ptr(rows_t, ctypes.c_int32), _ptr(mask_t, ctypes.c_uint8),
            _ptr(fix, ctypes.c_int64), cap,
        ),
        1024 if owner is None else max(1024, len(ei) // 4))


def hard_counts(s_p, owner, n_dev):
    """(n_groups, widest_group, per-device group counts) of the
    source-sorted hard entry stream, or None without the engine."""
    dll = lib()
    if dll is None:
        return None
    s_p = np.ascontiguousarray(s_p, dtype=np.int64)
    out = np.zeros(2 + n_dev, dtype=np.int64)
    dll.dn_hard_counts(_ptr(s_p, ctypes.c_int64), len(s_p),
                       _i32_ptr_or_null(owner), int(n_dev),
                       _ptr(out, ctypes.c_int64))
    return int(out[0]), int(out[1]), out[2:]


def hard_fill(s_p, s_n, s_off, owner, row_of_pos, n_dev, Hmax, S, row_pad,
              nbr_pad, rows_dev, nbr_dev, offs_dev, mask_dev):
    """Fused hard-table writer (grouping + scatter + pad in one pass).
    Returns the packed flat-nbr-table fixup indices (none when
    ``owner`` is None), or None without the engine."""
    dll = lib()
    if dll is None:
        return None
    s_p = np.ascontiguousarray(s_p, dtype=np.int64)
    s_n = np.ascontiguousarray(s_n, dtype=np.int64)
    s_off = np.ascontiguousarray(s_off, dtype=np.int64)
    return _with_fixups(
        lambda fix, cap: dll.dn_hard_fill(
            _ptr(s_p, ctypes.c_int64), _ptr(s_n, ctypes.c_int64),
            _ptr(s_off, ctypes.c_int64), len(s_p),
            _i32_ptr_or_null(owner), _ptr(row_of_pos, ctypes.c_int32),
            int(n_dev), int(Hmax), int(S),
            np.int32(row_pad), np.int32(nbr_pad),
            _ptr(rows_dev, ctypes.c_int32), _ptr(nbr_dev, ctypes.c_int32),
            _ptr(offs_dev, ctypes.c_int32), _ptr(mask_dev, ctypes.c_uint8),
            _ptr(fix, ctypes.c_int64), cap,
        ),
        1024 if owner is None else max(1024, len(s_p) // 8))


def stream_remap_merge(old2new, reus_old, prev_stream, fresh_stream):
    """Reuse-branch stream merge: remap the kept previous-epoch
    entries through ``old2new`` and merge with the fresh entries in
    one linear pass. Returns (spos, npos, off, item) or None without
    the engine."""
    dll = lib()
    if dll is None:
        return None
    ps, pn, po, pi = (np.ascontiguousarray(a, dtype=np.int64)
                      for a in prev_stream)
    fs, fn_, fo, fi = (np.ascontiguousarray(a, dtype=np.int64)
                       for a in fresh_stream)
    old2new = np.ascontiguousarray(old2new, dtype=np.int64)
    reus_old = np.ascontiguousarray(reus_old.view(np.uint8))
    cap = len(fs) + len(ps)
    ms = np.empty(cap, dtype=np.int64)
    mn = np.empty(cap, dtype=np.int64)
    mo = np.empty((cap, 3), dtype=np.int64)
    mi = np.empty(cap, dtype=np.int64)
    total = dll.dn_stream_remap_merge(
        _ptr(old2new, ctypes.c_int64), _ptr(reus_old, ctypes.c_uint8),
        _ptr(ps, ctypes.c_int64), _ptr(pn, ctypes.c_int64),
        _ptr(po, ctypes.c_int64), _ptr(pi, ctypes.c_int64), len(ps),
        _ptr(fs, ctypes.c_int64), _ptr(fn_, ctypes.c_int64),
        _ptr(fo, ctypes.c_int64), _ptr(fi, ctypes.c_int64), len(fs),
        _ptr(ms, ctypes.c_int64), _ptr(mn, ctypes.c_int64),
        _ptr(mo, ctypes.c_int64), _ptr(mi, ctypes.c_int64), cap,
    )
    if total > cap:  # cannot happen: kept entries <= len(ps)
        raise RuntimeError(f"stream merge wrote {total} > {cap} entries")
    return ms[:total], mn[:total], mo[:total], mi[:total]


def sfc_keys(indices, bits, kind):
    """Morton or Hilbert keys from (n,3) min-corner indices."""
    dll = _need()
    idx = np.ascontiguousarray(indices, dtype=np.uint64).reshape(-1, 3)
    out = np.empty(len(idx), dtype=np.uint64)
    fn = dll.dn_morton_keys if kind == "morton" else dll.dn_hilbert_keys
    fn(_ptr(idx, ctypes.c_uint64), len(idx), int(bits),
       _ptr(out, ctypes.c_uint64))
    return out
