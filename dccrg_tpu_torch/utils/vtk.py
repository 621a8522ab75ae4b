"""VTK output for visual inspection.

Port of ``dccrg_tpu/utils/vtk.py`` (the same bytes for the same state):
the reference dccrg's ``write_vtk_file`` (dccrg.hpp:3320-3392)
and the dc2vtk converters (examples/dc2vtk.cpp,
tests/advection/dc2vtk.cpp): an ASCII unstructured-grid dump of the
leaf cells, one hexahedron (VTK_VOXEL) per cell, with optional per-cell
scalar fields appended as CELL_DATA.
"""

from __future__ import annotations

import numpy as np


def _write_vtk(filename, cells, mins, maxs, scalar_fields, title,
               cell_data=None):
    """Core writer: cells as VTK_VOXELs + named per-cell scalars.
    ``cell_data`` forces the CELL_DATA/cell_id block even when every
    requested field was filtered out (vector fields)."""
    if cell_data is None:
        cell_data = bool(scalar_fields)
    n = len(cells)
    # 8 corners per cell in VTK_VOXEL order (x fastest, then y, then z)
    corners = np.empty((n, 8, 3))
    k = np.arange(8)
    cx = (k & 1).astype(bool)
    cy = ((k >> 1) & 1).astype(bool)
    cz = ((k >> 2) & 1).astype(bool)
    for d, flags in enumerate((cx, cy, cz)):
        corners[:, :, d] = np.where(flags[None, :], maxs[:, d : d + 1], mins[:, d : d + 1])

    with open(filename, "w") as f:
        f.write("# vtk DataFile Version 2.0\n")
        f.write(f"{title}\n")
        f.write("ASCII\nDATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {8 * n} float\n")
        np.savetxt(f, corners.reshape(-1, 3), fmt="%.9g")
        f.write(f"CELLS {n} {9 * n}\n")
        conn = np.column_stack(
            [np.full(n, 8, dtype=np.int64), np.arange(8 * n).reshape(n, 8)]
        )
        np.savetxt(f, conn, fmt="%d")
        f.write(f"CELL_TYPES {n}\n")
        np.savetxt(f, np.full(n, 11, dtype=np.int64), fmt="%d")  # VTK_VOXEL

        if cell_data:
            f.write(f"CELL_DATA {n}\n")
            # cell ids first, like the reference's dc2vtk output
            f.write("SCALARS cell_id double 1\nLOOKUP_TABLE default\n")
            np.savetxt(f, cells.astype(np.float64), fmt="%.9g")
            for name, vals in scalar_fields:
                vals = np.asarray(vals, dtype=np.float64).reshape(n, -1)
                if vals.shape[1] != 1:
                    continue  # only scalar fields in v1
                f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                np.savetxt(f, vals[:, 0], fmt="%.9g")


def write_vtk_file(grid, filename: str, fields=None, title: str = "dccrg_tpu") -> None:
    """Write all cells (the reference writes each rank's local cells to
    its own file; host code here sees every partition), so a grid on n
    partitions writes the bytes of the same grid on one."""
    cells = grid.get_cells()
    mins = grid.geometry.get_min(cells)
    maxs = grid.geometry.get_max(cells)
    names = list(fields) if fields else []
    scalars = [(name, grid.get(name, cells)) for name in names]
    _write_vtk(filename, cells, mins, maxs, scalars, title,
               cell_data=bool(names))


def dc_to_vtk(dc_filename: str, vtk_filename: str, fields,
              header_size: int = 0, title: str = "dccrg_tpu") -> np.ndarray:
    """Standalone .dc -> .vtk converter: parses a checkpoint file
    written by ``save_grid_data`` (of either package) without a live grid (the reference's
    dc2vtk programs, examples/dc2vtk.cpp and tests/advection/dc2vtk.cpp,
    each knowing their app's cell layout).

    ``fields`` is the saved grid's field spec ``{name: (shape, dtype)}``
    — the same role as the per-app cell struct in the reference's
    converters. Returns the cell ids written.
    """
    from ..checkpoint import _payload_spec_of, parse_metadata

    with open(dc_filename, "rb") as f:
        data = f.read()

    _, _, _, geometry, cells, offsets, _ = parse_metadata(data, header_size)
    offsets = offsets.astype(np.int64)
    spec, _, _ = _payload_spec_of(fields)

    # gather only the scalar columns (skip vector fields the converter
    # doesn't plot) — avoids materializing the full payload matrix
    raw = np.frombuffer(data, dtype=np.uint8)
    scalars = []
    col = 0
    for name, shape, dtype, nbytes in spec:
        n_lanes = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if n_lanes == 1:
            idx = offsets[:, None] + (col + np.arange(nbytes, dtype=np.int64))[None, :]
            vals = raw[idx].copy().view(dtype).reshape(len(cells))
            scalars.append((name, vals))
        col += nbytes

    mins = geometry.get_min(cells)
    maxs = geometry.get_max(cells)
    _write_vtk(vtk_filename, cells, mins, maxs, scalars, title,
               cell_data=bool(spec))
    return cells


def _parse_field_spec(spec_strs):
    """CLI field specs: ``name:dtype`` or ``name:dtype:d0xd1`` (e.g.
    ``density:float32`` or ``pos:float32:16x3``)."""
    fields = {}
    for s in spec_strs:
        parts = s.split(":")
        if len(parts) == 2:
            name, dt = parts
            fields[name] = ((), np.dtype(dt))
        elif len(parts) == 3:
            name, dt, shp = parts
            shape = tuple(int(v) for v in shp.split("x"))
            fields[name] = (shape, np.dtype(dt))
        else:
            raise SystemExit(f"bad field spec {s!r}: use name:dtype[:d0xd1]")
    return fields


def main(argv=None):
    """``python -m dccrg_tpu_torch.utils.vtk``: the reference's dc2vtk
    converters (examples/dc2vtk.cpp, tests/advection/dc2vtk.cpp) as one
    CLI taking the field schema on the command line."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert a .dc checkpoint to an unstructured-grid "
        ".vtk file (scalar fields only)")
    ap.add_argument("dc_file")
    ap.add_argument("vtk_file")
    ap.add_argument("--field", action="append", required=True,
                    dest="fields", metavar="NAME:DTYPE[:SHAPE]",
                    help="cell field, repeatable, in the saved schema")
    ap.add_argument("--header-size", type=int, default=0)
    ap.add_argument("--title", default="dccrg_tpu grid")
    args = ap.parse_args(argv)
    cells = dc_to_vtk(args.dc_file, args.vtk_file,
                      _parse_field_spec(args.fields),
                      header_size=args.header_size, title=args.title)
    print(f"wrote {args.vtk_file}: {len(cells)} cells")


if __name__ == "__main__":
    main()
