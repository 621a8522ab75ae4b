"""Dense fast path for uniform (refinement-level-0) grids.

Port of ``dccrg_tpu/dense.py``: fields are dense ``[nx, ny, nz, ...]``
tensors split into the blocks of a 3-D mesh (``dense_mesh``), and a
stencil step runs once per block on that block padded with a halo. The
reference shards the arrays over a device mesh and fills the halos with
``lax.ppermute`` slab sends inside ``shard_map``; here every block of
the mesh lives on one card, the halo is filled by explicit copies of
the neighbour blocks' face slabs (the periodic wrap, or the ``boundary``
value on a non-periodic edge), and ``DenseGrid.axis_index`` tells a step
function which block it is running on. Blocks on distinct cards, with
the slab copies between them made peer copies, wait for ROADMAP.md
queue 1, item 5b.1b: a mesh naming distinct devices raises
``NotImplementedError``.

Cell ids remain interoperable with ``Grid``/``Mapping``: the cell at
dense index (i, j, k) is level-0 cell ``1 + i + j*nx + k*nx*ny``
(dccrg_mapping.hpp:154-209).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from . import telemetry
from .grid import as_torch_dtype, resolve_partitions

AXES = ("x", "y", "z")

# extra_specs entries of DenseGrid.make_step: an extra split into the
# mesh's blocks (the reference's ``P(*AXES)``) or passed whole (``P()``)
BLOCKS = "blocks"
WHOLE = "whole"


class DenseMesh:
    """A 3-D mesh of blocks, axes ``("x", "y", "z")``, every block on
    the same device (the counterpart of the reference's ``Mesh``)."""

    def __init__(self, devices, shape):
        self.devices = list(devices)
        self.device = self.devices[0]
        self.axis_names = AXES
        self.shape = tuple(int(s) for s in shape)

    def __repr__(self):
        return f"DenseMesh(shape={self.shape}, device={self.device})"


def dense_mesh(devices=None, shape=None) -> DenseMesh:
    """3-D mesh over the given devices (one block each; one block on
    the card when None), laid out along x unless ``shape=(px, py, pz)``
    factors it. Every entry may name the same device, as
    ``Grid.initialize`` takes partitions; distinct devices raise
    ``NotImplementedError`` (ROADMAP.md queue 1, item 5b.1b)."""
    devs = resolve_partitions(list(devices) if devices is not None else None)
    n = len(devs)
    if shape is None:
        shape = (n, 1, 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover {n} devices")
    return DenseMesh(devs, shape)


class DenseGrid:
    """Uniform Cartesian grid with dense storage, split into the blocks
    of a mesh.

    Parameters
    ----------
    length : (nx, ny, nz) level-0 cell counts; each must be divisible
        by the mesh extent along its axis.
    fields : dict name -> dtype (scalar per cell) or (shape, dtype).
    device : the device (one block), or a list of n entries naming one
        device (an ``(n, 1, 1)`` mesh); ``"cuda"`` when None.
    periodic : per-dimension wrap, as GridTopology.
    start / cell_length : Cartesian geometry parameters
        (dccrg_cartesian_geometry.hpp:51-88).
    mesh : a ``dense_mesh`` (instead of ``device``).
    """

    def __init__(
        self,
        length,
        fields,
        device=None,
        periodic=(False, False, False),
        start=(0.0, 0.0, 0.0),
        cell_length=None,
        mesh: DenseMesh | None = None,
    ):
        if mesh is not None and device is not None:
            raise ValueError("give DenseGrid a device or a mesh, not both")
        if mesh is None:
            mesh = dense_mesh(device if isinstance(device, (list, tuple))
                              else [device])
        if tuple(mesh.axis_names) != AXES:
            raise ValueError(f"DenseGrid needs a mesh with axes {AXES}")
        self.mesh = mesh
        self.device = mesh.device
        self.length = tuple(int(v) for v in length)
        self.periodic = tuple(bool(p) for p in periodic)
        self.mesh_shape = tuple(mesh.shape)
        for d in range(3):
            if self.length[d] % self.mesh_shape[d] != 0:
                raise ValueError(
                    f"grid length {self.length[d]} not divisible by mesh "
                    f"extent {self.mesh_shape[d]} along {AXES[d]}"
                )
        self.block = tuple(self.length[d] // self.mesh_shape[d] for d in range(3))
        # block positions in mesh order (x slowest, as the reference's
        # device array reshaped to the mesh shape)
        self.positions = list(itertools.product(*(range(m) for m in self.mesh_shape)))
        self._running = None  # mesh position of the block a step runs on
        self.start = np.asarray(start, dtype=np.float64)
        if cell_length is None:
            cell_length = tuple(1.0 / self.length[d] for d in range(3))
        self.cell_length = np.asarray(cell_length, dtype=np.float64)

        self.fields = {}
        self.arrays = {}
        for name, spec in fields.items():
            if isinstance(spec, tuple):
                shape, dtype = spec
            else:
                shape, dtype = (), spec
            dtype = as_torch_dtype(dtype)
            self.fields[name] = (tuple(shape), dtype)
            self.arrays[name] = torch.zeros(self.length + tuple(shape),
                                            dtype=dtype, device=self.device)

    @property
    def n_cells(self) -> int:
        return self.length[0] * self.length[1] * self.length[2]

    def axis_index(self, axis: str) -> int:
        """Mesh position, along ``axis``, of the block whose step
        function is running (the counterpart of ``lax.axis_index`` inside
        the reference's ``shard_map``)."""
        if self._running is None:
            raise RuntimeError("axis_index is only defined inside a step")
        return self._running[AXES.index(axis)]

    # -- coordinates ---------------------------------------------------

    def cell_centers(self, dim: int) -> torch.Tensor:
        """1-D float64 tensor of cell-center coordinates along ``dim``."""
        return torch.as_tensor(
            self.start[dim] + (np.arange(self.length[dim]) + 0.5) * self.cell_length[dim],
            device=self.device,
        )

    def init_fields(self, fn) -> None:
        """Set fields from ``fn(x, y, z) -> dict`` evaluated on cell
        centers (broadcast 3-D tensors)."""
        x = self.cell_centers(0)[:, None, None]
        y = self.cell_centers(1)[None, :, None]
        z = self.cell_centers(2)[None, None, :]
        vals = fn(x, y, z)
        for name, v in vals.items():
            shape, dtype = self.fields[name]
            v = torch.as_tensor(v, device=self.device)
            self.arrays[name] = torch.broadcast_to(
                v, self.length + shape).to(dtype).contiguous()

    # -- blocks --------------------------------------------------------

    def _split(self, t: torch.Tensor, ext=None):
        """Views of ``t``'s blocks in mesh order; ``ext`` is the block
        extent per axis (the tensor's extent over the mesh's when None)."""
        if ext is None:
            ext = tuple(t.shape[d] // self.mesh_shape[d] for d in range(3))
        return [t[tuple(slice(p[d] * ext[d], (p[d] + 1) * ext[d])
                        for d in range(3))] for p in self.positions]

    def _assemble(self, blocks):
        """One tensor from blocks in mesh order (the inverse of _split)."""
        if len(blocks) == 1:
            return blocks[0]
        ext = tuple(blocks[0].shape[:3])
        out = blocks[0].new_empty(tuple(ext[d] * self.mesh_shape[d] for d in range(3))
                                  + tuple(blocks[0].shape[3:]))
        for view, b in zip(self._split(out, ext), blocks):
            view.copy_(b)
        return out

    def _neighbor(self, b: int, d: int, step: int):
        """Index of block ``b``'s neighbour one step along axis ``d`` (the
        periodic wrap included), or None past a non-periodic edge."""
        pos = list(self.positions[b])
        n = self.mesh_shape[d]
        pos[d] += step
        if not 0 <= pos[d] < n:
            if not self.periodic[d]:
                return None
            pos[d] %= n
        i = 0
        for dd in range(3):
            i = i * self.mesh_shape[dd] + pos[dd]
        return i

    # -- halo padding (the ghost-slab exchange) --------------------------

    def _padded_blocks(self, t: torch.Tensor, halo: int, boundary: float = 0.0):
        """Every block of ``t`` padded with ``halo`` cells per side: the
        counterpart of the reference's ``pad_with_halo`` inside
        ``shard_map`` (dense.py:127-161). Each block's halo along axis d
        is copied from its mesh neighbours' face slabs (the block's own
        on an axis of one block), axis by axis, so an edge or corner
        halo comes from the neighbour's already padded slab as the
        reference's successive concatenations give it; past a
        non-periodic edge the halo holds ``boundary``."""
        h = halo
        blocks = self._split(t)
        ext = tuple(blocks[0].shape[:3])
        with telemetry.span("dense.exchange"):
            padded = []
            for blk in blocks:
                p = blk.new_empty(tuple(e + 2 * h for e in ext) + tuple(blk.shape[3:]))
                p[h:h + ext[0], h:h + ext[1], h:h + ext[2]] = blk
                padded.append(p)
            for d in range(3):
                # the slabs of axis d span the padded extent of the axes
                # before it and the block extent of the axes after it
                span = tuple(slice(None) if dd < d else slice(h, h + ext[dd])
                             for dd in range(3))

                def at(lo, hi):
                    return tuple(slice(lo, hi) if dd == d else span[dd]
                                 for dd in range(3))

                for b, p in enumerate(padded):
                    lo_nbr = self._neighbor(b, d, -1)
                    hi_nbr = self._neighbor(b, d, +1)
                    if lo_nbr is None:
                        p[at(0, h)] = boundary
                    else:  # my low halo: the low neighbour's high slab
                        p[at(0, h)] = padded[lo_nbr][at(ext[d], ext[d] + h)]
                    if hi_nbr is None:
                        p[at(ext[d] + h, ext[d] + 2 * h)] = boundary
                    else:
                        p[at(ext[d] + h, ext[d] + 2 * h)] = padded[hi_nbr][at(h, 2 * h)]
        return padded

    def pad_with_halo(self, t: torch.Tensor, halo: int, boundary: float = 0.0):
        """``t`` (``[nx, ny, nz, ...]``) with every block padded by
        ``halo`` cells, the padded blocks laid side by side: the array
        the reference's ``shard_map(pad_with_halo)`` returns
        (``[nx + 2h px, ny + 2h py, nz + 2h pz, ...]``; the padded array
        itself on a mesh of one block)."""
        return self._assemble(self._padded_blocks(t, halo, boundary))

    def exchange_bytes(self, halo: int = 1, fields=None) -> int:
        """Bytes one halo pad of ``fields`` (every field when None)
        copies between distinct blocks, counted as the partitioned
        grid's exchange counts its sends: each slab a block receives
        from another block (not its own wrap, not a boundary fill)."""
        names = tuple(fields) if fields is not None else tuple(self.fields)
        ext = self.block
        per_cell = 0
        for n in names:
            shape, dtype = self.fields[n]
            per_cell += int(np.prod(shape, dtype=np.int64)) * \
                torch.empty((), dtype=dtype).element_size()
        cells = 0
        for d in range(3):
            if self.mesh_shape[d] == 1:
                continue
            face = halo
            for dd in range(3):
                if dd != d:
                    face *= ext[dd] + (2 * halo if dd < d else 0)
            for b in range(len(self.positions)):
                for step in (-1, 1):
                    if self._neighbor(b, d, step) is not None:
                        cells += face
        return cells * per_cell

    # -- stencil driver ------------------------------------------------

    def make_step(self, fn, fields_in, fields_out, halo: int = 1, boundary=0.0,
                  extra_specs=()):
        """Wrap ``fn`` into a step over the mesh's blocks.

        ``fn(blocks: dict, *extra) -> dict`` receives halo-padded blocks
        ``[bx+2h, by+2h, bz+2h, ...]`` for every name in ``fields_in``
        and must return interior updates ``[bx, by, bz, ...]`` for every
        name in ``fields_out``; it may call :meth:`axis_index`. An extra
        whose ``extra_specs`` entry is ``BLOCKS`` is split into the
        mesh's blocks (a tensor split evenly along x, y and z, or a list
        of one tensor per block in mesh order); ``WHOLE`` extras, and
        those past the end of ``extra_specs``, are passed whole.
        Returns ``step(arrays: dict, *extra) -> dict``, a new dict with
        the outputs replaced.
        """
        fields_in = tuple(fields_in)
        fields_out = tuple(fields_out)
        specs = tuple(extra_specs)
        for s in specs:
            if s not in (BLOCKS, WHOLE):
                raise ValueError(f"extra spec {s!r} is neither BLOCKS nor WHOLE")

        def step(arrays, *extra):
            padded = {n: self._padded_blocks(arrays[n], halo, boundary)
                      for n in fields_in}
            split = []
            for i, e in enumerate(extra):
                if i < len(specs) and specs[i] == BLOCKS:
                    split.append(list(e) if isinstance(e, (list, tuple))
                                 else self._split(e))
                else:
                    split.append(None)
            results = {n: [] for n in fields_out}
            for b, pos in enumerate(self.positions):
                ex = tuple(e if s is None else s[b] for e, s in zip(extra, split))
                self._running = pos
                try:
                    res = fn({n: padded[n][b] for n in fields_in}, *ex)
                finally:
                    self._running = None
                for n in fields_out:
                    results[n].append(res[n])
            out = dict(arrays)
            for n in fields_out:
                out[n] = self._assemble(results[n])
            return out

        return step

    # -- interop with the id-addressed world ---------------------------

    def cell_id_of_index(self, i, j, k):
        """Level-0 cell id at dense index (dccrg_mapping.hpp:154-209)."""
        nx, ny = self.length[0], self.length[1]
        return 1 + np.uint64(i) + np.uint64(j) * nx + np.uint64(k) * nx * ny

    def to_host(self, name: str) -> np.ndarray:
        t = self.arrays[name].detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
