"""Dense fast path for uniform (refinement-level-0) grids.

Port of ``dccrg_tpu/dense.py``: fields are dense ``[nx, ny, nz, ...]``
tensors split into the blocks of a 3-D mesh (``dense_mesh``), and a
stencil step runs once per block on that block padded with a halo. The
reference shards the arrays over a device mesh and fills the halos with
``lax.ppermute`` slab sends inside ``shard_map``; here the halo is
filled by explicit copies of the neighbour blocks' face slabs (the
periodic wrap, or the ``boundary`` value on a non-periodic edge), and
``DenseGrid.axis_index`` tells a step function which block it is
running on.

A mesh's blocks live on one card in one process (a field is the whole
``[nx, ny, nz, ...]`` tensor), or on the ranks of a
``torch.distributed`` group: ``dense_mesh`` takes ``(rank, device)``
entries (``coord.rank_devices``) as ``Grid.initialize`` does, each rank
holds only its own blocks (a field is ``[n_held, bx, by, bz, ...]``,
the held blocks in mesh order), and a slab whose neighbour block is
another rank's crosses by ``comm.post_exchange`` / ``wait_exchange``:
one packed buffer per peer rank per axis, counted under the ``slab``
leg of ``dccrg_rank_bytes_total``. The sums every rank reads
(:meth:`DenseGrid.total`, :meth:`DenseGrid.dot`) are
``comm.exact_sum``: the same bits on any split into blocks or ranks.
A mesh naming distinct devices of one process (``dense_mesh(["cuda:0",
"cpu"])``, or ``cpu:k`` labels on the host) puts each block on its own
device: a field is a ``grid.Grouped`` of one ``[n_g, bx, by, bz, ...]``
tensor per device, the held blocks in mesh order, and a slab between
blocks on distinct devices is copied into a buffer on the receiver's
device (``comm.device_copy``, leg ``device_slab``). Whole-grid tensors
(the centres, an ``rhs``, ``to_host``) are staged on the host there.
The same holds for one rank's blocks of a rank placement
(``[(0, "cuda:0"), (0, "cpu"), (1, "cuda:0"), (1, "cpu")]``): its
slabs to and from other ranks are staged on the host.

Cell ids remain interoperable with ``Grid``/``Mapping``: the cell at
dense index (i, j, k) is level-0 cell ``1 + i + j*nx + k*nx*ny``
(dccrg_mapping.hpp:154-209).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from . import comm, telemetry
from .grid import (Grouped, _to_device, as_torch_dtype, device_key,
                   group_devices, resolve_placement, spans_devices)

AXES = ("x", "y", "z")

# extra_specs entries of DenseGrid.make_step: an extra split into the
# mesh's blocks (the reference's ``P(*AXES)``) or passed whole (``P()``)
BLOCKS = "blocks"
WHOLE = "whole"


class DenseMesh:
    """A 3-D mesh of blocks, axes ``("x", "y", "z")`` (the counterpart
    of the reference's ``Mesh``). ``ranks`` is None when every block is
    this process's, else block b's rank in the default process group;
    ``held`` lists this process's blocks in mesh order. When the held
    blocks name distinct devices (``spans_devices``) ``groups`` lists
    ``(device, held slots)`` per device in order of first appearance,
    ``where`` each held slot's ``(group, index)``, and ``device`` is the
    host, where whole-grid tensors are staged."""

    def __init__(self, devices, shape, ranks=None):
        self.devices = list(devices)
        self.axis_names = AXES
        self.shape = tuple(int(s) for s in shape)
        self.ranks = ranks
        if ranks is None:
            self.held = np.arange(len(self.devices), dtype=np.int64)
        else:
            from . import coord

            self.held = np.flatnonzero(
                ranks == coord.process_index()).astype(np.int64)
        self.spans_devices = spans_devices(
            [self.devices[int(b)] for b in self.held])
        self.groups, self.where = group_devices(
            [self.devices[int(b)] for b in self.held])
        self.device = (torch.device("cpu") if self.spans_devices
                       else self.devices[int(self.held[0])])

    def __repr__(self):
        return f"DenseMesh(shape={self.shape}, device={self.device})"


def dense_mesh(devices=None, shape=None) -> DenseMesh:
    """3-D mesh over the given devices (one block each; one block on
    the card when None), laid out along x unless ``shape=(px, py, pz)``
    factors it; block b sits at the b-th position in C order, as the
    reference reshapes its device array. Every entry may name the same
    device, as ``Grid.initialize`` takes partitions, or a block of a
    rank as ``(rank, device)`` (``coord.rank_devices``; every rank
    passes the same list and holds its own blocks). Distinct devices of
    one process, or of one rank's entries, put each block on its own
    device."""
    devs, ranks = resolve_placement(list(devices) if devices is not None
                                    else None)
    n = len(devs)
    if shape is None:
        shape = (n, 1, 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover {n} devices")
    return DenseMesh(devs, shape, ranks)


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

    On a mesh placed on ranks a field is ``[n_held, bx, by, bz, ...]``:
    this rank's blocks (``held``) in mesh order. :meth:`hold` turns a
    whole-grid tensor into this process's layout.
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
        self.held = mesh.held
        self._ranks = mesh.ranks
        self._spans = mesh.spans_devices
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

        lead = ((len(self.held),) + self.block if self._rank_held
                else self.length)
        self.fields = {}
        self.arrays = {}
        for name, spec in fields.items():
            if isinstance(spec, tuple):
                shape, dtype = spec
            else:
                shape, dtype = (), spec
            dtype = as_torch_dtype(dtype)
            self.fields[name] = (tuple(shape), dtype)
            if self._spans:
                self.arrays[name] = self._grouped(
                    [torch.zeros((len(sl),) + self.block + tuple(shape),
                                 dtype=dtype, device=d)
                     for d, sl in mesh.groups])
            else:
                self.arrays[name] = torch.zeros(lead + tuple(shape),
                                                dtype=dtype,
                                                device=self.device)

    @property
    def _rank_held(self) -> bool:
        """True when the blocks are placed on the ranks of a process
        group, each rank holding only its own."""
        return self._ranks is not None

    def _grouped(self, tensors) -> Grouped:
        return Grouped(tensors, [d for d, _sl in self.mesh.groups],
                       self.mesh.where)

    def _block_device(self, b: int):
        """The device block ``b`` (a held one) lives on."""
        return self.mesh.devices[int(b)]

    @property
    def _blocked(self) -> bool:
        """True when a field is held block by block
        (``[n_held, bx, by, bz, ...]``, or a Grouped of such stacks):
        on ranks, or on distinct devices."""
        return self._rank_held or self._spans

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
        """1-D float64 tensor of cell-center coordinates along ``dim``
        (the whole grid's)."""
        return torch.as_tensor(
            self.start[dim] + (np.arange(self.length[dim]) + 0.5) * self.cell_length[dim],
            device=self.device,
        )

    def init_fields(self, fn) -> None:
        """Set fields from ``fn(x, y, z) -> dict`` evaluated on cell
        centers (broadcast 3-D tensors). On ranks ``fn`` sees the whole
        grid's centres, as one process does, and each rank keeps its
        blocks: the same values bit for bit."""
        x = self.cell_centers(0)[:, None, None]
        y = self.cell_centers(1)[None, :, None]
        z = self.cell_centers(2)[None, None, :]
        vals = fn(x, y, z)
        for name, v in vals.items():
            shape, dtype = self.fields[name]
            v = torch.broadcast_to(torch.as_tensor(v, device=self.device),
                                   self.length + shape)
            self.arrays[name] = self.hold(v).to(dtype).contiguous()

    # -- blocks --------------------------------------------------------

    def _whole_blocks(self, t: torch.Tensor, ext=None):
        """Views of the held blocks of a whole-grid tensor ``t``; ``ext``
        is the block extent per axis (the tensor's extent over the
        mesh's when None)."""
        if ext is None:
            ext = tuple(t.shape[d] // self.mesh_shape[d] for d in range(3))
        return [t[tuple(slice(p[d] * ext[d], (p[d] + 1) * ext[d])
                        for d in range(3))]
                for p in (self.positions[b] for b in self.held)]

    def hold(self, t) -> torch.Tensor:
        """A whole-grid tensor (or array) in this process's layout, on
        the grid's device: itself in one process, the stack of this
        rank's blocks on a mesh placed on ranks."""
        t = torch.as_tensor(t, device=self.device)
        if self._spans:
            return self._assemble(self._whole_blocks(t))
        if not self._rank_held:
            return t
        return torch.stack(self._whole_blocks(t))

    def _split(self, t: torch.Tensor, ext=None):
        """The held blocks of ``t`` (this process's layout) in mesh
        order; ``ext`` is the block extent per axis of a whole tensor."""
        if self._blocked:
            return [t[i] for i in range(len(self.held))]
        return self._whole_blocks(t, ext)

    def _assemble(self, blocks):
        """One tensor in this process's layout from the held blocks (the
        inverse of _split)."""
        if self._spans:
            # each device's blocks stacked there (a block made on the
            # host is copied to its device)
            return self._grouped([
                _to_device(torch.stack([blocks[i] for i in sl]), d)
                if device_key(blocks[sl[0]].device) != device_key(d)
                else torch.stack([blocks[i] for i in sl])
                for d, sl in self.mesh.groups])
        if self._rank_held:
            return torch.stack(blocks)
        if len(blocks) == 1:
            return blocks[0]
        ext = tuple(blocks[0].shape[:3])
        out = blocks[0].new_empty(tuple(ext[d] * self.mesh_shape[d] for d in range(3))
                                  + tuple(blocks[0].shape[3:]))
        for view, b in zip(self._whole_blocks(out, ext), blocks):
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

    def _rank_of(self, b: int) -> int:
        return 0 if self._ranks is None else int(self._ranks[b])

    # -- halo padding (the ghost-slab exchange) --------------------------

    def _padded_blocks(self, t: torch.Tensor, halo: int, boundary: float = 0.0):
        """Every held block of ``t`` padded with ``halo`` cells per side
        (:meth:`_padded_many` of one tensor)."""
        return self._padded_many([t], halo, boundary)[0]

    def _padded_many(self, tensors, halo: int, boundary: float = 0.0):
        """The held blocks of each tensor padded with ``halo`` cells per
        side: the counterpart of the reference's ``pad_with_halo`` inside
        ``shard_map`` (dense.py:127-161). Each block's halo along axis d
        is copied from its mesh neighbours' face slabs (the block's own
        on an axis of one block), axis by axis, so an edge or corner
        halo comes from the neighbour's already padded slab as the
        reference's successive concatenations give it; past a
        non-periodic edge the halo holds ``boundary``. A slab from
        another rank's block crosses in that axis's one exchange with
        each peer rank, every tensor's slabs packed in one buffer."""
        h = halo
        slot = {int(b): i for i, b in enumerate(self.held)}
        me = self._rank_of(int(self.held[0]))
        padded, exts = [], []
        for t in tensors:
            blocks = self._split(t)
            ext = tuple(blocks[0].shape[:3])
            ps = []
            for blk in blocks:
                p = blk.new_empty(tuple(e + 2 * h for e in ext)
                                  + tuple(blk.shape[3:]))
                p[h:h + ext[0], h:h + ext[1], h:h + ext[2]] = blk
                ps.append(p)
            padded.append(ps)
            exts.append(ext)
        with telemetry.span("dense.exchange"):
            for d in range(3):
                def at(ext, lo, hi):
                    # the slabs of axis d span the padded extent of the
                    # axes before it and the block extent of the axes
                    # after it
                    return tuple(slice(lo, hi) if dd == d
                                 else slice(None) if dd < d
                                 else slice(h, h + ext[dd])
                                 for dd in range(3))

                def halo_of(ext, side):  # where block b receives
                    return (at(ext, 0, h) if side < 0
                            else at(ext, ext[d] + h, ext[d] + 2 * h))

                def slab_of(ext, side):  # what the neighbour sends
                    return (at(ext, ext[d], ext[d] + h) if side < 0
                            else at(ext, h, 2 * h))

                sends, recvs = {}, {}
                for b in range(len(self.positions)):
                    for side in (-1, 1):
                        nb = self._neighbor(b, d, side)
                        if nb is None:
                            if b in slot:
                                for ps, ext in zip(padded, exts):
                                    ps[slot[b]][halo_of(ext, side)] = boundary
                            continue
                        rb, rn = self._rank_of(b), self._rank_of(nb)
                        if rb == rn == me and self._spans and device_key(
                                self._block_device(b)) != device_key(
                                self._block_device(nb)):
                            # blocks on distinct devices: the slabs of
                            # every tensor in one buffer, copied to the
                            # receiver's device
                            got = comm.unpack(comm.device_copy(
                                comm.pack([ps[slot[nb]][slab_of(ext, side)]
                                           for ps, ext in zip(padded, exts)]),
                                self._block_device(b), leg="device_slab"),
                                [(tuple(ps[slot[nb]][slab_of(ext, side)]
                                        .shape), ps[0].dtype)
                                 for ps, ext in zip(padded, exts)])
                            for ps, ext, v in zip(padded, exts, got):
                                ps[slot[b]][halo_of(ext, side)] = v
                        elif rb == rn == me:
                            for ps, ext in zip(padded, exts):
                                ps[slot[b]][halo_of(ext, side)] = \
                                    ps[slot[nb]][slab_of(ext, side)]
                        elif rn == me:
                            sends.setdefault(rb, []).extend(
                                ps[slot[nb]][slab_of(ext, side)]
                                for ps, ext in zip(padded, exts))
                        elif rb == me:
                            recvs.setdefault(rn, []).append((b, side))
                if sends or recvs:
                    self._cross_slabs(d, padded, exts, sends, recvs,
                                      slot, halo_of)
        return padded

    def _cross_slabs(self, d, padded, exts, sends, recvs, slot, halo_of):
        """One axis's slabs between ranks: one packed buffer to and from
        each peer rank, in the order every rank enumerates the mesh's
        (block, side) pairs, packed and received on the grid's device
        (the host when this rank's blocks span devices)."""
        specs = {}
        for r, pairs in recvs.items():
            specs[r] = [(tuple(ps[slot[b]][halo_of(ext, side)].shape),
                         ps[0].dtype)
                        for b, side in pairs for ps, ext in zip(padded, exts)]
        sizes = {r: sum(int(np.prod(s, dtype=np.int64))
                        * torch.empty((), dtype=dt).element_size()
                        for s, dt in sp) for r, sp in specs.items()}
        if self._spans:
            sends = {r: [_to_device(x, self.device) for x in v]
                     for r, v in sends.items()}
        posted = comm.post_exchange(
            {r: comm.pack(v) for r, v in sends.items()}, sizes, self.device,
            leg="slab")
        got = comm.wait_exchange(posted)
        for r, pairs in recvs.items():
            vals = iter(comm.unpack(got[r], specs[r]))
            for b, side in pairs:
                for ps, ext in zip(padded, exts):
                    ps[slot[b]][halo_of(ext, side)] = next(vals)

    def pad_with_halo(self, t: torch.Tensor, halo: int, boundary: float = 0.0):
        """``t`` with every block padded by ``halo`` cells: the array
        the reference's ``shard_map(pad_with_halo)`` returns
        (``[nx + 2h px, ny + 2h py, nz + 2h pz, ...]``, the padded blocks
        laid side by side; the padded array itself on a mesh of one
        block). On ranks, this rank's padded blocks stacked."""
        return self._assemble(self._padded_blocks(t, halo, boundary))

    def exchange_bytes(self, halo: int = 1, fields=None,
                       cross_rank: bool = False) -> int:
        """Bytes one halo pad of ``fields`` (every field when None)
        copies into this process's blocks from distinct blocks, counted
        as the partitioned grid's exchange counts its sends: each slab a
        block receives from another block (not its own wrap, not a
        boundary fill). On ranks each rank counts its own blocks (the
        ranks' counts add up to one process's); ``cross_rank`` counts
        only the slabs from another rank's blocks."""
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
            for b in self.held:
                for step in (-1, 1):
                    nb = self._neighbor(int(b), d, step)
                    if nb is not None and not (
                            cross_rank
                            and self._rank_of(nb) == self._rank_of(int(b))):
                        cells += face
        return cells * per_cell

    # -- reductions every rank reads -------------------------------------

    def total(self, t: torch.Tensor) -> float:
        """The float64 sum of every element of ``t`` (this process's
        layout) over every block, reduced over the ranks on a placement:
        ``comm.exact_sum``, the same bits on any mesh or split."""
        xs = list(t.groups) if isinstance(t, Grouped) else [t]
        count = (sum(x.numel() for x in xs) * len(self.positions)
                 // len(self.held))
        return comm.exact_sum(xs, count, self._rank_held)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> float:
        """``sum(a * b)`` over every block (:meth:`total` of the float64
        products; a float32 product is exact there)."""
        return self.total(a.to(torch.float64) * b.to(torch.float64))

    def minimum(self, t: torch.Tensor) -> torch.Tensor:
        """The least element of ``t`` over every block, device and rank
        (``comm.group_extreme``)."""
        return comm.group_extreme(t, "min", self._rank_held)

    # -- stencil driver ------------------------------------------------

    def make_step(self, fn, fields_in, fields_out, halo: int = 1, boundary=0.0,
                  extra_specs=()):
        """Wrap ``fn`` into a step over the mesh's blocks.

        ``fn(blocks: dict, *extra) -> dict`` receives halo-padded blocks
        ``[bx+2h, by+2h, bz+2h, ...]`` for every name in ``fields_in``
        and must return interior updates ``[bx, by, bz, ...]`` for every
        name in ``fields_out``; it may call :meth:`axis_index`. An extra
        whose ``extra_specs`` entry is ``BLOCKS`` is split into the
        mesh's blocks (a tensor in this process's layout, split evenly
        along x, y and z in one process, or a list of one tensor per
        held block in mesh order); ``WHOLE`` extras, and those past the
        end of ``extra_specs``, are passed whole. Returns
        ``step(arrays: dict, *extra) -> dict``, a new dict with the
        outputs replaced.
        """
        fields_in = tuple(fields_in)
        fields_out = tuple(fields_out)
        specs = tuple(extra_specs)
        for s in specs:
            if s not in (BLOCKS, WHOLE):
                raise ValueError(f"extra spec {s!r} is neither BLOCKS nor WHOLE")

        def step(arrays, *extra):
            padded = dict(zip(fields_in, self._padded_many(
                [arrays[n] for n in fields_in], halo, boundary)))
            split = []
            for i, e in enumerate(extra):
                if i < len(specs) and specs[i] == BLOCKS:
                    split.append(list(e) if isinstance(e, (list, tuple))
                                 else self._split(e))
                else:
                    split.append(None)
            results = {n: [] for n in fields_out}
            for i, b in enumerate(self.held):
                ex = tuple(e if s is None else s[i] for e, s in zip(extra, split))
                self._running = self.positions[int(b)]
                try:
                    res = fn({n: padded[n][i] for n in fields_in}, *ex)
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
        """The whole field on the host. On a mesh placed on ranks no
        process holds it, and this raises, as the reference's
        ``np.asarray`` of an array that is not fully addressable does."""
        if self._rank_held:
            raise RuntimeError(
                f"to_host({name!r}): the field's blocks span ranks; each "
                "rank holds only its own (read grid.arrays, "
                "[n_held, bx, by, bz, ...])")
        t = self.arrays[name]
        if self._spans:
            # every block onto the host, into its place in the grid
            shape = self.fields[name][0]
            whole = torch.empty(self.length + shape, dtype=t.dtype)
            for view, i in zip(self._whole_blocks(whole, self.block),
                               range(len(self.held))):
                view.copy_(t[i].cpu())
            t = whole
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
