"""Dense fast path for uniform (refinement-level-0) grids, one device.

Port of ``dccrg_tpu/dense.py`` for a single device: fields are dense
``[nx, ny, nz, ...]`` tensors and a stencil step receives each input
padded with a halo (the periodic wrap, or the ``boundary`` value on a
non-periodic edge). The reference shards the arrays over a 3-D device
mesh and fills the halos with collective permutes; that multi-device
exchange waits for ROADMAP queue 1 item 5b, so more than one device
raises ``NotImplementedError`` and ``dense_mesh`` has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from .grid import as_torch_dtype, single_device


class DenseGrid:
    """Uniform Cartesian grid with dense storage on one device.

    Parameters
    ----------
    length : (nx, ny, nz) level-0 cell counts.
    fields : dict name -> dtype (scalar per cell) or (shape, dtype).
    device : the device (or a one-element list of devices); ``"cuda"``
        when None.
    periodic : per-dimension wrap, as GridTopology.
    start / cell_length : Cartesian geometry parameters
        (dccrg_cartesian_geometry.hpp:51-88).
    """

    def __init__(
        self,
        length,
        fields,
        device=None,
        periodic=(False, False, False),
        start=(0.0, 0.0, 0.0),
        cell_length=None,
    ):
        self.device = single_device(device, "DenseGrid")
        self.length = tuple(int(v) for v in length)
        self.periodic = tuple(bool(p) for p in periodic)
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

    # -- halo padding --------------------------------------------------

    def pad_with_halo(self, block: torch.Tensor, halo: int, boundary: float = 0.0):
        """Pad a block with ``halo`` cells per side along each of x, y, z:
        the periodic wrap, or ``boundary`` on a non-periodic axis. The
        one-device branch of the reference's ghost-slab exchange
        (dense.py:127-161)."""
        for d in range(3):
            size = block.shape[d]
            hi_slab = block.narrow(d, size - halo, halo)
            lo_slab = block.narrow(d, 0, halo)
            if self.periodic[d]:
                from_lo, from_hi = hi_slab, lo_slab
            else:
                from_lo = torch.full_like(hi_slab, boundary)
                from_hi = torch.full_like(lo_slab, boundary)
            block = torch.cat([from_lo, block, from_hi], dim=d)
        return block

    # -- stencil step --------------------------------------------------

    def make_step(self, fn, fields_in, fields_out, halo: int = 1, boundary=0.0):
        """Wrap ``fn`` into a step.

        ``fn(blocks: dict, *extra) -> dict`` receives halo-padded blocks
        ``[nx+2h, ny+2h, nz+2h, ...]`` for every name in ``fields_in`` and
        must return interior updates ``[nx, ny, nz, ...]`` for every name
        in ``fields_out``. Returns ``step(arrays: dict, *extra) -> dict``,
        a new dict with the outputs replaced.
        """
        fields_in = tuple(fields_in)
        fields_out = tuple(fields_out)

        def step(arrays, *extra):
            padded = {n: self.pad_with_halo(arrays[n], halo, boundary)
                      for n in fields_in}
            res = fn(padded, *extra)
            out = dict(arrays)
            for n in fields_out:
                out[n] = res[n]
            return out

        return step

    def to_host(self, name: str) -> np.ndarray:
        t = self.arrays[name].detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
