"""Vlasov-style workload on PyTorch: wide per-cell velocity-space
payloads where only reduced moments cross as ghosts.

Port of ``dccrg_tpu/models/vlasov.py``. Each cell carries a wide
velocity-space distribution ``f`` (a fixed ``[Nv]`` vector field),
advected in velocity space by a self-consistent-field sketch
(acceleration from the neighbour density gradient) with zero-flux
velocity boundaries, then relaxed BGK-style toward a discrete Maxwellian
built from the neighbour-averaged moments. Only the moments ``rho`` and
``ux`` are read from neighbours, so ``run_steps`` exchanges
``("rho", "ux")`` and the step gathers only those two: the wide payload
never moves between partitions and is never gathered.

Total mass (``sum rho``) is conserved: the velocity advection is flux
form with zero boundary fluxes, and the BGK target is normalized to the
neighbour-averaged density.

Differences from the reference, all within the tolerances the tests
state: ``torch.exp`` is not XLA's exponential (about one float32 ulp),
the ``[Nv]`` and neighbour-slot sums run in slot order (the
reference's ``jnp.sum`` in an order of XLA's choosing), and the velocity
grid is :func:`_v_grid_np`, bit for bit the values of the reference's
eager ``jnp.linspace`` (``torch.linspace`` computes others; inside the
reference's compiled kernel XLA folds the constant to values up to one
ulp away).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import comm
from ..grid import Grid, slot_sum

NV_DEFAULT = 16
VMAX = 1.0      # velocity-grid half-extent
VT = 0.4        # thermal width of the BGK target
NU = 0.5        # BGK relaxation rate
KFIELD = 0.05   # density-gradient force coefficient
RHO_FLOOR = 1.0e-6

VLASOV_FIELDS = ("f", "rho", "ux")
VLASOV_EXCHANGE = ("rho", "ux")

_F32 = torch.float32


def vlasov_cell_data(nv: int = NV_DEFAULT, dtype=torch.float32) -> dict:
    """The schema: the wide ``[Nv]`` payload plus its two moments."""
    return {"f": ((int(nv),), dtype), "rho": dtype, "ux": dtype}


def _v_grid_np(nv: int) -> np.ndarray:
    """float32 ``linspace(-VMAX, VMAX, nv)`` with the bits of the
    reference's ``jnp.linspace`` (the XLA CPU program: ``i * (1/div)``
    rounded, ``start * (1 - step)`` rounded, then the ``stop * i *
    (1/div)`` product fused into the final add; the end point exact)."""
    f32 = np.float32
    div = nv - 1
    if div <= 0:
        return np.full(max(nv, 0), -VMAX, f32)
    it = np.arange(div, dtype=f32)
    rcp = f32(1.0) / f32(div)
    step = it * rcp
    lo = f32(-VMAX) * (f32(1.0) - step)
    # the product of two float32 values is exact in float64
    hi = (it.astype(np.float64) * np.float64(rcp) * VMAX
          + lo.astype(np.float64)).astype(f32)
    return np.concatenate([hi, np.array([VMAX], f32)])


_V_CACHE: dict = {}


def _v_grid(nv: int, device=None):
    """``(v [nv] float32 tensor, dv float32 scalar)`` on ``device``."""
    key = (int(nv), str(device))
    v = _V_CACHE.get(key)
    if v is None:
        v = _V_CACHE[key] = torch.as_tensor(_v_grid_np(nv), device=device)
    return v, np.float32(2.0 * VMAX / (nv - 1))


def _moments(f, v, dv):
    """``(rho, ux)`` of ``f [..., Nv]``, the ``[Nv]`` sums in order."""
    rho = slot_sum(f) * dv
    ux = slot_sum(f * v) * dv / torch.clamp_min(rho, RHO_FLOOR)
    return rho, ux


def make_vlasov_kernel():
    """The fleet kernel (registry name ``"vlasov"``), one parameter
    ``dt``. ``Nv`` is read off the field shape. Declares that every
    output's ghost reads are the two moments; the wide ``f`` is never
    read from neighbours."""

    def kernel(cell, nbr, offs, mask, dt):
        f = cell["f"].to(_F32)                   # [..., L, Nv]
        nv = f.shape[-1]
        v, dv = _v_grid(nv, f.device)
        # (a step's dt may live on another device of the grid: the host's
        # when the partitions span the card and the host)
        dt = (dt.to(f.device, _F32) if isinstance(dt, torch.Tensor)
              else np.float32(dt))
        dtv = dt[..., None] if isinstance(dt, torch.Tensor) else dt
        zero = torch.zeros((), dtype=_F32, device=f.device)
        face = mask & (offs.abs().sum(dim=-1) == 1)
        rho_n = nbr["rho"].to(_F32)              # [..., L, S]
        ux_n = nbr["ux"].to(_F32)
        deg = torch.clamp_min(face.sum(dim=-1), 1).to(_F32)
        rho_bar = slot_sum(torch.where(face, rho_n, zero)) / deg
        ux_bar = slot_sum(torch.where(face, ux_n, zero)) / deg
        # electrostatic-force proxy: the x-gradient of the neighbour
        # density (the only other ghost read)
        ox = offs[..., 0]
        gx = slot_sum(torch.where(face & (ox != 0), ox.to(_F32) * rho_n,
                                  zero))
        a = -np.float32(KFIELD) * gx             # [..., L]
        # velocity-space upwind advection, flux form, zero-flux ends:
        # interior edge fluxes [..., Nv-1], per-cell mass telescopes
        ap = torch.clamp_min(a, 0.0)[..., None]
        am = torch.clamp_max(a, 0.0)[..., None]
        flux = ap * f[..., :-1] + am * f[..., 1:]
        z1 = torch.zeros(f.shape[:-1] + (1,), dtype=_F32, device=f.device)
        f1 = f - (dtv / dv) * (torch.cat([flux, z1], dim=-1)
                               - torch.cat([z1, flux], dim=-1))
        # BGK relaxation toward the neighbour-moment Maxwellian,
        # normalized so its density moment is exactly rho_bar
        w = torch.exp(-((v - ux_bar[..., None]) / np.float32(VT)) ** 2)
        g = rho_bar[..., None] * w / (slot_sum(w)[..., None] * dv)
        f2 = f1 + dtv * np.float32(NU) * (g - f1)
        rho2, ux2 = _moments(f2, v, dv)
        return {"f": f2, "rho": rho2, "ux": ux2}

    kernel.ghost_deps = {n: VLASOV_EXCHANGE for n in VLASOV_FIELDS}
    return kernel


def vlasov_default_init(grid, seed: int) -> None:
    """Seeded default init for ``"vlasov"`` jobs: a positive random
    distribution with self-consistent moments, the reference's bytes."""
    rng = np.random.default_rng(seed)
    cells = grid.plan.cells
    nv = int(grid.fields["f"][0][0])
    f = (0.1 + rng.random((len(cells), nv))).astype(np.float32)
    _set_with_moments(grid, cells, f)


def _set_with_moments(grid, cells, f) -> None:
    """Write ``f`` and its moments, computed on the host as the
    reference computes them (numpy float32 sums)."""
    v = np.linspace(-VMAX, VMAX, f.shape[-1], dtype=np.float32)
    dv = np.float32(2.0 * VMAX / (f.shape[-1] - 1))
    rho = (f.sum(axis=-1, dtype=np.float32) * dv).astype(np.float32)
    ux = ((f * v).sum(axis=-1, dtype=np.float32) * dv
          / np.maximum(rho, np.float32(RHO_FLOOR))).astype(np.float32)
    grid.set_many(cells, {"f": f, "rho": rho, "ux": ux})


class GridVlasov:
    """The Vlasov model: a drifting density bump whose wide velocity
    payload stays on its partition; every ``run_steps`` call exchanges
    only the two moments. On the card unless ``device`` says
    otherwise; on distinct devices or a placement of ``(rank, device)``
    entries the wide ``f`` never crosses devices or ranks either, only
    the moments' halo does."""

    def __init__(self, n=8, nz=None, nv=NV_DEFAULT, device=None,
                 partition="block", seed=0):
        nz = nz if nz is not None else n
        self.n, self.nz, self.nv = n, nz, int(nv)
        self.grid = (
            Grid(cell_data=vlasov_cell_data(nv))
            .set_initial_length((n, n, nz))
            .set_periodic(True, True, True)
            .set_maximum_refinement_level(0)
            .set_neighborhood_length(0)
            .initialize(device, partition=partition)
        )
        cells = self.grid.plan.cells
        idx = self.grid.mapping.get_indices(np.asarray(cells, np.uint64))
        x = (idx[:, 0].astype(np.float64) + 0.5) / n
        del idx
        bump = (1.0 + 0.5 * np.cos(2.0 * np.pi * x)).astype(np.float32)
        v = np.linspace(-VMAX, VMAX, self.nv, dtype=np.float32)
        f = (bump[:, None]
             * np.exp(-((v[None, :] - 0.2) / VT) ** 2)).astype(np.float32)
        rng = np.random.default_rng(seed)
        f = f + (0.01 * rng.random(f.shape)).astype(np.float32)
        _set_with_moments(self.grid, cells, f)
        self.grid.update_copies_of_remote_neighbors()
        self._kernel = make_vlasov_kernel()
        self.time = 0.0

    def run(self, n_steps: int, dt: float = 0.05) -> float:
        self.grid.run_steps(
            self._kernel, VLASOV_FIELDS, VLASOV_FIELDS, n_steps,
            exchange_fields=VLASOV_EXCHANGE,
            extra_args=(torch.tensor(dt, dtype=_F32,
                                     device=comm.grid_fold_device(
                                         self.grid)),))
        self.time += n_steps * dt
        return dt

    def total_mass(self) -> float:
        """Float64 sum of the density over every cell
        (``comm.grid_field_totals``: the same value on every rank of a
        placement)."""
        return comm.grid_field_totals(self.grid, ("rho",))["rho"]


def register() -> None:
    """Register the zoo entries: the ``"vlasov"`` fleet kernel with the
    wide-payload schema defaults and seeded init, and the mass invariant
    of the integrity layer. Idempotent."""
    from .. import fleet, integrity

    fleet.register_kernel("vlasov", make_vlasov_kernel())
    fleet.register_kernel_spec(
        "vlasov", cell_data=vlasov_cell_data(NV_DEFAULT),
        fields_in=VLASOV_FIELDS, fields_out=VLASOV_FIELDS,
        params=(0.05,), init=vlasov_default_init)
    integrity.register_conserved("vlasov", ("rho",),
                                 periodic_axes=(0, 1, 2))


ZOO_INFO = {
    "kernel": "vlasov",
    "fields": VLASOV_FIELDS,
    "ghost_deps": {n: VLASOV_EXCHANGE for n in VLASOV_FIELDS},
    "conserved": ("rho",),
    "model": "GridVlasov",
    "description": ("hybrid-Vlasov-style: wide [Nv] per-cell velocity "
                    "payload advected locally; only the (rho, ux) "
                    "moments exchange as ghosts"),
}
