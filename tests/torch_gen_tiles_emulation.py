"""An emulator of the tiled routes of csrc/gen_tiles.cuh, for tests only.

Kernels A and A' over a generated flux whose slot table is compiled in
(``flux_gen.source(flux, table)``) cannot run here: no card, no nvcc.
This replays them block by block in NumPy with the kernel's own index
map: the block order and its (x, y) tile of ``tx x 256 / tx * cells``
cells (the route's form, ``flux_gen.GenForm``) and z chunk, the staged positions of a plane (a halo of the reach,
each fetched from its wrapped coordinate, +0.0 outside a non-periodic
face), the ring of ``2 rz + 2`` planes (a plane fetched before the
current plane's cells are computed and stored after them), the choice
between the literal mask ``true`` and each slot's mask from the cell's
coordinates, the pad rows with every slot masked, and on kernel A' a
bucket slot's rows at ``b * R`` (a base that is not aligned), its
freeze and the zero row. Each cell runs the specialised slot sequence
(the table in ``offs_const`` order, its ``offs_const`` row a literal)
through the lowered programs of tests/torch_flux_emulator.py, rounded
per instruction as the functor rounds them.
"""

import numpy as np
import torch

from dccrg_tpu_torch.ops import flux_gen

import torch_flux_emulator as emu

def _wrap(c, n, periodic):
    """fluxes::wrap over an array: (valid, wrapped coordinate)."""
    inside = (c >= 0) & (c < n)
    if periodic:
        return np.ones_like(inside), np.where(inside, c, c % n)
    return inside, c


def _block_cells(TX, TY, cells):
    """A block's cells in thread order (``TX`` x ``TY`` threads), a
    thread's ``cells`` rows consecutive: (lx, ly) of each."""
    t = np.arange(TX * TY)
    lx = np.repeat(t % TX, cells)
    ly = np.repeat((t // TX) * cells, cells) + np.tile(np.arange(cells),
                                                        TX * TY)
    return lx, ly


def _grid_pass(flux, table, form, dims, periodic, zc, flat, base, out, ex,
               hp):
    """One grid's cells (rows at ``base`` of the flat arrays ``flat``)
    by the kernel's blocks in ``form``, written into ``out``."""
    nx, ny, nz = dims
    px, py, pz = periodic
    rx_, ry, rz = table.reach
    cells = form.cells
    TX = form.tx
    TY = flux_gen.GEN_THREADS // TX
    W, H = TX + 2 * rx_, TY * cells + 2 * ry
    NR = 2 * rz + 2
    staged = flux.staged()
    nxy = nx * ny
    n_tx, n_ty = -(-nx // TX), -(-ny // (TY * cells))
    for tz in range(-(-nz // zc)):
        for ty in range(n_ty):
            for tx in range(n_tx):
                x0, y0, z0 = tx * TX, ty * TY * cells, tz * zc
                n_planes = min(zc, nz - z0)
                e = np.arange(W * H)
                okx, cx = _wrap(x0 - rx_ + e % W, nx, px)
                oky, cy = _wrap(y0 - ry + e // W, ny, py)
                src = np.where(okx & oky, cx + nx * cy, -1)

                def fetch(j):
                    okz, gz = _wrap(np.array(z0 - rz + j), nz, pz)
                    v = np.zeros((len(staged), W * H), np.float32)
                    if okz:
                        at = base + gz * nxy + np.maximum(src, 0)
                        for s, q in enumerate(staged):
                            v[s] = np.where(src >= 0, flat[q][at], 0)
                    return v

                ring = np.zeros((NR, len(staged), W * H), np.float32)
                for j in range(2 * rz + 1):
                    ring[j % NR] = fetch(j)
                xm = min(x0 + TX, nx) - 1
                ym = min(y0 + TY * cells, ny) - 1
                edge_xy = ((not px and (x0 < rx_ or xm + rx_ >= nx))
                           or (not py and (y0 < ry or ym + ry >= ny)))
                lx, ly = _block_cells(TX, TY, cells)
                x, y = x0 + lx, y0 + ly
                live = (x < nx) & (y < ny)
                pos = (ly + ry) * W + lx + rx_
                for it in range(n_planes):
                    more = it + 1 < n_planes
                    if more:
                        v = fetch(it + 2 * rz + 1)
                    z = z0 + it
                    f = base + x + nx * y + nxy * z
                    edge = edge_xy or (not pz and (z < rz or z + rz >= nz))
                    res = _cells(flux, table, ring, it % NR, pos, W, edge,
                                 (x, y, z), dims, periodic, flat,
                                 np.where(live, f, base), ex, hp)
                    for o, r in zip(out, res):
                        o[f[live]] = r[live]
                    if more:
                        ring[(it + 2 * rz + 1) % NR] = v


def _cells(flux, table, ring, r0, pos, W, edge, xyz, dims, periodic, flat,
           f, ex, hp):
    """A block's cells of one plane: the slot sequence over the staged
    ring, the cell's own staged fields from the ring's centre and the
    rest from ``flat`` at rows ``f``."""
    rz = table.reach[2]
    NR = ring.shape[0]
    staged = flux.staged()
    n = len(pos)
    base = {("hp", i): np.float32(h) for i, h in enumerate(hp)}
    base.update({("ex", i): np.float32(e) for i, e in enumerate(ex)})
    for q in range(len(flux.fields_in)):
        if q in staged:
            base[("cell", q)] = ring[(r0 + rz) % NR, staged.index(q), pos]
        else:
            base[("cell", q)] = flat[q][f]
    carry = emu.run_prog(flux.init, base, n)
    x, y, z = xyz
    for (ox, oy, oz), oc in zip(table.cells, table.const):
        ins = dict(base)
        ins.update({("carry", i): c for i, c in enumerate(carry)})
        plane = ring[(r0 + rz + oz) % NR]
        for q in range(len(flux.fields_in)):
            ins[("nbr", q)] = (plane[staged.index(q), pos + oy * W + ox]
                               if q in staged else np.zeros(n, np.float32))
        if edge:
            m = np.ones(n, bool)
            for c, o, nd, per in zip((x, y, np.full(n, z)), (ox, oy, oz),
                                     dims, periodic):
                if not per:
                    m &= (c + o >= 0) & (c + o < nd)
        else:
            m = np.ones(n, bool)  # the literal mask `true`
        ins[("mask", 0)] = m
        for d in range(3):
            ins[("offs", d)] = np.int64(oc[d])
        carry = emu.run_prog(flux.slot, ins, n)
    ins = dict(base)
    ins.update({("carry", i): c for i, c in enumerate(carry)})
    return emu.run_prog(flux.finish, ins, n)


def _pad_rows(flux, table, flat, base, rows, out, ex, hp):
    """Rows ``rows`` (pad rows) with every slot masked."""
    n = len(rows)
    ins = {("hp", i): np.float32(h) for i, h in enumerate(hp)}
    ins.update({("ex", i): np.float32(e) for i, e in enumerate(ex)})
    ins.update({("cell", q): flat[q][base + rows]
                for q in range(len(flux.fields_in))})
    carry = emu.run_prog(flux.init, ins, n)
    for oc in table.const:
        s = dict(ins)
        s.update({("carry", i): c for i, c in enumerate(carry)})
        s.update({("nbr", q): np.zeros(n, np.float32)
                  for q in range(len(flux.fields_in))})
        s[("mask", 0)] = np.zeros(n, bool)
        for d in range(3):
            s[("offs", d)] = np.int64(oc[d])
        carry = emu.run_prog(flux.slot, s, n)
    s = dict(ins)
    s.update({("carry", i): c for i, c in enumerate(carry)})
    for o, r in zip(out, emu.run_prog(flux.finish, s, n)):
        o[base + rows] = r


def _rounded(arrs, flux, names):
    """float32 results as tensors of each field's storage dtype (the
    programs already rounded them to it)."""
    return {f: torch.from_numpy(a).to(flux.storage[f])
            for f, a in zip(names, arrs)}


def bulk_pass_tiles(spec, fields, extras, form=None):
    """Kernel A's tiled route, emulated: one step of ``spec.flux`` over
    ``fields`` ({name: [L] CPU tensor}) in ``form`` (``spec.gen_form()``
    by default), ``{out field: [L] tensor}``."""
    flux, table = spec.flux, spec.gen_table
    form = form or spec.gen_form()
    flat = [fields[f].float().numpy() for f in flux.fields_in]
    out = [np.zeros(spec.L, np.float32) for _ in flux.fields_out]
    hp = flux.host_values(extras)
    _grid_pass(flux, table, form, spec.dims, spec.periodic,
               spec.gen_tile(form)[2], flat, 0, out, (), hp)
    if spec.L > spec.n0:
        _pad_rows(flux, table, flat, 0, np.arange(spec.n0, spec.L), out, (),
                  hp)
    return _rounded(out, flux, flux.fields_out)


def fleet_bulk_pass_tiles(spec, flux, state, extras, budget=None, i=0,
                          form=None):
    """Kernel A''s tiled route, emulated: one step of ``flux`` (a fleet
    form) over ``state`` ({name: [B, R] CPU tensor}) with per-slot
    ``extras`` [B, E], a slot with ``budget[b] <= i`` frozen, in
    ``form`` (``spec.gen_form(flux)`` by default);
    ``{out field: [B, R] tensor}``. The slots' rows are addressed on the
    flat [B * R] arrays at ``b * R``, as the kernel addresses them."""
    table = spec.gen_table
    B = state[flux.fields_in[0]].shape[0]
    flat = [state[f].float().reshape(-1).numpy() for f in flux.fields_in]
    prev = [state[f].reshape(-1) for f in flux.fields_out]
    out = [np.zeros(B * spec.R, np.float32) for _ in flux.fields_out]
    hp = flux.host_values(())
    form = form or spec.gen_form(flux)
    zc = spec.gen_tile(flux, B, form)[2]
    frozen = [budget is not None and int(budget[b]) <= i for b in range(B)]
    for b in range(B):
        base = b * spec.R
        ex = [float(v) for v in extras[b]]
        if frozen[b]:
            continue
        _grid_pass(flux, table, form, spec.dims, spec.periodic, zc, flat,
                   base, out, ex, hp)
        _pad_rows(flux, table, flat, base, np.arange(spec.n0, spec.L), out,
                  ex, hp)
    res = _rounded(out, flux, flux.fields_out)
    for f, p in zip(flux.fields_out, prev):
        # the zero row and a frozen slot's rows: the input's bits
        r = res[f].reshape(B, spec.R)
        p2 = p.reshape(B, spec.R)
        r[:, spec.L] = p2[:, spec.L]
        for b in range(B):
            if frozen[b]:
                r[b] = p2[b]
        res[f] = r
    return res
