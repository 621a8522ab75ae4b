"""A lane-vectorised emulation of kernel A's k-deep plane route
(``bulk_planes_k`` in ``dccrg_tpu_torch/csrc/bulk_pass_k.cu``) in
float32 PyTorch on the CPU: the same bands, segments, lanes, input ring
slots, level rings, register rings, skew and order of operations, one
block at a time. Shared memory the kernel never writes holds NaN, so a
wrong slot or lane shows in the result. It checks the blocking that
``PassSpec.deep`` hands the kernel where no card is at hand; the kernel
itself is held to the plain version on the card
(``tests/test_torch_cuda.py``)."""

import torch

from dccrg_tpu_torch.ops import roll_executor as rx

PAD, STAGE, INOFF, RING = (rx._DEEP_PAD, rx._DEEP_STAGE, 16, 8)


def _wrap(c, n, periodic):
    """Coordinates ``c`` (int tensor) wrapped into [0, n), and whether
    each lies inside the grid (always on a periodic axis)."""
    ok = (c >= 0) & (c < n)
    if periodic:
        return torch.remainder(c, n), torch.ones_like(ok)
    return torch.where(ok, c, torch.zeros_like(c)), ok


def _round(x, dtype):
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def emulate_planes(rho, vx, vy, spec, k, c0, c1, dtype, vec=True):
    """One k-deep pass of the face set over float32 ``[nz, ny, nx]``
    fields holding storage-rounded values; ``vec`` picks the kernel's
    load timing (rows landed ``RING - 2`` iterations ahead, or element
    loads landed an iteration after they were fetched)."""
    nx, ny, nz = spec.dims
    px, py, _ = spec.periodic
    route, (band, seg, _) = spec.deep(k)
    assert route == "planes"
    mask = not (px and py)
    K, R, D = k, k + 1, RING - 2
    out = torch.full((nz, ny, nx), float("nan"))
    c0, c1 = (torch.tensor(c, dtype=torch.float32) for c in (c0, c1))
    half = torch.tensor(0.5, dtype=torch.float32)
    lanes = band + 2 * PAD
    iw, lw, sw = band + 48, lanes + 2, band + 2 * STAGE
    j = torch.arange(lanes)
    col = INOFF + j - (PAD - STAGE)
    zero = torch.zeros(lanes)
    for z in range(nz):
        for ya in range(0, ny, seg):
            for x0 in range(0, nx, band):
                n_it = min(seg, ny - ya) + 2 * K
                ugx = x0 - PAD + j
                p_l = (not mask) | px | (ugx > 0)
                p_r = (not mask) | px | (ugx + 1 < nx)
                mine = (j >= PAD) & (j < PAD + band) & (ugx < nx)
                ring = torch.full((RING, 3, iw), float("nan"))
                levels = torch.full((max(K - 1, 1), 2, lw), float("nan"))
                gxs, okx = _wrap(x0 - STAGE + torch.arange(sw), nx, px)

                def land(i):
                    gy, oky = _wrap(torch.tensor(ya - K + i), ny, py)
                    for f, field in enumerate((rho, vx, vy)):
                        row = field[z, int(gy)][gxs]
                        ring[i % RING, f, INOFF:INOFF + sw] = torch.where(
                            okx & oky, row, torch.zeros_like(row))

                for i in range(min(D, n_it)):
                    land(i)
                dn = torch.zeros((K, R, lanes))
                m_l, m_r, m_y = (torch.zeros((R, lanes)) for _ in range(3))
                sg = torch.zeros(lanes, dtype=torch.int64)
                fy = torch.zeros((K, lanes))
                wprev = torch.zeros(lanes)
                for i in range(n_it):
                    u = i % R
                    if vec and i + D < n_it:
                        land(i + D)
                    if not vec and i >= 1 and i - 1 + D < n_it:
                        land(i - 1 + D)
                    cur = ring[i % RING]
                    dn[0, u] = cur[0][col]
                    uc, wc = cur[1][col], cur[2][col]
                    v = half * (uc + cur[1][col - 1])
                    m_l[u] = v * c0
                    bt = (v >= 0).long()
                    v = half * (uc + cur[1][col + 1])
                    m_r[u] = v * c0
                    bt |= (v >= 0).long() << 1
                    v = half * (wprev + wc)
                    m_y[u] = v * c1
                    bt |= (v >= 0).long() << 2
                    sg = ((sg << 3) | bt) & 0xFFFFFFFF
                    wprev = wc
                    last = ring[(i - 1) % RING][0]
                    for t in range(1, K + 1):
                        ry, ra = (u - t) % R, (u - t + 1) % R
                        rc, rn = dn[t - 1, (u - 1) % R], dn[t - 1, u]
                        if t == 1:
                            rl, rr = last[col - 1], last[col + 1]
                        else:
                            lv = levels[t - 2, (i & 1) ^ 1]
                            rl, rr = lv[j], lv[j + 2]
                        gy = ya - K + i - t
                        vb = py or 1 <= gy < ny
                        va = py or 0 <= gy < ny - 1
                        bit = lambda b: ((sg >> b) & 1) != 0
                        fa = torch.where(bit(3 * t - 1), rc, rn) * m_y[ra]
                        fl = torch.where(bit(3 * t), rl, rc) * m_l[ry]
                        fr = torch.where(bit(3 * t + 1), rc, rr) * m_r[ry]
                        acc = torch.zeros(lanes)
                        acc = acc + (fy[t - 1] if vb else zero)
                        acc = acc + torch.where(p_l, fl, zero)
                        acc = acc - torch.where(p_r, fr, zero)
                        acc = acc - (fa if va else zero)
                        res = rc + acc
                        fy[t - 1] = fa
                        if t < K:
                            dn[t, u] = _round(res, dtype)
                            levels[t - 1, i & 1, j + 1] = dn[t, u]
                        elif i >= 2 * K:
                            out[z, ya - 2 * K + i, ugx[mine]] = \
                                _round(res, dtype)[mine]
    return out
