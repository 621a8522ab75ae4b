"""The rotation-advection step on a hand-written CUDA kernel.

Port of ``dccrg_tpu/ops/advection_kernel.py``: ``spp`` first-order
upwind steps of the benchmark's separable solid-body rotation field
(vx depends only on y, vy only on x; tests/advection/solve.hpp:339-346)
per HBM pass, periodic in x and y, no flux in z. On CUDA tensors the
step launches **kernel B** (csrc/rotation_step.cu); on CPU tensors it
runs the plain PyTorch version, :func:`rotation_step_plain`, which does
the same arithmetic on whole arrays.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_STORAGE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MARGIN = 8  # wrap rows on each side of vy_face
DEFAULT_TILE = (64, 16)  # a band of 64 rows of y by 16 z-columns a block

_ROT_SIG = {
    "dccrg_rotation_step": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "dccrg_rotation_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _coeffs(dt, dtype, rdx, rdy):
    """``dt`` rounded to the storage dtype, then ``dt * rdx`` and
    ``dt * rdy`` in float32 — the reference folds them the same way
    (advection_kernel.py:174-186)."""
    dt_s = torch.tensor(float(dt), dtype=dtype).to(torch.float32)
    return dt_s * rdx, dt_s * rdy


def check_tile(by, tz, spp):
    """Raise unless kernel B can run a band of ``by`` rows of y and
    ``tz`` z-columns per block for ``spp`` sub-steps: tz is 8, 16 or
    32, and one thread per row of the band widened by ``spp`` rows on
    each side and pair of z-columns makes at most 1024. Any X fits: the
    kernel marches x with a fixed ring of folded y velocities."""
    if by < 1 or tz not in (8, 16, 32) or (by + 2 * spp) * tz // 2 > 1024:
        raise ValueError(f"tile {(by, tz)} with steps_per_pass {spp} does "
                         "not fit the kernel: by >= 1, tz in (8, 16, 32) "
                         "and (by + 2*spp) * tz / 2 <= 1024 threads")


def flops_per_pass(cells, spp):
    """Float operations of one pass: per cell and sub-step, two
    one-sided differences, the donor product and the add along each of
    x and y (the reference kernel's cost estimate, 10 per update)."""
    return 10 * spp * cells


def rotation_step_plain(rho, vx_face, vy_face, dt, rdx, rdy, spp):
    """The plain PyTorch version of kernel B: ``spp`` upwind sub-steps
    on whole ``[X, Y, Z]`` arrays, every operation in the storage
    dtype as the reference kernel computes."""
    dtype = rho.dtype
    X, Y, _Z = rho.shape
    cdx, cdy = _coeffs(dt, dtype, rdx, rdy)
    cx = (vx_face.to(dtype)[0].to(torch.float32) * cdx).to(dtype).reshape(1, Y, 1)
    cy = (vy_face.to(dtype)[_MARGIN:_MARGIN + X, 0].to(torch.float32)
          * cdy).to(dtype).reshape(X, 1, 1)
    s = rho
    for _ in range(spp):
        dxt = cx * torch.where(cx >= 0, torch.roll(s, 1, 0) - s,
                               s - torch.roll(s, -1, 0))
        dyt = cy * torch.where(cy >= 0, torch.roll(s, 1, 1) - s,
                               s - torch.roll(s, -1, 1))
        s = s + dxt + dyt
    return s


def rotation_step(rho, vx_face, vy_face, dt, rdx, rdy, spp, tile):
    """``spp`` upwind sub-steps of ``rho`` ``[X, Y, Z]`` in its storage
    dtype (float32 or bfloat16). On CUDA tensors it launches kernel B
    (csrc/rotation_step.cu) with ``tile = (by, tz)`` and counts the
    launch in ``rotation_step.launches``; on CPU tensors it runs
    :func:`rotation_step_plain`."""
    if rho.device.type == "cpu":
        return rotation_step_plain(rho, vx_face, vy_face, dt, rdx, rdy, spp)
    if rho.device.type != "cuda":
        raise ValueError(f"rotation step runs on CUDA or CPU, got {rho.device}")
    dtype = rho.dtype
    if dtype not in _STORAGE_CODES:
        raise ValueError(f"storage dtype must be float32 or bfloat16, got {dtype}")
    X, Y, Z = rho.shape
    check_tile(tile[0], tile[1], spp)
    rho = rho.contiguous()
    vxf = vx_face.to(device=rho.device, dtype=dtype).contiguous()
    vyf = vy_face.to(device=rho.device, dtype=dtype).contiguous()
    if vxf.numel() != Y or vyf.numel() != X + 2 * _MARGIN:
        raise ValueError("vx_face must hold Y values and vy_face X + 16")
    cdx, cdy = _coeffs(dt, dtype, rdx, rdy)
    lib = _build.load("rotation_step", _ROT_SIG)
    out = torch.empty_like(rho)
    rc = lib.dccrg_rotation_step(
        _STORAGE_CODES[dtype], rho.data_ptr(), vxf.data_ptr(), vyf.data_ptr(),
        out.data_ptr(), X, Y, Z, spp, tile[0], tile[1], float(cdx),
        float(cdy), rho.device.index or 0,
        torch.cuda.current_stream(rho.device).cuda_stream)
    _build.check(lib, "dccrg_rotation", rc)
    rotation_step.launches += 1
    return out


rotation_step.launches = 0


def make_rotation_step(shape, dtype=torch.float32, tile=None,
                       cell_length=None, steps_per_pass=1):
    """The 512^3-class benchmark step.

    shape: (X, Y, Z) interior extents, periodic in x and y (the
    2d.cpp:237 configuration); vz == 0, so z carries no flux. Any
    extents work: the TPU kernel's ``Z % 128`` and ``tx % 8`` were
    constraints of its tiling, not of the step.

    ``tile``: (by, tz), the band of output rows of y and the chunk of
    z-columns (8, 16 or 32) of one block of the kernel, which streams
    the band along the whole x extent; None picks ``DEFAULT_TILE``.
    ``steps_per_pass`` (1..8): temporal blocking depth — that many
    upwind updates per HBM pass, with a y halo of the same width.

    Returns ``step(rho, vx_face, vy_face, dt) -> rho'`` with ``rho``
    ``[X, Y, Z]`` (Z contiguous), ``vx_face`` ``[1, Y]`` (vx at cell rows,
    constant along x) and ``vy_face`` ``[X + 16, 1]``: vy at cells
    ``(x - 8) % X``, the cell values extended by an 8-row wrap margin on
    each side, as the reference takes them. The step computes in the
    storage ``dtype`` and returns a new tensor.
    """
    X, Y, Z = (int(v) for v in shape)
    sp = int(steps_per_pass)
    if sp < 1 or sp > 8:
        raise ValueError("steps_per_pass must be in 1..8")
    if dtype not in _STORAGE_CODES:
        raise ValueError(f"storage dtype must be float32 or bfloat16, got {dtype}")
    by, tz = DEFAULT_TILE if tile is None else (int(tile[0]), int(tile[1]))
    check_tile(by, tz, sp)
    if cell_length is None:
        cell_length = (1.0 / X, 1.0 / Y, 1.0 / Z)
    rdx = float(1.0 / cell_length[0])
    rdy = float(1.0 / cell_length[1])

    def step(rho, vx_face, vy_face, dt):
        if tuple(rho.shape) != (X, Y, Z):
            raise ValueError(f"rho must be {(X, Y, Z)}, got {tuple(rho.shape)}")
        if (tuple(vx_face.shape) != (1, Y)
                or tuple(vy_face.shape) != (X + 2 * _MARGIN, 1)):
            raise ValueError("vx_face must be [1, Y] and vy_face [X + 16, 1]")
        return rotation_step(rho.to(dtype), vx_face, vy_face, dt, rdx, rdy,
                             sp, (by, tz))

    step.tile = (by, tz)
    step.steps_per_pass = sp
    return step
