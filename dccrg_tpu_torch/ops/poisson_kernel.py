"""The Poisson solvers' 7-point Laplacian matvec on a hand-written CUDA kernel.

Port of ``dccrg_tpu/ops/poisson_kernel.py``: ``A p`` sums
``rdd2 * (p[neighbor] - p[center])`` over the present face neighbors of
every cell of a dense ``[X, Y, Z]`` array; periodic axes wrap and a
non-periodic edge drops the missing neighbor's term (homogeneous
Neumann), the sign convention of ``DensePoissonSolver``. On CUDA tensors
the matvec launches **kernel C** (csrc/laplacian_matvec.cu); on CPU
tensors it runs the plain PyTorch version, :func:`laplacian_matvec_plain`,
which does the same arithmetic on whole arrays. ``CudaPoissonSolver``
runs conjugate gradients (``models/poisson.cg_solve``) on it.
"""

from __future__ import annotations

import ctypes

import torch

from ..grid import resolve_device
from . import _build

_STORAGE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LAP_SIG = {
    "dccrg_laplacian_matvec": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]),
    "dccrg_laplacian_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def flops_per_matvec(cells):
    """Float operations of one matvec: per cell and axis two differences,
    their sum, the product and the accumulation (the reference kernel's
    cost estimate, 12 per cell)."""
    return 12 * cells


def rdd2_coefficients(cell_length, dtype):
    """``1 / cell_length[d]**2`` per axis, computed in Python double and
    rounded once to the storage ``dtype`` (returned as Python floats that
    the storage type represents exactly)."""
    return tuple(float(torch.tensor(float(1.0 / c ** 2), dtype=dtype))
                 for c in cell_length)


def laplacian_matvec_plain(p, rdd2, periodic):
    """The plain PyTorch version of kernel C on a whole ``[X, Y, Z]``
    array, every operation in ``p``'s dtype: ``acc = 0``; per axis,
    ``t_lo = roll(p, 1) - p`` and ``t_hi = roll(p, -1) - p``, zeroed on a
    non-periodic edge, then ``acc = acc + rdd2[d] * (t_lo + t_hi)``."""
    acc = torch.zeros_like(p)
    for d in range(3):
        t_lo = torch.roll(p, 1, d) - p
        t_hi = torch.roll(p, -1, d) - p
        if not periodic[d]:
            n = p.shape[d]
            shape = [1, 1, 1]
            shape[d] = n
            idx = torch.arange(n, device=p.device).reshape(shape)
            t_lo = torch.where(idx > 0, t_lo, 0.0)
            t_hi = torch.where(idx < n - 1, t_hi, 0.0)
        acc = acc + rdd2[d] * (t_lo + t_hi)
    return acc


def laplacian_matvec(p, rdd2, periodic):
    """``A p`` for ``p`` ``[X, Y, Z]`` (float32 or bfloat16, Z contiguous)
    with per-axis coefficients ``rdd2`` already rounded to ``p``'s dtype.
    On CUDA tensors it launches kernel C (csrc/laplacian_matvec.cu) on the
    current stream and counts the launch in ``laplacian_matvec.launches``;
    on CPU tensors it runs :func:`laplacian_matvec_plain`."""
    if p.device.type == "cpu":
        return laplacian_matvec_plain(p, rdd2, periodic)
    if p.device.type != "cuda":
        raise ValueError(f"laplacian matvec runs on CUDA or CPU, got {p.device}")
    if p.dtype not in _STORAGE_CODES:
        raise ValueError(f"storage dtype must be float32 or bfloat16, got {p.dtype}")
    if p.dim() != 3 or not p.is_contiguous():
        raise ValueError(f"p must be a contiguous [X, Y, Z] tensor, got shape "
                         f"{tuple(p.shape)} strides {p.stride()}")
    X, Y, Z = p.shape
    lib = _build.load("laplacian_matvec", _LAP_SIG)
    out = torch.empty_like(p)
    rc = lib.dccrg_laplacian_matvec(
        _STORAGE_CODES[p.dtype], p.data_ptr(), out.data_ptr(), X, Y, Z,
        rdd2[0], rdd2[1], rdd2[2], int(bool(periodic[0])),
        int(bool(periodic[1])), int(bool(periodic[2])), p.device.index or 0,
        torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(lib, "dccrg_laplacian", rc)
    laplacian_matvec.launches += 1
    return out


laplacian_matvec.launches = 0


def make_laplacian_matvec(shape, cell_length=None, periodic=(True, True, True),
                          dtype=torch.float32):
    """The 7-point Laplacian matvec ``p -> A p`` on ``shape = (X, Y, Z)``.

    ``cell_length`` defaults to ``(1/X, 1/Y, 1/Z)``. Any extents work:
    the TPU kernel's ``Z % 128``, ``X % tx`` and ``tx % 8`` were
    constraints of its tiling, not of the matvec. Returns ``matvec(p)``,
    which casts ``p`` to ``dtype`` and returns a new tensor on ``p``'s
    device.
    """
    X, Y, Z = (int(v) for v in shape)
    if dtype not in _STORAGE_CODES:
        raise ValueError(f"storage dtype must be float32 or bfloat16, got {dtype}")
    if cell_length is None:
        cell_length = (1.0 / X, 1.0 / Y, 1.0 / Z)
    rdd2 = rdd2_coefficients(cell_length, dtype)
    per = tuple(bool(b) for b in periodic)

    def matvec(p):
        if tuple(p.shape) != (X, Y, Z):
            raise ValueError(f"p must be {(X, Y, Z)}, got {tuple(p.shape)}")
        return laplacian_matvec(p.to(dtype).contiguous(), rdd2, per)

    matvec.rdd2 = rdd2
    matvec.periodic = per
    return matvec


class CudaPoissonSolver:
    """CG on kernel C: the single-device fast path of the Poisson
    benchmark, the counterpart of ``PallasPoissonSolver``
    (dccrg_tpu/ops/poisson_kernel.py:183). Uniform grids with unit
    domain (cell length ``1/n`` per axis). The CG vector updates are
    plain PyTorch; every matvec is kernel C on the card (its plain
    version for ``device="cpu"``)."""

    def __init__(self, length, periodic=(True, True, True),
                 dtype=torch.float32, device=None):
        self.length = tuple(int(v) for v in length)
        self.periodic = tuple(bool(b) for b in periodic)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._matvec = make_laplacian_matvec(
            self.length, cell_length=tuple(1.0 / v for v in self.length),
            periodic=self.periodic, dtype=dtype)

    def solve(self, rhs, rtol=1e-5, max_iterations=1000):
        from ..models.poisson import cg_solve

        return cg_solve(self._matvec, rhs, singular=all(self.periodic),
                        dtype=self.dtype, rtol=rtol,
                        max_iterations=max_iterations, device=self.device)
