"""An emulator of the flux generator's lowered programs, for tests only.

``run_flux(flux, spec, fields, extras)`` steps a grid once the way the
generated functor does, but in NumPy and PyTorch on the host: every
instruction of the three programs (``ops/flux_gen.py`` ``Prog``) on
``[L]`` float32 arrays, rounded to bfloat16 where its type is bfloat16,
exp / log / sqrt through the aten op on a tensor of the instruction's
dtype (so their bits are ATen's on the CPU), the neighbour columns
gathered at each slot's 3-D offset, +0.0 where masked.

``gxx_library(flux)`` builds the functor itself as host code with g++
(``-ffp-contract=off``, csrc/flux_rt.cuh's round-to-nearest-even
bfloat16) into a ``run`` entry point over a neighbour table, and
``gxx_specialised(flux, table)`` the same functor through a table's
specialised slot sequence (``Flux.slots_text``); None where there is no
g++.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from dccrg_tpu_torch.ops import flux_gen

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "dccrg_tpu_torch" / "csrc"
BUILD = ROOT / "dccrg_tpu_torch" / "_build"


def rbf(x):
    """float32 values rounded to bfloat16 and widened back."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _round(x, ty):
    return rbf(x) if ty == "bf16" else x


def _wrap(x, ty):
    """Integers held as int64, wrapped to 32 bits where ``ty`` is i32."""
    return np.asarray(x, np.int64).astype(np.int32).astype(np.int64) \
        if ty == "i32" else x


def _cast(x, ty):
    if ty == "bool":
        return x != 0
    if ty in ("i32", "i64"):
        return _wrap(np.trunc(np.asarray(x, np.float64)).astype(np.int64)
                     if np.asarray(x).dtype.kind == "f"
                     else np.asarray(x, np.int64), ty)
    return _round(np.asarray(x, np.float32), ty)


def run_prog(prog, inputs, n):
    """The values of ``prog``'s outputs: ``inputs[(kind, i)]`` the
    inputs ("cell", "nbr", "carry", "mask", "offs", "ex", "hp"), each
    ``[n]`` or a scalar."""
    v = {}
    T = prog.types
    for ins in prog.ins:
        op, d = ins[0], ins[1]
        ty = T[d]
        if op == "in":
            x = inputs[(ins[2], ins[3])]
            v[d] = _cast(x, ty) if ins[2] == "hp" else x
        elif op == "const":
            x = ins[2]
            v[d] = (np.float32(x) if ty in flux_gen.FLOATS
                    else (bool(x) if ty == "bool" else np.int64(x)))
        elif op == "cast":
            v[d] = _cast(v[ins[2]], ty)
        elif op == "bin":
            o, a, b = ins[2], v[ins[3]], v[ins[4]]
            if o == "and":
                r = np.logical_and(a, b)
            elif o == "or":
                r = np.logical_or(a, b)
            elif o == "xor":
                r = np.logical_xor(a, b)
            elif o in ("max", "min"):
                f = np.maximum if o == "max" else np.minimum
                r = f(a, b)
            else:
                with np.errstate(all="ignore"):
                    if o == "add":
                        r = a + b
                    elif o == "sub":
                        r = a - b
                    elif o == "mul":
                        r = a * b
                    elif o == "div":
                        r = np.true_divide(a, b)
                    else:  # rdiv
                        r = a * (np.float32(1) / np.float32(b))
            if ty in flux_gen.FLOATS:
                r = np.asarray(r, np.float32)
            v[d] = _round(r, ty) if ty in flux_gen.FLOATS else _wrap(r, ty)
        elif op == "cmp":
            o, a, b = ins[2], v[ins[3]], v[ins[4]]
            v[d] = {"eq": np.equal, "ne": np.not_equal, "lt": np.less,
                    "le": np.less_equal, "gt": np.greater,
                    "ge": np.greater_equal}[o](a, b)
        elif op == "un":
            o, a = ins[2], v[ins[3]]
            if o == "not":
                v[d] = np.logical_not(a)
            elif o == "neg":
                v[d] = _wrap(-a, ty)
            elif o == "abs":
                v[d] = _wrap(np.abs(a), ty)
            else:
                t = torch.from_numpy(np.broadcast_to(
                    np.asarray(a, np.float32), (n,)).copy()).to(
                        flux_gen._TORCH[ty])
                v[d] = getattr(torch, o)(t).float().numpy()
        elif op == "where":
            v[d] = np.where(v[ins[2]], v[ins[3]], v[ins[4]])
        else:
            raise ValueError(op)
    return [np.broadcast_to(np.asarray(v[d]), (n,)).copy() for d in prog.outs]


def neighbour_table(spec):
    """``[L, S]`` int64 rows of each slot's neighbour (-1 where masked:
    across a non-periodic edge, and on pad rows), from the grid's
    extents and the slots' cell offsets."""
    nx, ny, nz = spec.dims
    L, n0 = spec.L, spec.n0
    r = np.arange(L)
    x, y, z = r % nx, (r // nx) % ny, r // (nx * ny)
    out = np.full((L, len(spec.offs_cells)), -1, np.int64)
    for j, (ox, oy, oz) in enumerate(spec.offs_cells):
        ok = r < n0
        t = []
        for c, o, nd, per in ((x, ox, nx, spec.periodic[0]),
                              (y, oy, ny, spec.periodic[1]),
                              (z, oz, nz, spec.periodic[2])):
            tc = c + o
            if per:
                tc = tc % nd
            else:
                ok = ok & (tc >= 0) & (tc < nd)
            t.append(tc)
        out[:, j] = np.where(ok, t[0] + nx * (t[1] + ny * t[2]), -1)
    return out


def run_flux(flux, spec, fields, extras):
    """One step of ``flux`` over ``fields`` ({name: [L] CPU tensor})
    with ``extras`` (0-d float32 tensors): ``{out field: [L] float32
    array}``, already rounded to each field's storage dtype."""
    L = spec.L
    tab = neighbour_table(spec)
    cell = [fields[f].float().numpy() for f in flux.fields_in]
    hp = flux.host_values(extras)
    base = {("hp", i): np.float32(h) for i, h in enumerate(hp)}
    base.update({("cell", q): c for q, c in enumerate(cell)})
    carry = run_prog(flux.init, base, L)
    for j in range(tab.shape[1]):
        m = tab[:, j] >= 0
        ins = dict(base)
        ins.update({("carry", i): c for i, c in enumerate(carry)})
        for q, c in enumerate(cell):
            ins[("nbr", q)] = np.where(m, c[np.maximum(tab[:, j], 0)],
                                       np.float32(0))
        ins[("mask", 0)] = m
        for d in range(3):
            ins[("offs", d)] = np.int64(spec.offs_const[j][d])
        carry = run_prog(flux.slot, ins, L)
    ins = dict(base)
    ins.update({("carry", i): c for i, c in enumerate(carry)})
    outs = run_prog(flux.finish, ins, L)
    return dict(zip(flux.fields_out, outs))


_HOST_LOOP = """
#include "flux_rt.cuh"
{functor}
extern "C" void run(const void* const* in, void* const* out,
                    const long long* nbr, const int* offs, int S,
                    long long L, const float* hp, int n_hp) {{
  GenFlux::Params k;
  for (int i = 0; i < GenFlux::kHost; ++i) k.hp[i] = i < n_hp ? hp[i] : 0.f;
  for (long long r = 0; r < L; ++r) {{
    float c[GenFlux::kIn];
    GenFlux::load_cell(in, r, c);
    GenFlux::Carry a;
    GenFlux::init(a, c, k, nullptr);
    for (int j = 0; j < S; ++j) {{
      float n[GenFlux::kIn];
      for (int q = 0; q < GenFlux::kIn; ++q) n[q] = 0.f;
      const long long t = nbr[r * S + j];
      if (t >= 0) GenFlux::load_nbr(in, t, n);
      GenFlux::slot(a, c, n, offs + 3 * j, t >= 0, k, nullptr);
    }}
    float o[GenFlux::kOut];
    GenFlux::finish(o, a, c, k, nullptr);
    GenFlux::store(out, r, o);
  }}
}}
"""


def gxx_library(flux):
    """The functor built as host code by g++ (``-O2
    -ffp-contract=off``) with a ``run`` entry point; None without g++."""
    return _gxx(_HOST_LOOP.format(functor=flux.text))


def _gxx(text):
    """``text`` built by g++ into a library with a ``run`` entry point
    (once, by the hash of the text and csrc/flux_rt.cuh); None without
    g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    digest = hashlib.sha256((text + (CSRC / "flux_rt.cuh").read_text())
                            .encode()).hexdigest()[:16]
    BUILD.mkdir(parents=True, exist_ok=True)
    src = BUILD / f"gxx-{digest}.cpp"
    so = BUILD / f"libgxx-{digest}.so"
    if not so.exists():
        # built under names of this process's own, then published
        # whole: test workers may build the same text at once
        tag = f"{os.getpid()}.tmp"
        tmp_src = src.with_name(f"{src.name}.{tag}.cpp")
        tmp_so = so.with_name(f"{so.name}.{tag}")
        tmp_src.write_text(text)
        subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off",
                        "-Wno-unknown-pragmas", "-fPIC", "-shared", "-I",
                        str(CSRC), "-o", str(tmp_so), str(tmp_src)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp_src, src)
        os.replace(tmp_so, so)
    lib = ctypes.CDLL(str(so))
    lib.run.restype = None
    return lib


def run_gxx(lib, flux, spec, fields, extras):
    """One step through the g++-built functor: ``{out field: [L]
    tensor}`` in each field's storage dtype."""
    L = spec.L
    ins = [fields[f].contiguous() for f in flux.fields_in]
    outs = {f: torch.empty(L, dtype=flux.storage[f])
            for f in flux.fields_out}
    tab = np.ascontiguousarray(neighbour_table(spec))
    offs = np.ascontiguousarray(np.asarray(spec.offs_const, np.int32))
    hp = np.asarray(flux.host_values(extras), np.float32)
    vp = ctypes.c_void_p
    lib.run((vp * len(ins))(*[t.data_ptr() for t in ins]),
            (vp * len(outs))(*[t.data_ptr() for t in outs.values()]),
            tab.ctypes.data_as(vp), offs.ctypes.data_as(vp),
            ctypes.c_int(tab.shape[1]), ctypes.c_longlong(L),
            hp.ctypes.data_as(vp) if len(hp) else None,
            ctypes.c_int(len(hp)))
    return outs


_HOST_SLOTS = """
#include "flux_rt.cuh"
{functor}
{slots}
// the specialised slot sequence on the host: slot J's neighbour from
// the neighbour table's column J, its mask where that row is >= 0
struct HostNbr {{
  const void* const* in;
  const long long* row;
  template <int J, int OX, int OY, int OZ>
  void get(int, float (&n)[GenFlux::kIn]) const {{
    for (int q = 0; q < GenFlux::kIn; ++q) n[q] = 0.f;
    if (row[J] >= 0) GenFlux::load_nbr(in, row[J], n);
  }}
}};
struct HostMask {{
  const long long* row;
  template <int J, int OX, int OY, int OZ>
  bool at(int) const {{ return row[J] >= 0; }}
}};
extern "C" void run(const void* const* in, void* const* out,
                    const long long* nbr, const int* offs, int S,
                    long long L, const float* hp, int n_hp) {{
  (void)offs;
  GenFlux::Params k;
  for (int i = 0; i < GenFlux::kHost; ++i) k.hp[i] = i < n_hp ? hp[i] : 0.f;
  for (long long r = 0; r < L; ++r) {{
    float c[1][GenFlux::kIn];
    GenFlux::load_cell(in, r, c[0]);
    GenFlux::Carry a[1];
    GenFlux::init(a[0], c[0], k, nullptr);
    GenSlots::run<GenFlux, 1>(a, c, k, nullptr, HostNbr{{in, nbr + r * S}},
                              HostMask{{nbr + r * S}});
    float o[GenFlux::kOut];
    GenFlux::finish(o, a[0], c[0], k, nullptr);
    GenFlux::store(out, r, o);
  }}
}}
"""


def gxx_specialised(flux, table):
    """The functor and ``table``'s specialised slot sequence
    (``flux.slots_text(table)``, the text the tiled routes compile),
    built as host code by g++ with the ``run`` entry point of
    :func:`gxx_library`; None without g++."""
    return _gxx(_HOST_SLOTS.format(functor=flux.text,
                                   slots=flux.slots_text(table)))
