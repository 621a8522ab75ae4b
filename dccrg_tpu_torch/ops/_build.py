"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each source in ``dccrg_tpu_torch/csrc/`` has a plain C entry point, so
it compiles with ``nvcc`` alone, without PyTorch's headers (seconds,
where an extension that includes them takes minutes). The shared
library goes into ``dccrg_tpu_torch/_build/`` (git-ignored), named by a
hash of the source and the flags, so an edited source is never served
from a stale build (the hash covers the ``.cuh`` headers a source
includes, such as the flux functors of ``csrc/fluxes.cuh``). A flux
generated from a user's slot functions (``ops/flux_gen.py``) is a
source text written into the build directory as ``gen-<hash>.cu``, the
hash over its text, headers and flags, and built the same way; a
warm-start cache (``DCCRG_COMPILE_CACHE``) moves
it to the cache's ``build/`` with :func:`set_build_dir`. Nothing is
compiled or loaded on import: the first CUDA call of a kernel builds
it, and ``build`` compiles several sources at once, one ``nvcc``
process each, all started together (``start`` and ``finish`` split the
start from the wait).

``--fmad=false`` keeps every float32 multiply and add separately
rounded, as PyTorch's elementwise kernels and the reference package's
XLA code round them, so a kernel can agree with its plain PyTorch
version bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def set_build_dir(path) -> Path:
    """Point later builds and loads at ``path`` (the warm-start cache's
    ``build/``, shared by the processes of one host); returns the
    directory it replaces. A library already loaded stays loaded."""
    global BUILD_DIR
    old, BUILD_DIR = BUILD_DIR, Path(path)
    return old


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.M)


def _headers(src) -> list:
    """The ``csrc`` headers a source (a path, or its text as bytes)
    includes with quotes, and theirs, each once, in the order first
    met."""
    seen = []
    todo = [src if isinstance(src, bytes) else Path(src).read_bytes()]
    while todo:
        for inc in _INCLUDE.findall(todo.pop(0)):
            h = CSRC / inc.decode()
            if h not in seen:
                seen.append(h)
                todo.append(h.read_bytes())
    return seen


def _digest(text: bytes) -> str:
    """Hash of a source's text, every ``csrc`` header it includes and
    the flags."""
    digest = hashlib.sha256(text)
    for h in _headers(text):
        digest.update(h.name.encode() + b"\0" + h.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def library_name(name: str) -> str:
    """File name of source ``name``'s library: ``lib<name>-<hash>.so``,
    the hash over the source, every ``csrc`` header it includes and the
    flags, so an edited header is never served from a stale build."""
    return f"lib{name}-{_digest((CSRC / f'{name}.cu').read_bytes())}.so"


def generated_name(text: str) -> str:
    """The name of a generated source (a flux functor of
    ``ops/flux_gen.py`` in its kernel template): ``gen-<hash>``, the
    hash over its text, the ``csrc`` headers it includes and the
    flags."""
    return f"gen-{_digest(text.encode())}"


def _target(name: str):
    if name.startswith("gen-"):
        return BUILD_DIR / f"{name}.cu", BUILD_DIR / f"lib{name}.so"
    return CSRC / f"{name}.cu", BUILD_DIR / library_name(name)


def write_generated(text: str) -> str:
    """Write a generated source into the build directory (once) and
    return its name, for :func:`build` and :func:`load`."""
    name = generated_name(text)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"{name}.cu"
    if not src.exists():
        tmp = src.with_name(f"{src.name}.{os.getpid()}.tmp")
        tmp.write_text(text)
        os.replace(tmp, src)
    return name


def _ended(proc, t0, took):
    """Wait for ``proc`` and record its seconds since ``t0`` in
    ``took``: the time it ended, however late :func:`finish` asks."""
    proc.wait()
    took.append(time.perf_counter() - t0)


def start(names) -> dict:
    """Start one nvcc process for each named source whose library is
    missing (a generated source by the name :func:`write_generated`
    gave it), all at once, and return them for :func:`finish`. A thread
    a process waits for it, to time it where it ends."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        src, so = _target(name)
        if so.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        out = open(so.with_name(f"{so.name}.{os.getpid()}.log"), "w+")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
            stdout=out, stderr=subprocess.STDOUT, text=True)
        took = []
        waiter = threading.Thread(target=_ended, args=(proc, t0, took),
                                  daemon=True)
        waiter.start()
        procs[name] = (proc, tmp, so, out, waiter, took)
    return procs


def finish(procs, seconds=None) -> dict:
    """Wait for the processes :func:`start` returned and raise if any
    failed. Returns ``{name: compiler output}``; ``seconds``, a dict
    where given, gets each source's compile seconds (from its start to
    the end of its process)."""
    for name, (*_r, waiter, took) in procs.items():
        waiter.join()
        if seconds is not None:
            seconds[name] = took[0]
    logs, failed = {}, []
    for name, (proc, tmp, so, out, _w, _t) in procs.items():
        out.seek(0)
        logs[name] = out.read()
        out.close()
        os.unlink(out.name)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def build(names) -> dict:
    """Compile every named source whose library is missing, one nvcc
    process per source, all running at once (:func:`start`), and wait
    for all of them (:func:`finish`): ``{name: compiler output}`` for
    the sources compiled by this call."""
    return finish(start(names))


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of source ``name`` (built first if needed),
    with ``signatures`` = ``{function: (restype, [argtypes])}``
    declared on it."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)[1]))
            for fn, (restype, argtypes) in signatures.items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _libs[name] = lib
        return lib


def check(lib, prefix: str, code: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = getattr(lib, f"{prefix}_error_string")(code)
        raise RuntimeError(f"{prefix}: CUDA error {code}: {msg.decode()}")
