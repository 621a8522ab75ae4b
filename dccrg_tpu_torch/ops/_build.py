"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each source in ``dccrg_tpu_torch/csrc/`` has a plain C entry point, so
it compiles with ``nvcc`` alone, without PyTorch's headers (seconds,
where an extension that includes them takes minutes). The shared
library goes into ``dccrg_tpu_torch/_build/`` (git-ignored), named by a
hash of the source and the flags, so an edited source is never served
from a stale build (the hash covers the ``.cuh`` headers a source
includes, such as the flux functors of ``csrc/fluxes.cuh``); a
warm-start cache (``DCCRG_COMPILE_CACHE``) moves
it to the cache's ``build/`` with :func:`set_build_dir`. Nothing is
compiled or loaded on import: the first CUDA call of a kernel builds
it, and ``build`` compiles several sources at once, one ``nvcc``
process each, all started together.

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


def _headers(src: Path) -> list:
    """The ``csrc`` headers ``src`` includes with quotes, and theirs,
    each once, in the order first met."""
    seen, todo = [], [src]
    while todo:
        for inc in _INCLUDE.findall(todo.pop(0).read_bytes()):
            h = CSRC / inc.decode()
            if h not in seen:
                seen.append(h)
                todo.append(h)
    return seen


def library_name(name: str) -> str:
    """File name of source ``name``'s library: ``lib<name>-<hash>.so``,
    the hash over the source, every ``csrc`` header it includes and the
    flags, so an edited header is never served from a stale build."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for h in _headers(src):
        digest.update(h.name.encode() + b"\0" + h.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return f"lib{name}-{digest.hexdigest()[:16]}.so"


def _target(name: str):
    return CSRC / f"{name}.cu", BUILD_DIR / library_name(name)


def build(names) -> dict:
    """Compile every named source whose library is missing, one nvcc
    process per source, all running at once. Waits for all of them and
    raises if any failed. Returns ``{name: compiler output}`` for the
    sources compiled by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        src, so = _target(name)
        if so.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, so)
    logs, failed = {}, []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


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
