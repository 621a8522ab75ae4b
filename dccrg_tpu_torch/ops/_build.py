"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each source in ``dccrg_tpu_torch/csrc/`` has a plain C entry point, so
it compiles with ``nvcc`` alone, without PyTorch's headers (seconds,
where an extension that includes them takes minutes). The shared
library goes into ``dccrg_tpu_torch/_build/`` (git-ignored), named by a
hash of the source and the flags, so an edited source is never served
from a stale build. Nothing is compiled or loaded on import: the first
CUDA call of a kernel builds it, and ``build`` compiles several sources
at once, one ``nvcc`` process each, all started together.

``--fmad=false`` keeps every float32 multiply and add separately
rounded, as PyTorch's elementwise kernels and the reference package's
XLA code round them, so a kernel can agree with its plain PyTorch
version bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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


def _target(name: str):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


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
