"""Build the package's native libraries on first use and load them with
ctypes: the CUDA kernels with nvcc, the host commit pipeline with g++.

Each library compiles from ``csrc/`` into its own shared library with a
plain C interface under ``build/torch_kernels/`` at the root of the
checkout. A library's file name carries a hash of its sources and the
compiler flags, so a changed source rebuilds and an unchanged one loads
as it is. Missing libraries compile in parallel, one compiler per
library. A build failure raises with the compiler's output. The
compiler's report of each built library (for the kernels, ptxas's
registers, shared memory and spills) is kept beside it, so a run that
loads a library built earlier can still read it (``ptxas_log``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / \
    "torch_kernels"
# Library name -> the sources it is built from; the first one compiles.
# The CUDA kernels (nvcc):
SOURCES = {"gear": ("gear.cu",), "sha256": ("sha256.cu",)}
# The layer sink and the pgzip block codec (g++, the flags of makisu_tpu's
# native/Makefile):
HOST_SOURCES = {
    "pgzip": ("pgzip.cpp", "deflate_common.h"),
    "layersink": ("layersink.cpp", "deflate_common.h", "sha256_common.h"),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
GXX_LIBS = ("-lz", "-lpthread", "-ldl")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (put nvcc on PATH or set CUDA_HOME)")


def gxx() -> str | None:
    """The host C++ compiler on PATH, or None on a host without one."""
    return shutil.which("g++")


def _sources(name: str) -> tuple[str, ...]:
    return SOURCES.get(name) or HOST_SOURCES[name]


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS if name in SOURCES else GXX_FLAGS + GXX_LIBS


def library_path(name: str) -> pathlib.Path:
    key = hashlib.sha256()
    for src in _sources(name):
        key.update((CSRC / src).read_bytes())
    key.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def _command(name: str, out: pathlib.Path) -> list[str]:
    src = str(CSRC / _sources(name)[0])
    if name in SOURCES:
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), src]
    compiler = gxx()
    if compiler is None:
        raise RuntimeError("g++ not found: the native layer sink needs a "
                           "C++ compiler on PATH")
    return [compiler, *GXX_FLAGS, src, "-o", str(out), *GXX_LIBS]


def build_all(names=None) -> list[str]:
    """Compile every library of ``names`` (default: all, kernels and
    host libraries) that is missing, all at once. Returns the names
    built (empty when all were already on disk)."""
    if names is None:
        names = [*SOURCES, *HOST_SOURCES]
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, tmp, subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        src = _sources(name)[0]
        if proc.returncode:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            library_path(name).with_suffix(".log").write_text(log)
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("native build failed:\n" + "\n".join(failed))
    return todo


def ptxas_log(name: str) -> str:
    """The compiler's report for the current build of library ``name``
    (empty when the library is missing)."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built on first use together with the
    other missing libraries of its compiler."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all(SOURCES if name in SOURCES else HOST_SOURCES)
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
