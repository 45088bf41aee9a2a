"""ctypes bindings of the port's native host pipeline (``csrc/``).

``LayerSinkHandle``: the native layer-commit pipeline
(``csrc/layersink.cpp``): tar content framing, both SHA-256 digests and
deterministic gzip in one C++ pass, with file content read in C++, and a
tap that hands every uncompressed tar byte to the chunk session.
``deflate_blocks``: the pgzip block codec (``csrc/pgzip.cpp``), one
interpreter-lock-free call per lane batch of ``tario.BlockGzipWriter``.

Counterpart of the part of ``makisu_tpu/native.py`` that the layer sink
and ``tario`` use. Both libraries build with g++ on first use into
``build/torch_kernels/`` (``ops/_build.py``); a compile that fails
raises with the compiler's output. A host without ``g++`` on PATH has
no native library: that is logged once at warning level, and the commit
takes the Python sink and the stdlib codec, as ``makisu_tpu`` does on a
host without its toolchain. Every route writes the same bytes, except
that ``--gzip-backend auto`` is pgzip only where the library loads.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time

from makisu_tpu_torch.ops import _build
from makisu_tpu_torch.utils import logging as log

ABI_VERSION = 1
DEFAULT_BLOCK = 128 * 1024

# Tap callback: (data_ptr, nbytes, user) — the uncompressed tar stream,
# called synchronously from the native pipeline on the writer's thread.
_TAP_FN = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_uint8),
                           ctypes.c_size_t, ctypes.c_void_p)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_warned = False


def _bind_pgzip(lib: ctypes.CDLL) -> None:
    lib.pgz_blocks.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.pgz_blocks.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_size_t,
        ctypes.c_int, ctypes.POINTER(ctypes.c_size_t)]
    lib.pgz_free.restype = None
    lib.pgz_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.pgz_abi_version.restype = ctypes.c_int
    lib.pgz_abi_version.argtypes = []
    if lib.pgz_abi_version() != ABI_VERSION:
        raise RuntimeError("pgzip library ABI mismatch")


def _bind_layersink(lib: ctypes.CDLL) -> None:
    lib.lsk_new.restype = ctypes.c_void_p
    lib.lsk_new.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_size_t, ctypes.c_int]
    lib.lsk_write.restype = ctypes.c_int
    lib.lsk_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_size_t]
    lib.lsk_write_file.restype = ctypes.c_int
    lib.lsk_write_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint64]
    lib.lsk_set_tap.restype = None
    lib.lsk_set_tap.argtypes = [ctypes.c_void_p, _TAP_FN, ctypes.c_void_p]
    lib.lsk_finish.restype = ctypes.c_int
    lib.lsk_finish.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.lsk_free.restype = None
    lib.lsk_free.argtypes = [ctypes.c_void_p]
    lib.lsk_abi_version.restype = ctypes.c_int
    lib.lsk_abi_version.argtypes = []
    # zlib's own version string, from the zlib the library linked.
    lib.zlibVersion.restype = ctypes.c_char_p
    lib.zlibVersion.argtypes = []
    if lib.lsk_abi_version() != ABI_VERSION:
        raise RuntimeError("layersink library ABI mismatch")


_BIND = {"pgzip": _bind_pgzip, "layersink": _bind_layersink}


def _load(name: str) -> ctypes.CDLL | None:
    """The bound library ``name`` (built on first use), or None on a host
    without g++."""
    global _warned
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if _build.gxx() is None:
            if not _warned:
                _warned = True
                log.warning("no g++ on PATH: the native layer sink and "
                            "pgzip codec are unavailable; layers commit "
                            "through the Python sink")
            return None
        lib = _build.library(name)
        _BIND[name](lib)
        _libs[name] = lib
        return lib


def pgzip_available() -> bool:
    """Whether the pgzip block codec loads (``--gzip-backend auto``'s
    criterion, as in ``makisu_tpu``)."""
    return _load("pgzip") is not None


def layersink_available() -> bool:
    return _load("layersink") is not None


def zlib_version() -> str:
    """The version of the zlib the native libraries linked."""
    lib = _load("layersink")
    if lib is None:
        raise RuntimeError("native layer sink unavailable: no g++ on PATH")
    return lib.zlibVersion().decode()


def deflate_blocks(data: bytes, level: int, block_size: int,
                   last: bool) -> bytes:
    """``data`` as consecutive ``block_size`` raw-deflate slices
    (sync-flush terminated; the final slice Z_FINISH when ``last``) in
    one call that releases the interpreter lock: one lane batch of
    ``tario.BlockGzipWriter``. Byte-identical to
    ``tario._py_deflate_blocks``."""
    lib = _load("pgzip")
    if lib is None:
        raise RuntimeError("pgzip library unavailable: no g++ on PATH")
    out_n = ctypes.c_size_t(0)
    buf = lib.pgz_blocks(data, len(data), level, block_size,
                         1 if last else 0, ctypes.byref(out_n))
    if not buf:
        raise RuntimeError("pgz_blocks failed")
    try:
        return ctypes.string_at(buf, out_n.value)
    finally:
        lib.pgz_free(buf)


class LayerSinkHandle:
    """One native layer-commit pipeline bound to an output fd.

    ``native_seconds`` is the wall time spent inside the C++ calls and
    ``tap_seconds`` the part of it spent in the tap."""

    def __init__(self, out_fd: int, backend: str, level: int,
                 block_size: int = DEFAULT_BLOCK,
                 nthreads: int | None = None) -> None:
        self._handle = None
        lib = _load("layersink")
        if lib is None:
            raise RuntimeError("native layer sink unavailable: no g++ on "
                               "PATH")
        self._lib = lib
        if nthreads is None:
            nthreads = os.cpu_count() or 1
        self._handle = lib.lsk_new(out_fd, 1 if backend == "pgzip" else 0,
                                   level, block_size, nthreads)
        if not self._handle:
            raise RuntimeError("lsk_new failed")
        self._tap_error: list[BaseException] = []
        self.native_seconds = 0.0
        self.tap_seconds = 0.0

    def _live(self):
        if not self._handle:
            raise RuntimeError("native layer sink already closed")
        return self._handle

    def set_tap(self, fn, data: bool = True) -> None:
        """Stream every uncompressed tar byte to ``fn(bytes)`` as well, in
        order, in pieces of up to 1 MiB (``csrc/layersink.cpp`` batches
        them; the chunk session cuts the same chunks whatever the
        pieces). With ``data=False`` the tap is told only that a piece
        went by: ``fn()``, with no copy of the bytes into Python. The
        CFUNCTYPE wrapper is pinned on self so the callback outlives the
        ctypes call.

        ctypes callbacks cannot propagate exceptions into C: a failure is
        recorded and re-raised by the next write, write_file or finish,
        so a failing chunk session fails the commit instead of leaving a
        layer with missing or wrong (cache-identity-bearing) chunks."""

        def trampoline(ptr, n, _user):
            if self._tap_error:
                return  # already failed; drain quietly until re-raised
            t0 = time.perf_counter()
            try:
                if data:
                    fn(ctypes.string_at(ptr, n))
                else:
                    fn()
            except BaseException as e:  # noqa: BLE001 - re-raised later
                self._tap_error.append(e)
            self.tap_seconds += time.perf_counter() - t0
        self._tap_ref = _TAP_FN(trampoline)  # keep alive
        self._lib.lsk_set_tap(self._live(), self._tap_ref, None)

    def _check_tap(self) -> None:
        if self._tap_error:
            raise RuntimeError("layer chunk tap failed") \
                from self._tap_error[0]

    def write(self, data: bytes) -> None:
        t0 = time.perf_counter()
        rc = self._lib.lsk_write(self._live(), data, len(data))
        self.native_seconds += time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError("native layer sink write failed")
        self._check_tap()

    def write_file(self, path: str, size: int) -> None:
        t0 = time.perf_counter()
        rc = self._lib.lsk_write_file(self._live(), os.fsencode(path), size)
        self.native_seconds += time.perf_counter() - t0
        if rc == -2:
            raise OSError(f"native layer sink could not read {path}")
        if rc == -3:
            raise OSError(f"{path} shrank below its header size {size}")
        if rc != 0:
            raise RuntimeError("native layer sink write failed")
        # After the rc checks: a tap failure must not mask the
        # root-cause file error above.
        self._check_tap()

    def finish(self) -> tuple[str, str, int, int]:
        """Returns (tar_sha_hex, gzip_sha_hex, gzip_size, tar_size)."""
        tar_sha = (ctypes.c_uint8 * 32)()
        gz_sha = (ctypes.c_uint8 * 32)()
        gz_size = ctypes.c_uint64(0)
        tar_size = ctypes.c_uint64(0)
        t0 = time.perf_counter()
        rc = self._lib.lsk_finish(self._live(), tar_sha, gz_sha,
                                  ctypes.byref(gz_size),
                                  ctypes.byref(tar_size))
        self.native_seconds += time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError("native layer sink finish failed")
        self._check_tap()  # the last piece reaches the tap in lsk_finish
        return (bytes(tar_sha).hex(), bytes(gz_sha).hex(),
                gz_size.value, tar_size.value)

    def close(self) -> None:
        if self._handle:
            self._lib.lsk_free(self._handle)
            self._handle = None

    def __del__(self) -> None:
        self.close()
