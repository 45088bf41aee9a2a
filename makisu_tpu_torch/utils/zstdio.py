"""Streaming zstd over the system libzstd via ctypes: decode and encode.

Copy of ``makisu_tpu/utils/zstdio.py``. The read side (``available``,
``is_zstd``, ``ZstdReader``): registries publish base-image layers as
``application/vnd.oci.image.layer.v1.tar+zstd``, and ``tario.gzip_reader``
routes such a blob here by its frame magic. The write side (``compress``,
``decompress``, ``ZstdWriter``) serves the seekable pack plane
(``serve/recipe.py``): packs are re-encoded as independently decodable
frames, so a ranged span fetch decompresses without upstream context.
Python's stdlib has no zstd before 3.14 and nothing may be installed, so
this binds the handful of ``ZSTD_*`` calls of ``libzstd.so.1``; a host
without the library reports ``available() == False``: the registry client
refuses zstd layers up front and packs serve raw only. Layers this
builder writes stay deterministic gzip; zstd output never enters a layer
digest.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import io
import threading

# Zstandard frame magic (RFC 8878 §3.1.1).
MAGIC = b"\x28\xb5\x2f\xfd"

_lib = None
_lib_mu = threading.Lock()
_lib_failed = False


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p),
                ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p),
                ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _load():
    """Resolve libzstd once per process; None when it is absent."""
    global _lib, _lib_failed
    with _lib_mu:
        if _lib is not None or _lib_failed:
            return _lib
        name = ctypes.util.find_library("zstd") or "libzstd.so.1"
        try:
            lib = ctypes.CDLL(name)
            lib.ZSTD_createDStream.restype = ctypes.c_void_p
            lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
            lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
            lib.ZSTD_initDStream.restype = ctypes.c_size_t
            lib.ZSTD_decompressStream.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(_OutBuffer),
                ctypes.POINTER(_InBuffer)]
            lib.ZSTD_decompressStream.restype = ctypes.c_size_t
            lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
            lib.ZSTD_getErrorName.restype = ctypes.c_char_p
            lib.ZSTD_DStreamInSize.restype = ctypes.c_size_t
            lib.ZSTD_DStreamOutSize.restype = ctypes.c_size_t
            # The compress side (streaming and one-shot); every
            # libzstd.so.1 since 1.4 exports these.
            lib.ZSTD_createCStream.restype = ctypes.c_void_p
            lib.ZSTD_freeCStream.argtypes = [ctypes.c_void_p]
            lib.ZSTD_initCStream.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.ZSTD_initCStream.restype = ctypes.c_size_t
            lib.ZSTD_compressStream2.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(_OutBuffer),
                ctypes.POINTER(_InBuffer), ctypes.c_int]
            lib.ZSTD_compressStream2.restype = ctypes.c_size_t
            lib.ZSTD_CStreamInSize.restype = ctypes.c_size_t
            lib.ZSTD_CStreamOutSize.restype = ctypes.c_size_t
            lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
            lib.ZSTD_compressBound.restype = ctypes.c_size_t
            lib.ZSTD_compress.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                ctypes.c_size_t, ctypes.c_int]
            lib.ZSTD_compress.restype = ctypes.c_size_t
            lib.ZSTD_decompress.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                ctypes.c_size_t]
            lib.ZSTD_decompress.restype = ctypes.c_size_t
            _lib = lib
        except (OSError, AttributeError):
            _lib_failed = True
        return _lib


# ZSTD_EndDirective values for ZSTD_compressStream2.
_ZSTD_E_CONTINUE = 0
_ZSTD_E_END = 2


def available() -> bool:
    """Whether zstd works in this process."""
    return _load() is not None


def is_zstd(prefix: bytes) -> bool:
    """Magic sniff on the first bytes of a blob."""
    return prefix[:4] == MAGIC


class ZstdReader(io.RawIOBase):
    """Read-only streaming decompressor over an inner file object.

    Memory stays bounded by libzstd's recommended buffer pair whatever
    the blob's size; a truncated or corrupt frame raises ``ValueError``,
    never a short read (a short layer tar would corrupt the tree it is
    applied onto)."""

    def __init__(self, fileobj) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("libzstd is not available in this process")
        self._lib = lib
        self._fh = fileobj
        self._stream = lib.ZSTD_createDStream()
        if not self._stream:
            raise MemoryError("ZSTD_createDStream failed")
        self._check(lib.ZSTD_initDStream(self._stream))
        self._in_cap = int(lib.ZSTD_DStreamInSize())
        self._out_cap = int(lib.ZSTD_DStreamOutSize())
        self._in_buf = ctypes.create_string_buffer(self._in_cap)
        self._out_buf = ctypes.create_string_buffer(self._out_cap)
        self._in = _InBuffer(
            ctypes.cast(self._in_buf, ctypes.c_void_p), 0, 0)
        # Decoded-but-unread bytes and a read offset into them, so small
        # reads (tarfile's 10 KiB blocks) do not re-copy the tail.
        self._pending = bytearray()
        self._poff = 0
        self._eof = False
        # Nonzero between rounds means "mid-frame": a truncated input.
        self._last_rc = 0

    def _check(self, rc: int) -> int:
        if self._lib.ZSTD_isError(rc):
            raise ValueError(
                "zstd decode failed: "
                + self._lib.ZSTD_getErrorName(rc).decode(errors="replace"))
        return rc

    def readable(self) -> bool:
        return True

    def _fill(self) -> bool:
        """Refill the input buffer; False at inner EOF with nothing
        buffered."""
        if self._in.pos < self._in.size:
            return True
        chunk = self._fh.read(self._in_cap)
        if not chunk:
            return False
        ctypes.memmove(self._in_buf, chunk, len(chunk))
        self._in.size = len(chunk)
        self._in.pos = 0
        return True

    def _decode_more(self) -> bytes:
        """One decode round; b"" only at a clean EOF."""
        while True:
            if not self._fill():
                if self._last_rc != 0:
                    raise ValueError("zstd stream truncated mid-frame")
                self._eof = True
                return b""
            out = _OutBuffer(ctypes.cast(self._out_buf, ctypes.c_void_p),
                             self._out_cap, 0)
            rc = self._check(self._lib.ZSTD_decompressStream(
                self._stream, ctypes.byref(out), ctypes.byref(self._in)))
            self._last_rc = rc
            if out.pos:
                return ctypes.string_at(self._out_buf, out.pos)

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            pieces = [bytes(memoryview(self._pending)[self._poff:])]
            self._pending = bytearray()
            self._poff = 0
            while not self._eof:
                pieces.append(self._decode_more())
            return b"".join(pieces)
        while len(self._pending) - self._poff < n and not self._eof:
            chunk = self._decode_more()
            if chunk:
                if self._poff:
                    del self._pending[:self._poff]
                    self._poff = 0
                self._pending += chunk
        end = min(self._poff + n, len(self._pending))
        out = bytes(memoryview(self._pending)[self._poff:end])
        self._poff = end
        if self._poff == len(self._pending):
            self._pending = bytearray()
            self._poff = 0
        return out

    def close(self) -> None:
        if getattr(self, "_stream", None):
            self._lib.ZSTD_freeDStream(self._stream)
            self._stream = None
        super().close()

    def __enter__(self) -> "ZstdReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# Pack frames' compression level: zstd's own default, most of the ratio
# for a fraction of the higher levels' CPU (every indexed layer pays it
# once, at publish).
DEFAULT_LEVEL = 3


def compress(data: bytes, level: int = DEFAULT_LEVEL) -> bytes:
    """One-shot compression into a single complete zstd frame (the
    seekable pack's frame encoder: each frame decodes on its own)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libzstd is not available in this process")
    bound = int(lib.ZSTD_compressBound(len(data)))
    dst = ctypes.create_string_buffer(bound)
    rc = lib.ZSTD_compress(ctypes.cast(dst, ctypes.c_void_p), bound,
                           data, len(data), level)
    if lib.ZSTD_isError(rc):
        raise ValueError(
            "zstd compress failed: "
            + lib.ZSTD_getErrorName(rc).decode(errors="replace"))
    return dst.raw[:rc]


def decompress(data: bytes, expected_size: int) -> bytes:
    """One-shot decompression of one frame to exactly ``expected_size``
    bytes. A truncated, corrupt or wrong-sized frame raises
    ``ValueError``: the pack-frame consumer drops such a span, never
    installs short bytes."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libzstd is not available in this process")
    dst = ctypes.create_string_buffer(max(expected_size, 1))
    rc = lib.ZSTD_decompress(ctypes.cast(dst, ctypes.c_void_p),
                             expected_size, data, len(data))
    if lib.ZSTD_isError(rc):
        raise ValueError(
            "zstd decode failed: "
            + lib.ZSTD_getErrorName(rc).decode(errors="replace"))
    if rc != expected_size:
        raise ValueError(
            f"zstd frame decoded to {rc} bytes, expected {expected_size}")
    return dst.raw[:expected_size]


class ZstdWriter:
    """Write-only streaming compressor over an inner file object, the
    mirror of :class:`ZstdReader`: memory bounded by libzstd's buffer
    whatever the stream's size, one frame per writer, ended by
    ``close()`` (a writer abandoned before it leaves a truncated frame,
    which ZstdReader refuses)."""

    def __init__(self, fileobj, level: int = DEFAULT_LEVEL) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("libzstd is not available in this process")
        self._lib = lib
        self._fh = fileobj
        self._stream = lib.ZSTD_createCStream()
        if not self._stream:
            raise MemoryError("ZSTD_createCStream failed")
        self._check(lib.ZSTD_initCStream(self._stream, level))
        self._out_cap = int(lib.ZSTD_CStreamOutSize())
        self._out_buf = ctypes.create_string_buffer(self._out_cap)
        self._closed = False
        self.compressed_size = 0  # bytes written downstream
        self.raw_size = 0         # bytes accepted

    def _check(self, rc: int) -> int:
        if self._lib.ZSTD_isError(rc):
            raise ValueError(
                "zstd encode failed: "
                + self._lib.ZSTD_getErrorName(rc).decode(errors="replace"))
        return rc

    def _round(self, inbuf, directive: int) -> int:
        out = _OutBuffer(ctypes.cast(self._out_buf, ctypes.c_void_p),
                         self._out_cap, 0)
        rc = self._check(self._lib.ZSTD_compressStream2(
            self._stream, ctypes.byref(out), ctypes.byref(inbuf), directive))
        if out.pos:
            self._fh.write(ctypes.string_at(self._out_buf, out.pos))
            self.compressed_size += out.pos
        return rc

    def write(self, data) -> int:
        if self._closed:
            raise ValueError("write to a closed ZstdWriter")
        data = bytes(data)
        self.raw_size += len(data)
        inbuf = _InBuffer(ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p),
                          len(data), 0)
        while inbuf.pos < inbuf.size:
            self._round(inbuf, _ZSTD_E_CONTINUE)
        return len(data)

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        inbuf = _InBuffer(None, 0, 0)
        while self._round(inbuf, _ZSTD_E_END) != 0:
            pass
        self._lib.ZSTD_freeCStream(self._stream)
        self._stream = None

    def __del__(self) -> None:
        if getattr(self, "_stream", None):
            self._lib.ZSTD_freeCStream(self._stream)
            self._stream = None

    def __enter__(self) -> "ZstdWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
