"""Layer-tar I/O: deterministic gzip (zlib and the pgzip block format),
the blob-digest tap, the layer-blob reader, and tar header
apply/compare/write.

Copies of ``makisu_tpu/tario.py``'s ``TeeDigest``, ``COMPRESSION_LEVELS``,
the backend-id helpers (``gzip_backend_id``, ``parse_backend_id``,
``backend_id_usable``, ``resolve_backend``, ``make_backend_id``), the
``pgzip`` block writer (``BlockGzipWriter`` over ``_deflate_blocks``),
``gzip_writer``, ``gzip_reader`` and the header helpers. Gzip output is
part of a layer's registry identity, so both writers pin mtime=0 and omit
the filename: identical tar bytes at the same backend id always give
identical gzip bytes.

The pgzip block codec is the port's native one (``native.deflate_blocks``,
``csrc/pgzip.cpp``) wherever it loads, else the stdlib zlib one
(``_py_deflate_blocks``): the same bytes either way. As in the
reference, ``resolve_backend("auto")`` is ``pgzip`` where the native
codec loads and ``zlib`` on a host without g++; every backend id either
package writes is replayed here byte for byte.
"""

from __future__ import annotations

import gzip
import hashlib
import io
import os
import tarfile
import threading
import time
import zlib
from typing import BinaryIO

# Compression levels of the ``--compression`` flag (reference:
# tario.CompressionLevel, gzip.go:26-47).
COMPRESSION_LEVELS = {"no": 0, "speed": 1, "default": 6, "size": 9}
DEFAULT_LEVEL = COMPRESSION_LEVELS["default"]
# Block size of the pgzip format (its backend id records it).
PGZIP_BLOCK = 128 * 1024


class TeeDigest:
    """File-like fanning writes to a sha256 digest and an underlying
    file (the layer sink's gzip-digest tap)."""

    def __init__(self, out: BinaryIO) -> None:
        self.out = out
        self.digest = hashlib.sha256()
        self.size = 0

    def write(self, data: bytes) -> int:
        self.digest.update(data)
        self.size += len(data)
        return self.out.write(data)

    def flush(self) -> None:
        self.out.flush()


def _validate_backend(name: str) -> None:
    if name not in ("zlib", "pgzip"):
        raise ValueError(f"unknown gzip backend {name!r}")


def gzip_backend_id(level: int = DEFAULT_LEVEL,
                    backend: str = "zlib") -> str:
    """The one format site of backend-id strings (recorded in cache
    entries, parsed back by gzip_writer)."""
    if backend == "pgzip":
        return f"pgzip-{level}-{PGZIP_BLOCK}"
    return f"zlib-{level}"


def parse_backend_id(backend_id: str) -> tuple[str, int, int]:
    """``zlib-<level>`` or ``pgzip-<level>-<block>`` -> (backend, level,
    block), block 0 for zlib. Shared by acceptance (backend_id_usable)
    and replay (gzip_writer), so an id accepted is one replay can parse.
    Raises ValueError (or IndexError on a truncated id) otherwise."""
    parts = backend_id.split("-")
    _validate_backend(parts[0])
    level = int(parts[1])
    if not 0 <= level <= 9:
        raise ValueError(f"gzip level {level} out of range in "
                         f"{backend_id!r}")
    block = 0
    if parts[0] == "pgzip":
        block = int(parts[2])
        if block <= 0:
            raise ValueError(f"pgzip block {block} invalid in "
                             f"{backend_id!r}")
    return parts[0], level, block


def backend_id_usable(backend_id: str | None) -> bool:
    """True when ``gzip_writer`` can replay ``backend_id`` byte for byte:
    a well-formed zlib or pgzip id. No id at all (the producing settings
    are unknown) and a malformed id are not."""
    if backend_id is None:
        return False
    try:
        parse_backend_id(backend_id)
    except (ValueError, IndexError):
        return False
    return True


def resolve_backend(name: str) -> str:
    """``auto`` -> the concrete backend: pgzip where the native block
    codec loads, else zlib (the reference's criterion). Only concrete
    backends enter backend ids."""
    if name != "auto":
        return name
    from makisu_tpu_torch import native
    return "pgzip" if native.pgzip_available() else "zlib"


def make_backend_id(backend: str, level_name: str) -> str:
    """Validate a (``--gzip-backend``, ``--compression``) flag pair into
    a backend id, the same string ``makisu_tpu``'s ``make_backend_id``
    gives. Accepts ``auto`` (resolve_backend)."""
    backend = resolve_backend(backend)
    _validate_backend(backend)
    if level_name not in COMPRESSION_LEVELS:
        raise ValueError(
            f"invalid compression level {level_name!r}; "
            f"one of {sorted(COMPRESSION_LEVELS)}")
    return gzip_backend_id(COMPRESSION_LEVELS[level_name], backend)


class _BlockBuffer:
    """Fixed-granularity re-blocking: output whose framing depends on
    write sizes (zlib level-0 stored blocks, pgzip's per-block slices)
    becomes a pure function of content once the compressor is fed in
    exactly ``granularity``-sized blocks, whoever writes."""

    def __init__(self, granularity: int) -> None:
        if granularity <= 0:
            raise ValueError("granularity must be positive")
        self.granularity = granularity
        self._buf = bytearray()

    def feed(self, data) -> list[bytes]:
        """Absorb ``data``; return the complete blocks now available."""
        self._buf += data
        g = self.granularity
        blocks = []
        while len(self._buf) >= g:
            blocks.append(bytes(self._buf[:g]))
            del self._buf[:g]
        return blocks

    def tail(self) -> bytes:
        """Drain the final partial block (stream end)."""
        t = bytes(self._buf)
        self._buf.clear()
        return t


class _FixedGranularityWriter:
    """Feeds the zlib compressor in fixed 64 KiB blocks (the level-0
    stored-block determinism fix; see _BlockBuffer)."""

    GRANULARITY = 64 * 1024

    def __init__(self, gz) -> None:
        self._gz = gz
        self._blocks = _BlockBuffer(self.GRANULARITY)

    def write(self, data: bytes) -> int:
        for block in self._blocks.feed(data):
            self._gz.write(block)
        return len(data)

    def close(self) -> None:
        tail = self._blocks.tail()
        if tail:
            self._gz.write(tail)
        self._gz.close()

    def flush(self) -> None:
        pass

    def __enter__(self) -> "_FixedGranularityWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# Gzip member header of the pgzip block format: deflate, no flags,
# mtime 0, XFL 0, OS 255.
_PGZIP_HEADER = bytes([0x1f, 0x8b, 0x08, 0, 0, 0, 0, 0, 0, 0xff])


def _py_deflate_blocks(data: bytes, level: int, block_size: int,
                       last: bool) -> bytes:
    """The pgzip block codec: ``data`` as consecutive ``block_size``
    raw-deflate slices, each ended by a sync flush; a final batch
    (``last``) also emits the ``len(data) % block_size`` tail bytes
    (possibly none) as the Z_FINISH slice. One compressor per block
    (windowBits -15, memLevel 8, default strategy), so each slice is a
    pure function of its block: the reference's native codec emits the
    same bytes."""
    n = len(data)
    nfull = n // block_size
    if not last and nfull * block_size != n:
        raise ValueError("non-final batches must be whole blocks")
    nblocks = nfull + 1 if last else nfull
    if nblocks == 0:
        raise ValueError("empty non-final batch")
    out = []
    for i in range(nblocks):
        co = zlib.compressobj(level, zlib.DEFLATED, -15, 8,
                              zlib.Z_DEFAULT_STRATEGY)
        piece = co.compress(data[i * block_size:(i + 1) * block_size])
        fin = last and i + 1 == nblocks
        piece += co.flush(zlib.Z_FINISH if fin else zlib.Z_SYNC_FLUSH)
        out.append(piece)
    return b"".join(out)


def _deflate_blocks(data: bytes, level: int, block_size: int,
                    last: bool) -> bytes:
    """One lane batch of pgzip blocks: the native codec (one call that
    releases the interpreter lock) where it loads, else the stdlib one;
    the same bytes either way."""
    from makisu_tpu_torch import native
    if native.pgzip_available():
        return native.deflate_blocks(data, level, block_size, last)
    return _py_deflate_blocks(data, level, block_size, last)


class BlockGzipWriter:
    """Block-parallel deterministic gzip writer, the pgzip backend.

    Input re-blocks through :class:`_BlockBuffer` into ``block_size``
    slices; batches of blocks deflate concurrently on the shared
    ``concurrency.hash_pool()`` (both codecs release the interpreter lock)
    and are written back in stream order. The output is one gzip member,
    a pure function of (content, level, block_size): the same at every
    worker count and the same as the reference's writer. ``workers``
    defaults to the context's ``compress_workers()``; 1 deflates inline.

    ``busy_seconds`` sums the lanes' deflate time (what the layer sink
    reports as its compress seconds: ``reports_compress_busy``)."""

    # Blocks per lane task: ~1 MiB of input at the 128 KiB block.
    BATCH_BLOCKS = 8
    reports_compress_busy = True

    def __init__(self, fileobj: BinaryIO, level: int = DEFAULT_LEVEL,
                 block_size: int = PGZIP_BLOCK,
                 workers: int | None = None) -> None:
        from makisu_tpu_torch.utils import concurrency
        self._out = fileobj
        self._level = level
        self._block = block_size
        self._blocks = _BlockBuffer(block_size)
        self._crc = zlib.crc32(b"")
        self._size = 0
        if workers is None:
            workers = concurrency.compress_workers()
        self.workers = max(1, workers)
        self._pool = concurrency.hash_pool() if self.workers > 1 \
            else None
        self._batch: list[bytes] = []   # whole blocks awaiting a lane
        self._pending: list = []        # lane futures in stream order
        self._closed = False
        self._busy_lock = threading.Lock()
        self.busy_seconds = 0.0
        self._submits = 0  # queue-depth sampling stride
        self._out.write(_PGZIP_HEADER)

    def _compress_task(self, payload: bytes, last: bool) -> bytes:
        t0 = time.perf_counter()
        try:
            return _deflate_blocks(payload, self._level, self._block,
                                   last)
        finally:
            busy = time.perf_counter() - t0
            with self._busy_lock:
                self.busy_seconds += busy
            from makisu_tpu_torch.utils import metrics
            metrics.stage_busy_add(metrics.COMPRESS_STAGE, busy)
            nblocks = len(payload) // self._block + (1 if last else 0)
            metrics.counter_add(metrics.COMPRESS_BLOCKS, nblocks,
                                backend="pgzip")

    def _submit(self, payload: bytes, last: bool) -> None:
        if self._pool is None:
            self._out.write(self._compress_task(payload, last))
            return
        from makisu_tpu_torch.utils import concurrency, metrics
        self._pending.append(concurrency.submit_ctx(
            self._pool, self._compress_task, payload, last))
        self._submits += 1
        if not self._submits & 0x0F:
            metrics.stage_queue_depth(metrics.COMPRESS_STAGE,
                                      len(self._pending))
        # At most two batches a lane in flight: the stage's memory
        # ceiling, and backpressure on a fast producer.
        while len(self._pending) > 2 * self.workers:
            self._out.write(self._pending.pop(0).result())
        while self._pending and self._pending[0].done():
            self._out.write(self._pending.pop(0).result())

    def _flush_batch(self, last: bool) -> None:
        if self._batch or last:
            self._submit(b"".join(self._batch), last)
            self._batch = []

    def write(self, data: bytes) -> int:
        self._crc = zlib.crc32(data, self._crc)
        self._size += len(data)
        for block in self._blocks.feed(data):
            self._batch.append(block)
            if len(self._batch) >= self.BATCH_BLOCKS:
                self._flush_batch(last=False)
        return len(data)

    def flush(self) -> None:
        self._out.flush()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._batch.append(self._blocks.tail())
        self._flush_batch(last=True)
        for fut in self._pending:
            self._out.write(fut.result())
        self._pending = []
        self._out.write((self._crc & 0xFFFFFFFF).to_bytes(4, "little")
                        + (self._size & 0xFFFFFFFF).to_bytes(4, "little"))

    def __enter__(self) -> "BlockGzipWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def gzip_writer(fileobj: BinaryIO, backend_id: str | None = None):
    """Deterministic gzip writer for ``backend_id`` (default zlib-6):
    the pgzip block writer or stdlib gzip."""
    backend, level, block = parse_backend_id(backend_id
                                             or gzip_backend_id())
    if backend == "pgzip":
        return BlockGzipWriter(fileobj, level=level, block_size=block)
    gz = gzip.GzipFile(fileobj=fileobj, mode="wb", compresslevel=level,
                       mtime=0, filename="")
    if level == 0:
        return _FixedGranularityWriter(gz)
    return gz


def gzip_reader(fileobj: BinaryIO):
    """Layer-blob reader: gzip, or zstd when the blob's frame magic says
    so (base images published as zstd). An unseekable input is read as
    gzip."""
    try:
        pos = fileobj.tell()
        head = fileobj.read(4)
        fileobj.seek(pos)
    except (OSError, AttributeError):
        return gzip.GzipFile(fileobj=fileobj, mode="rb")
    from makisu_tpu_torch.utils import zstdio
    if zstdio.is_zstd(head):
        return zstdio.ZstdReader(fileobj)
    return gzip.GzipFile(fileobj=fileobj, mode="rb")


def is_similar_header(h: tarfile.TarInfo, nh: tarfile.TarInfo,
                      ignore_time: bool = False) -> bool:
    """Structural equality by file type — the cheap "did this change?"
    predicate behind both the scan diff and untar short-circuiting.

    Regular files compare (mtime, uid, gid, size, mode); directories and
    hardlinks the same minus/plus size/linkname; symlinks compare the link
    target only. mtimes compare at 1-second granularity (tar's resolution).
    """
    if not h.name and not nh.name:
        return True  # "/" itself is never modified
    if h.issym():
        return nh.issym() and h.linkname == nh.linkname
    time_ok = ignore_time or int(h.mtime) == int(nh.mtime)
    if h.islnk():
        return (nh.islnk() and time_ok and h.linkname == nh.linkname
                and h.uid == nh.uid and h.gid == nh.gid and h.mode == nh.mode)
    if h.isdir():
        return (nh.isdir() and time_ok and h.uid == nh.uid
                and h.gid == nh.gid and h.mode == nh.mode)
    if h.isreg():
        return (nh.isreg() and time_ok and h.uid == nh.uid and h.gid == nh.gid
                and h.size == nh.size and h.mode == nh.mode)
    raise ValueError(f"unsupported tar entry type {h.type!r} for {h.name}")


def apply_header(path: str, h: tarfile.TarInfo) -> None:
    """Apply header metadata (mode/owner/mtime) to an on-disk path."""
    if not h.issym():
        os.chmod(path, h.mode)
    try:
        os.lchown(path, h.uid, h.gid)
    except PermissionError:
        pass  # unprivileged runs keep the current owner
    if not h.issym():
        os.utime(path, (h.mtime, h.mtime))


def write_entry(tw, src: str, h: tarfile.TarInfo,
                data: bytes | None = None) -> None:
    """Write one entry; regular-file content streams from ``src``.
    Writers with ``add_path`` (the native sink's) stream the content in
    C++ without the bytes entering Python. ``data`` is the read-ahead's
    prefetched content (``snapshot/layer._ReadAhead``), the bytes the
    disk read would give."""
    if h.isreg() and h.size > 0:
        add_path = getattr(tw, "add_path", None)
        if add_path is not None:
            add_path(h, src)
            return
        if data is not None and len(data) == h.size:
            tw.addfile(h, io.BytesIO(data))
            return
        with open(src, "rb") as f:
            tw.addfile(h, f)
    else:
        tw.addfile(h)
