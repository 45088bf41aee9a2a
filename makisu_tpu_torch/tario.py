"""Deterministic layer gzip and the blob-digest tap.

Copies of ``makisu_tpu/tario.py``'s ``TeeDigest``, the zlib branch of
``gzip_writer`` and the level-0 ``_FixedGranularityWriter``. Gzip output
is part of a layer's registry identity, so the writer pins mtime=0 and
omits the filename: identical tar bytes at the same level always give
identical gzip bytes. The pgzip block backend is not part of the port
yet.
"""

from __future__ import annotations

import gzip
import hashlib
from typing import BinaryIO

DEFAULT_LEVEL = 6


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


def gzip_backend_id(level: int = DEFAULT_LEVEL) -> str:
    """Backend-id string of a zlib blob (recorded in cache entries)."""
    return f"zlib-{level}"


def parse_backend_id(backend_id: str) -> int:
    """``zlib-<level>`` -> level. Raises ValueError on any other id."""
    backend, _, level_s = backend_id.partition("-")
    if backend != "zlib":
        raise ValueError(f"gzip backend {backend!r} is not supported here "
                         f"(only zlib) in {backend_id!r}")
    level = int(level_s)
    if not 0 <= level <= 9:
        raise ValueError(f"gzip level {level} out of range in "
                         f"{backend_id!r}")
    return level


class _FixedGranularityWriter:
    """Feeds the compressor in fixed 64 KiB blocks: zlib level-0
    stored-block framing depends on write sizes, so fixed blocks make the
    blob a pure function of content, whoever writes."""

    GRANULARITY = 64 * 1024

    def __init__(self, gz) -> None:
        self._gz = gz
        self._buf = bytearray()

    def write(self, data: bytes) -> int:
        self._buf += data
        g = self.GRANULARITY
        while len(self._buf) >= g:
            self._gz.write(bytes(self._buf[:g]))
            del self._buf[:g]
        return len(data)

    def close(self) -> None:
        if self._buf:
            self._gz.write(bytes(self._buf))
            self._buf.clear()
        self._gz.close()

    def flush(self) -> None:
        pass


def gzip_writer(fileobj: BinaryIO, backend_id: str | None = None):
    """Deterministic gzip writer for ``backend_id`` (default zlib-6)."""
    level = parse_backend_id(backend_id or gzip_backend_id())
    gz = gzip.GzipFile(fileobj=fileobj, mode="wb", compresslevel=level,
                       mtime=0, filename="")
    if level == 0:
        return _FixedGranularityWriter(gz)
    return gz
