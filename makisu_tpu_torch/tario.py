"""Layer-tar I/O: deterministic gzip, the blob-digest tap, and tar
header apply/compare/write.

Copies of ``makisu_tpu/tario.py``'s ``TeeDigest``, ``COMPRESSION_LEVELS``,
``make_backend_id`` and the zlib branch of ``gzip_writer`` (with the
level-0 ``_FixedGranularityWriter``), plus its header helpers. Gzip
output is part of a layer's registry identity, so the writer pins
mtime=0 and omits the filename: identical tar bytes at the same level
always give identical gzip bytes. The pgzip block backend is not part of
the port yet: its backend ids are refused here.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import tarfile
from typing import BinaryIO

# Compression levels of the ``--compression`` flag (reference:
# tario.CompressionLevel, gzip.go:26-47).
COMPRESSION_LEVELS = {"no": 0, "speed": 1, "default": 6, "size": 9}
DEFAULT_LEVEL = COMPRESSION_LEVELS["default"]


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


def make_backend_id(backend: str, level_name: str) -> str:
    """Validate a (``--gzip-backend``, ``--compression``) flag pair into
    a backend id, the same string ``makisu_tpu``'s ``make_backend_id``
    gives for zlib (``zlib-<level>``)."""
    if backend != "zlib":
        raise ValueError(f"gzip backend {backend!r} is not ported yet "
                         "(only zlib)")
    if level_name not in COMPRESSION_LEVELS:
        raise ValueError(
            f"invalid compression level {level_name!r}; "
            f"one of {sorted(COMPRESSION_LEVELS)}")
    return gzip_backend_id(COMPRESSION_LEVELS[level_name])


def backend_id_usable(backend_id: str | None) -> bool:
    """True when this package can replay ``backend_id`` byte for byte:
    a well-formed ``zlib-<level>``. A pgzip id, a malformed id and no id
    at all are not."""
    if backend_id is None:
        return False
    try:
        parse_backend_id(backend_id)
    except ValueError:
        return False
    return True


def parse_backend_id(backend_id: str) -> int:
    """``zlib-<level>`` -> level. Raises ValueError on any other id."""
    backend, _, level_s = backend_id.partition("-")
    if backend != "zlib" or not level_s.isdigit():
        raise ValueError(f"gzip backend id {backend_id!r} is not supported "
                         "here (only zlib-<level>)")
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


def write_entry(tw, src: str, h: tarfile.TarInfo) -> None:
    """Write one entry; regular-file content streams from ``src``."""
    if h.isreg() and h.size > 0:
        with open(src, "rb") as f:
            tw.addfile(h, f)
    else:
        tw.addfile(h)
