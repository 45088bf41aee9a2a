"""Plain layer bytes: the tar stream of a list of entries, its gzip blob in
both formats a layer is written in, the chunk digests, and the files a
Dockerfile's COPY steps put into each layer.

The pgzip block format (``gzip_blocks``) is a frozen copy of
``makisu_tpu_torch/tario.py:190-219`` (``_PGZIP_HEADER`` and
``_py_deflate_blocks``) and ``:324-334`` (the trailer): each block of the
stream a raw-deflate slice of its own, ended by a sync flush, the last
by Z_FINISH, in one gzip member with mtime 0 and OS 255.
"""

from __future__ import annotations

import hashlib
import io
import os
import tarfile
import zlib
from concurrent.futures import ThreadPoolExecutor

PGZIP_HEADER = bytes([0x1f, 0x8b, 0x08, 0, 0, 0, 0, 0, 0, 0xff])


def tar_stream(members) -> bytes:
    """The PAX tar stream of (TarInfo, content) pairs, as ``tarfile``
    writes it (two zero blocks, padded to a whole record)."""
    out = io.BytesIO()
    with tarfile.open(fileobj=out, mode="w", format=tarfile.PAX_FORMAT) as tf:
        for info, content in members:
            tf.addfile(info, io.BytesIO(content))
    return out.getvalue()


def header(info: tarfile.TarInfo) -> bytes:
    """One member's header bytes, as ``tarfile`` renders them."""
    return info.tobuf(tarfile.PAX_FORMAT, tarfile.ENCODING,
                      "surrogateescape")


def _deflate_block(data: bytes, level: int, last: bool) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8,
                          zlib.Z_DEFAULT_STRATEGY)
    return co.compress(data) + co.flush(zlib.Z_FINISH if last
                                        else zlib.Z_SYNC_FLUSH)


def gzip_blocks(data: bytes, level: int, block: int,
                threads: int = 8) -> bytes:
    """The pgzip blob of ``data``: ``len(data) // block`` whole blocks and
    the tail (possibly empty) as the final slice."""
    view = memoryview(data)
    nfull = len(data) // block
    pieces = [(view[i * block:(i + 1) * block], False) for i in range(nfull)]
    pieces.append((view[nfull * block:], True))
    with ThreadPoolExecutor(threads) as pool:
        slices = list(pool.map(lambda p: _deflate_block(bytes(p[0]), level,
                                                        p[1]), pieces))
    trailer = ((zlib.crc32(data) & 0xFFFFFFFF).to_bytes(4, "little")
               + (len(data) & 0xFFFFFFFF).to_bytes(4, "little"))
    return PGZIP_HEADER + b"".join(slices) + trailer


def gzip_stream(data: bytes, level: int) -> bytes:
    """The single-stream gzip blob of ``data`` as ``gzip.GzipFile`` writes
    it with mtime 0 and no file name: XFL 2 at level 9, 4 at level 1, else
    0; OS 255; one raw-deflate stream (memLevel 8, default strategy)."""
    xfl = 2 if level == 9 else 4 if level == 1 else 0
    head = bytes([0x1f, 0x8b, 0x08, 0, 0, 0, 0, 0, xfl, 0xff])
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8,
                          zlib.Z_DEFAULT_STRATEGY)
    body = co.compress(data) + co.flush(zlib.Z_FINISH)
    trailer = ((zlib.crc32(data) & 0xFFFFFFFF).to_bytes(4, "little")
               + (len(data) & 0xFFFFFFFF).to_bytes(4, "little"))
    return head + body + trailer


def blob_for(data: bytes, backend_id: str) -> bytes:
    """The blob a layer written with ``backend_id`` (``zlib-<level>`` or
    ``pgzip-<level>-<block>``) must be."""
    parts = backend_id.split("-")
    if parts[0] == "pgzip":
        return gzip_blocks(data, int(parts[1]), int(parts[2]))
    if parts[0] == "zlib":
        return gzip_stream(data, int(parts[1]))
    raise ValueError(f"unknown gzip backend in {backend_id!r}")


def sha256_hex(data) -> str:
    return hashlib.sha256(data).hexdigest()


def regular_files(tar: bytes) -> dict[str, bytes]:
    """Path (no leading "./" or "/") -> content of each regular file of a
    layer tar."""
    out = {}
    with tarfile.open(fileobj=io.BytesIO(tar), mode="r:") as tf:
        for m in tf:
            if not m.isreg():
                continue
            name = m.name[2:] if m.name.startswith("./") else m.name
            out[name.lstrip("/")] = tf.extractfile(m).read()
    return out


def copy_layers(dockerfile: str, files: dict[str, bytes]) -> list[dict]:
    """The files each COPY step of a ``FROM scratch`` Dockerfile puts into
    its layer: a source directory's contents go under the destination,
    ``.`` is the whole context (the Dockerfile too). One layer per COPY
    step: every step of these Dockerfiles is committed."""
    layers = []
    for line in dockerfile.splitlines():
        words = line.split("#", 1)[0].split()
        if not words or words[0].upper() != "COPY":
            continue
        *srcs, dst = words[1:]
        dst = dst.strip("/")
        layer = {}
        for src in srcs:
            src = src.strip("/")
            for path, content in files.items():
                if src == ".":
                    rel = path
                elif path.startswith(src + "/"):
                    rel = path[len(src) + 1:]
                else:
                    continue
                layer[os.path.join(dst, rel)] = content
        layers.append(layer)
    return layers


def file_mismatches(got: dict[str, bytes], want: dict[str, bytes]) -> int:
    """Files missing on either side, plus files whose bytes differ."""
    names = got.keys() ^ want.keys()
    return len(names) + sum(got[k] != want[k] for k in got.keys() & want)
