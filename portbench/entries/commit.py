"""Entry ``commit``: one layer commit of the configuration's whole context
through ``GPUHasher().open_layer(out, backend_id=...)``.

The context's files enter as tar entries through the sink's own tar
writer (``open_tar().addfile``), their contents in host memory, so the
per-file cost of the layer is part of the commit. ``out`` is an anonymous
memory file (``memfd_create``): a real fd, so the native sink takes the
commit, that writes no disk. Commits run back to back; each one's first
entry carries the iteration in its mtime, so every commit's tar, and so
its digests, differ from the one before.

Judged: every commit's tar digest and chunk tiling; the last commit's
blob (its descriptor and its bytes), its cut ends and every chunk's
SHA-256, against ``portbench/reference/``.
"""

from __future__ import annotations

import copy
import io
import os
import tarfile

from portbench import gen
from portbench.reference import judge, layers


def _tar_size(members) -> int:
    """Bytes of the tar stream of ``members``: headers, padded contents,
    two zero blocks, padded to a whole record."""
    n = sum(len(layers.header(info)) + -(-info.size // 512) * 512
            for info, _ in members) + 2 * tarfile.BLOCKSIZE
    return n + -n % tarfile.RECORDSIZE


def _tiles(chunks, n: int) -> bool:
    pos = 0
    for off, length, _ in chunks:
        if off != pos or length <= 0:
            return False
        pos += length
    return pos == n


class Entry:
    # Each commit's counters, printed on standard error.
    SUMMARY = ("compress_s", "tap_s", "session_host_s", "session_wait_s")

    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.chunking = ctx.config["chunking"]
        self.backend_id = ctx.traffic["backend_id"]
        self.members: list = []
        self.out = None
        self.hasher = None

    def setup(self) -> None:
        from makisu_tpu_torch.chunker.hasher import GPUHasher

        cfg = dict(self.ctx.config)
        cfg["context_bytes"] = self.ctx.traffic.get("context_bytes",
                                                    cfg["context_bytes"])
        for name, content in gen.context_files(cfg, self.ctx.seed):
            info = tarfile.TarInfo(name)
            info.size = len(content)
            info.mode = 0o644
            info.mtime = gen.CONTEXT_MTIME
            self.members.append((info, content))
        self.tar_bytes = _tar_size(self.members)
        self.out = os.fdopen(os.memfd_create("portbench-layer"), "wb",
                             buffering=0)
        self.hasher = GPUHasher(
            avg_bits=self.chunking["avg_bits"],
            min_size=self.chunking["min_size"],
            max_size=self.chunking["max_size"],
            device=None if self.ctx.device == "cuda" else self.ctx.device)

    def _first(self, i: int) -> tarfile.TarInfo:
        info = copy.copy(self.members[0][0])
        info.mtime = gen.CONTEXT_MTIME + i + 1
        return info

    def iterate(self, i: int) -> dict:
        # Each blob is written over the last one's pages, which stay in
        # memory, and the file is cut to its length once it is done.
        fd = self.out.fileno()
        os.lseek(fd, 0, os.SEEK_SET)
        span = self.ctx.spans.span
        sink = self.hasher.open_layer(self.out, backend_id=self.backend_id)
        with span("commit: tar write (headers, framing, deflate, tap)"):
            tw = sink.open_tar()
            tw.addfile(self._first(i), io.BytesIO(self.members[0][1]))
            for info, content in self.members[1:]:
                tw.addfile(info, io.BytesIO(content))
            tw.close()
        with span("commit: finish (deflate tail, last S1, digests back)"):
            commit = sink.finish()
            os.ftruncate(fd, os.lseek(fd, 0, os.SEEK_CUR))
        session = sink.session
        handle = getattr(sink, "handle", None)
        # The counters beyond SUMMARY are there for later readers.
        return {"iteration": i, "tar_bytes": self.tar_bytes,
                "route": sink.route,
                "compress_s": sink.compress_seconds,
                "tap_s": handle.tap_seconds if handle is not None else None,
                "session_host_s": session.host_seconds,
                "session_wait_s": session.wait_seconds,
                "gear_blocks": session.blocks,
                "span_launches": session.span_launches,
                "h2d_bytes": session.h2d_bytes,
                "commit": commit}

    def host_intervals(self, records) -> list:
        return list(self.ctx.spans.items)

    def release(self) -> None:
        self.hasher = None

    def judge(self, records) -> dict:
        dev = self.ctx.device
        counts = {"tar_digest": 0, "untiled": 0, "blob_descriptor": 0,
                  "blob_bytes": 0, "cut_ends": 0, "chunk_digests": 0}
        base = layers.tar_stream(self.members)
        hlen = len(layers.header(self.members[0][0]))
        rest = memoryview(base)[hlen:]
        for rec in records:
            hdr = layers.header(self._first(rec["iteration"]))
            pair = rec["commit"].digest_pair
            want = layers.sha256_hex(hdr + rest) if len(hdr) == hlen \
                else None
            counts["tar_digest"] += int(pair.tar_digest.hex() != want)
            chunks = [(c.offset, c.length, c.hex_digest)
                      for c in rec["commit"].chunks]
            counts["untiled"] += int(not _tiles(chunks, len(base)))
        last = records[-1]
        tar = layers.header(self._first(last["iteration"])) + bytes(rest)
        del base, rest
        desc = last["commit"].digest_pair.gzip_descriptor
        fd = self.out.fileno()
        size = os.fstat(fd).st_size
        blob = os.pread(fd, size, 0)
        counts["blob_descriptor"] = int(
            len(blob) != desc.size or
            layers.sha256_hex(blob) != desc.digest.hex())
        counts["blob_bytes"] = int(blob != layers.blob_for(
            tar, self.backend_id))
        del blob
        chunks = [(c.offset, c.length, c.hex_digest)
                  for c in last["commit"].chunks]
        if self.ctx.control_block:
            chunks = judge.control_chunks(tar, self.chunking, dev,
                                          self.ctx.control_block)
        got = judge.chunk_counts(tar, chunks,
                                 judge.want_ends(tar, self.chunking, dev))
        counts["cut_ends"] = got["cut_ends"]
        counts["chunk_digests"] = got["chunk_digests"]
        return judge.limits(counts)

    def close(self) -> None:
        if self.out is not None:
            self.out.close()
            self.out = None
