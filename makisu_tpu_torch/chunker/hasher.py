"""The layer-commit seam: a layer tar streams into a sink, and ``finish()``
yields the layer's identity: tar digest (diffID), gzip blob descriptor,
and content-defined chunk fingerprints from the card.

Counterpart of ``makisu_tpu/chunker/hasher.py``'s Python ``LayerSink``
and ``TPUHasher``; the native C++ sink and pgzip are not part of the
port yet.
"""

from __future__ import annotations

import contextvars
import dataclasses
import hashlib
import os
import queue
import threading
import time
from typing import BinaryIO

from makisu_tpu_torch import tario
from makisu_tpu_torch.chunker.cdc import ChunkSession
from makisu_tpu_torch.docker.image import (
    MEDIA_TYPE_LAYER,
    Descriptor,
    Digest,
    DigestPair,
)
from makisu_tpu_torch.ops import backend, gear


@dataclasses.dataclass(frozen=True)
class ChunkFingerprint:
    offset: int
    length: int
    hex_digest: str


@dataclasses.dataclass
class LayerCommit:
    """Everything the cache/registry need to know about one layer."""

    digest_pair: DigestPair
    chunks: list[ChunkFingerprint]
    # Compression identity the blob was written with.
    gzip_backend_id: str = ""

    @property
    def chunk_ids(self) -> list[str]:
        return [c.hex_digest for c in self.chunks]


class LayerSink:
    """Layer sink: gzip + (tar digest, gzip digest), streaming.

    Subclasses tap the uncompressed tar stream for extra work. On
    multicore hosts compression runs on a worker thread behind a bounded
    queue, so the tar digest and the tap overlap with gzip (hashlib and
    zlib release the interpreter lock).
    """

    def __init__(self, out: BinaryIO, backend_id: str | None = None) -> None:
        self._tar_digest = hashlib.sha256()
        self._tee = tario.TeeDigest(out)
        self.backend_id = backend_id or tario.gzip_backend_id()
        self._gz = tario.gzip_writer(self._tee, backend_id=self.backend_id)
        self._closed = False
        # Seconds spent in the compressor (on the worker thread when there
        # is one), to set against the whole commit's wall time.
        self.compress_seconds = 0.0
        self._queue = None
        self._worker = None
        self._worker_error: list[BaseException] = []
        if (os.cpu_count() or 1) > 1:
            self._queue = queue.Queue(maxsize=8)
            self._worker = threading.Thread(
                target=contextvars.copy_context().run, args=(self._run,),
                daemon=True)
            self._worker.start()

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            try:
                self._compress(item)
            except BaseException as e:  # noqa: BLE001 - re-raised by write
                self._worker_error.append(e)
                return

    def _compress(self, data) -> None:
        t0 = time.perf_counter()
        self._gz.write(data)
        self.compress_seconds += time.perf_counter() - t0

    def _put_checked(self, item) -> None:
        """Bounded put that re-checks for a dead worker, so a compressor
        failure surfaces instead of blocking on a full queue forever."""
        while True:
            try:
                self._queue.put(item, timeout=1.0)
                return
            except queue.Full:
                if self._worker_error:
                    raise RuntimeError("layer compression failed") \
                        from self._worker_error[0]

    def write(self, data: bytes) -> int:
        if self._worker_error:
            raise RuntimeError("layer compression failed") \
                from self._worker_error[0]
        if self._queue is not None:
            # The worker reads the buffer after write() returns: copy
            # anything mutable.
            self._put_checked(data if isinstance(data, bytes)
                              else bytes(data))
        self._tar_digest.update(data)
        if self._queue is None:
            self._compress(data)
        self._tap(data)
        return len(data)

    def _tap(self, data: bytes) -> None:  # pragma: no cover - hook
        pass

    def _finish_chunks(self) -> list[ChunkFingerprint]:
        return []

    def finish(self) -> LayerCommit:
        if self._closed:
            raise RuntimeError("layer sink already finished")
        self._closed = True
        if self._queue is not None:
            self._put_checked(None)
            self._worker.join()
            if self._worker_error:
                raise RuntimeError("layer compression failed") \
                    from self._worker_error[0]
        t0 = time.perf_counter()
        self._gz.close()
        self.compress_seconds += time.perf_counter() - t0
        self._tee.flush()
        pair = DigestPair(
            tar_digest=Digest.from_hex(self._tar_digest.hexdigest()),
            gzip_descriptor=Descriptor(
                MEDIA_TYPE_LAYER, self._tee.size,
                Digest.from_hex(self._tee.digest.hexdigest())))
        return LayerCommit(pair, self._finish_chunks(),
                           gzip_backend_id=self.backend_id)


class _GPUSink(LayerSink):
    def __init__(self, out: BinaryIO, session: ChunkSession,
                 backend_id: str | None = None) -> None:
        super().__init__(out, backend_id=backend_id)
        self.session = session

    def _tap(self, data: bytes) -> None:
        self.session.update(data)

    def _finish_chunks(self) -> list[ChunkFingerprint]:
        return [ChunkFingerprint(c.offset, c.length, c.hex)
                for c in self.session.finish()]


class GPUHasher:
    """CPU digests + content-defined chunk fingerprints on the card.

    ``device=None`` is the card (and raises where there is none);
    ``device="cpu"`` runs the kernels' plain versions on the CPU.
    """

    name = "gpu"

    def __init__(self, avg_bits: int | None = None,
                 min_size: int | None = None,
                 max_size: int | None = None, device=None) -> None:
        self.avg_bits = avg_bits or gear.DEFAULT_AVG_BITS
        self.min_size = min_size or gear.DEFAULT_MIN_SIZE
        self.max_size = max_size or gear.DEFAULT_MAX_SIZE
        self.device = backend.resolve_device(device)

    def open_layer(self, out: BinaryIO,
                   backend_id: str | None = None) -> LayerSink:
        session = ChunkSession(self.avg_bits, self.min_size, self.max_size,
                               device=self.device)
        return _GPUSink(out, session, backend_id=backend_id)


def get_hasher(name: str) -> GPUHasher:
    if name == "gpu":
        return GPUHasher()
    raise ValueError(f"unknown hasher {name!r} (this package has gpu)")
