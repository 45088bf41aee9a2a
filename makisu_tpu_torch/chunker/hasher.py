"""The layer-commit seam: a layer tar streams into a sink, and ``finish()``
yields the layer's identity: tar digest (diffID), gzip blob descriptor,
and content-defined chunk fingerprints from the card.

Counterpart of ``makisu_tpu/chunker/hasher.py``'s ``LayerSink``,
``NativeLayerSink``, ``CPUHasher`` and ``TPUHasher``. Where the native
library loads (``native.py``, built with g++ on first use), a layer
commits through ``NativeLayerSink``: tar framing, both digests and gzip
in C++, the uncompressed stream tapped into the chunk session. The
Python ``LayerSink`` takes in-memory outputs, zlib level 0, hosts
without g++ and ``MAKISU_TPU_NATIVE_SINK=0``. Both write the same bytes.
"""

from __future__ import annotations

import contextvars
import dataclasses
import hashlib
import os
import queue
import tarfile
import threading
import time
from typing import BinaryIO, Protocol

from makisu_tpu_torch import native, tario
from makisu_tpu_torch.chunker.cdc import ChunkSession
from makisu_tpu_torch.docker.image import (
    MEDIA_TYPE_LAYER,
    Descriptor,
    Digest,
    DigestPair,
)
from makisu_tpu_torch.ops import backend, gear
from makisu_tpu_torch.utils import concurrency, events, metrics


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
    zlib release the interpreter lock). With the pgzip backend the writer
    behind the queue is itself block-parallel (``tario.BlockGzipWriter``
    on ``compress_workers()`` lanes) and reports its own busy seconds.
    """

    route = "python"

    def __init__(self, out: BinaryIO, backend_id: str | None = None) -> None:
        self._tar_digest = hashlib.sha256()
        self._tee = tario.TeeDigest(out)
        self.backend_id = backend_id or tario.gzip_backend_id()
        self._gz = tario.gzip_writer(self._tee, backend_id=self.backend_id)
        self._closed = False
        self._nbytes = 0  # uncompressed bytes digested (telemetry)
        self._writes = 0  # queue-depth sampling stride
        # Seconds spent in the compressor (on the worker thread when there
        # is one; summed over the lanes of a block-parallel writer), to set
        # against the whole commit's wall time.
        self.compress_seconds = 0.0
        self._self_reporting = getattr(self._gz, "reports_compress_busy",
                                       False)
        # Deflate lanes of a block-parallel writer (None for zlib).
        self.compress_workers = getattr(self._gz, "workers", None)
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
        busy0 = self.compress_seconds
        try:
            while True:
                item = self._queue.get()
                if item is None:
                    return
                try:
                    self._compress(item)
                except BaseException as e:  # noqa: BLE001 - re-raised
                    self._worker_error.append(e)
                    return
        finally:
            # One flush per stream; a block-parallel writer reports its
            # lanes' time itself, and counting the feed thread too would
            # count the stage twice.
            if not self._self_reporting:
                metrics.stage_busy_add(metrics.COMPRESS_STAGE,
                                       self.compress_seconds - busy0)

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
            self._writes += 1
            if not self._writes & 0xFF:  # sampled: writes are ~16 KiB
                metrics.stage_queue_depth("compress", self._queue.qsize())
        self._tar_digest.update(data)
        self._nbytes += len(data)
        if self._queue is None:
            self._compress(data)
        self._tap(data)
        # A long commit logs nothing for minutes: each landed buffer
        # stamps the progress clock for the stall watchdog.
        events.note_progress()
        return len(data)

    def _tap(self, data: bytes) -> None:  # pragma: no cover - hook
        pass

    def _finish_chunks(self) -> list[ChunkFingerprint]:
        return []

    def open_tar(self) -> tarfile.TarFile:
        """Tar writer whose stream feeds this sink (the commit path's
        single entry point for layer serialization)."""
        return tarfile.open(fileobj=self, mode="w|")

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
        if self._self_reporting:
            # The feed thread only buffered and submitted batches; the
            # lanes' deflate time is the stage's.
            self.compress_seconds = self._gz.busy_seconds
        self._tee.flush()
        metrics.counter_add("makisu_bytes_hashed_total", self._nbytes,
                            backend="python", path="layer_sink")
        backend_name = self.backend_id.split("-", 1)[0]
        metrics.counter_add(metrics.COMPRESS_BYTES, self._nbytes,
                            backend=backend_name, direction="in")
        metrics.counter_add(metrics.COMPRESS_BYTES, self._tee.size,
                            backend=backend_name, direction="out")
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


class _NativeTarWriter:
    """tarfile.TarFile-shaped writer over the native pipeline: headers
    are rendered by Python's tarfile (byte-identical PAX output); file
    content, padding, hashing and compression run in C++."""

    _FMT = (tarfile.PAX_FORMAT, tarfile.ENCODING, "surrogateescape")

    def __init__(self, sink: "NativeLayerSink") -> None:
        self._sink = sink
        self._handle = sink.handle
        self._offset = 0
        self._closed = False

    def addfile(self, tarinfo: tarfile.TarInfo, fileobj=None) -> None:
        buf = tarinfo.tobuf(*self._FMT)
        self._handle.write(buf)
        self._offset += len(buf)
        if fileobj is not None:
            remaining = tarinfo.size
            while remaining > 0:
                chunk = fileobj.read(min(remaining, 1 << 20))
                if not chunk:
                    raise OSError(f"{tarinfo.name}: short read")
                self._handle.write(chunk)
                remaining -= len(chunk)
            pad = (512 - tarinfo.size % 512) % 512
            if pad:
                self._handle.write(b"\0" * pad)
            self._offset += tarinfo.size + pad
        events.note_progress()  # one stamp per file

    def add_path(self, tarinfo: tarfile.TarInfo, path: str) -> None:
        """Content streams through C++ (no Python bytes)."""
        buf = tarinfo.tobuf(*self._FMT)
        self._handle.write(buf)
        self._handle.write_file(path, tarinfo.size)
        pad = (512 - tarinfo.size % 512) % 512
        self._offset += len(buf) + tarinfo.size + pad
        events.note_progress()  # one stamp per file

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # End of archive exactly as tarfile: two zero blocks, then pad
        # the stream to a RECORDSIZE multiple (cache-identity-bearing).
        end = b"\0" * (2 * tarfile.BLOCKSIZE)
        rem = (self._offset + len(end)) % tarfile.RECORDSIZE
        if rem:
            end += b"\0" * (tarfile.RECORDSIZE - rem)
        self._offset += len(end)
        self._handle.write(end)
        # The writer streams into the C++ handle past sink.write: count
        # its bytes for the sink's telemetry.
        self._sink._nbytes += self._offset

    def __enter__(self) -> "_NativeTarWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.close()


class NativeLayerSink:
    """Layer sink backed by ``csrc/layersink.cpp``: the whole per-byte
    pipeline (tar framing, both digests, gzip) runs in C++. With a
    ``session`` (the gpu hasher) the uncompressed stream is tapped into
    the chunk session through a native callback, in the same pass.

    ``compress_seconds`` is the time inside the C++ pipeline less the
    tap's: framing, both digests, deflate (or, for pgzip, feeding its
    block threads), file reads and the blob's writes."""

    route = "native"

    def __init__(self, out: BinaryIO, backend_id: str | None = None,
                 session: ChunkSession | None = None) -> None:
        self.backend_id = backend_id or tario.gzip_backend_id()
        backend, level, block = tario.parse_backend_id(self.backend_id)
        out.flush()  # nothing buffered may trail the native fd writes
        # The compress-workers count sizes the C++ block pool as it sizes
        # the Python one (block bytes are a pure function of level and
        # block size).
        workers = concurrency.compress_workers()
        self.handle = native.LayerSinkHandle(
            out.fileno(), backend, level, block or native.DEFAULT_BLOCK,
            nthreads=workers)
        self.compress_workers = workers if backend == "pgzip" else None
        self.session = session
        self._nbytes = 0  # uncompressed bytes digested (telemetry)
        # The progress clock is stamped once per tap piece (at most
        # 1 MiB): a file's content streams through C++ without passing
        # ``write``, and a long commit must not look like a stall.
        if session is not None:
            update = session.update

            def tap(piece: bytes) -> None:
                update(piece)
                events.note_progress()

            self.handle.set_tap(tap)
        else:
            self.handle.set_tap(events.note_progress, data=False)

    @property
    def compress_seconds(self) -> float:
        return self.handle.native_seconds - self.handle.tap_seconds

    def open_tar(self) -> _NativeTarWriter:
        return _NativeTarWriter(self)

    def write(self, data: bytes) -> int:
        self.handle.write(bytes(data))
        self._nbytes += len(data)
        events.note_progress()  # hashing is progress (see LayerSink)
        return len(data)

    def finish(self) -> LayerCommit:
        try:
            tar_hex, gz_hex, gz_size, _ = self.handle.finish()
        finally:
            self.handle.close()
        metrics.counter_add("makisu_bytes_hashed_total", self._nbytes,
                            backend="native", path="layer_sink")
        backend_name = self.backend_id.split("-", 1)[0]
        metrics.counter_add(metrics.COMPRESS_BYTES, self._nbytes,
                            backend=backend_name, direction="in")
        metrics.counter_add(metrics.COMPRESS_BYTES, gz_size,
                            backend=backend_name, direction="out")
        pair = DigestPair(
            tar_digest=Digest.from_hex(tar_hex),
            gzip_descriptor=Descriptor(MEDIA_TYPE_LAYER, gz_size,
                                       Digest.from_hex(gz_hex)))
        chunks = []
        if self.session is not None:
            chunks = [ChunkFingerprint(c.offset, c.length, c.hex)
                      for c in self.session.finish()]
        return LayerCommit(pair, chunks, gzip_backend_id=self.backend_id)


class Hasher(Protocol):
    """Factory for layer sinks; chosen once per build."""

    name: str

    def open_layer(self, out: BinaryIO, backend_id: str | None = None
                   ) -> LayerSink | NativeLayerSink: ...


def _native_sink_enabled() -> bool:
    if os.environ.get("MAKISU_TPU_NATIVE_SINK") == "0":
        return False
    return native.layersink_available()


def _use_native(out: BinaryIO, backend_id: str | None = None) -> bool:
    """One decision point for the native or the Python sink (the choice
    is cache-identity-neutral but must be the same for both hashers):
    the native sink needs a real fd; in-memory outputs take Python.

    zlib level 0 is excluded: stored-block framing depends on write
    granularity, and the C++ pipeline feeds deflate at another
    granularity than the Python one (pinned by
    ``tario._FixedGranularityWriter``), so choosing native there would
    split cache identity by host capability."""
    if (backend_id or tario.gzip_backend_id()) == "zlib-0":
        return False
    try:
        out.fileno()
    except (OSError, AttributeError, ValueError):
        return False
    return _native_sink_enabled()


class CPUHasher:
    """Digests only, no chunking (``makisu_tpu``'s ``CPUHasher``), on the
    native sink where it loads. Never touches the card."""

    name = "cpu"

    def open_layer(self, out: BinaryIO, backend_id: str | None = None
                   ) -> LayerSink | NativeLayerSink:
        if _use_native(out, backend_id):
            return NativeLayerSink(out, backend_id=backend_id)
        return LayerSink(out, backend_id=backend_id)


class GPUHasher:
    """CPU digests + content-defined chunk fingerprints on the card.

    ``device=None`` is the card (and raises where there is none);
    ``device="cpu"`` runs the kernels' plain versions on the CPU.
    ``shared=True`` sends every ring pass to the process-wide hash
    service of the device (``chunker/service.py``), so concurrent builds
    share S1 launches (a worker's builds).
    """

    name = "gpu"

    def __init__(self, avg_bits: int | None = None,
                 min_size: int | None = None,
                 max_size: int | None = None, device=None,
                 shared: bool = False) -> None:
        self.avg_bits = avg_bits or gear.DEFAULT_AVG_BITS
        self.min_size = min_size or gear.DEFAULT_MIN_SIZE
        self.max_size = max_size or gear.DEFAULT_MAX_SIZE
        self.device = backend.resolve_device(device)
        self.shared = shared

    def open_layer(self, out: BinaryIO, backend_id: str | None = None
                   ) -> LayerSink | NativeLayerSink:
        service = None
        if self.shared:
            from makisu_tpu_torch.chunker.service import shared_service
            service = shared_service(self.device)
        session = ChunkSession(self.avg_bits, self.min_size, self.max_size,
                               device=self.device, service=service)
        if _use_native(out, backend_id):
            # One pass: tar framing, digests and gzip in C++, the stream
            # tapped into the chunk session.
            return NativeLayerSink(out, backend_id=backend_id,
                                   session=session)
        return _GPUSink(out, session, backend_id=backend_id)


def get_hasher(name: str, device=None) -> Hasher:
    """``gpu``: chunk fingerprints on ``device`` (None is the card),
    through the shared hash service when ``MAKISU_TPU_SHARED_HASH=1``
    (a worker sets it for its builds); ``cpu``: digests only."""
    if name == "gpu":
        return GPUHasher(device=device, shared=os.environ.get(
            "MAKISU_TPU_SHARED_HASH") == "1")
    if name == "cpu":
        return CPUHasher()
    raise ValueError(f"unknown hasher {name!r} (choose gpu or cpu)")
