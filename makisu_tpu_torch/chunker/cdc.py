"""Streaming content-defined chunking + span SHA-256 on a device ring.

A ``ChunkSession`` consumes a layer's tar stream and produces
content-defined chunks with SHA-256 fingerprints. The stream's bytes
cross to the card once, into a ring, and both kernels read them there:

1. ``update`` copies incoming bytes into a pinned host block; each full
   block (and the final partial one) is copied into the next slot of the
   ring. The Gear bitmap kernel (``ops/gear_cuda.py``) scans the slot
   with the ``HALO`` bytes in front of it, read from the ring as well,
   and its packed candidate bitmap (1/8 of the bytes) comes back into a
   pinned host buffer.
2. A host pass applies the min/max chunk-size policy to the candidate
   positions and records each chunk as a span (stream offset, length).
   The host keeps offsets, never chunk bytes.
3. Once per pass over the ring, and at ``finish()``, the span SHA-256
   kernel (``ops/sha256_cuda.py``) hashes every span cut since its last
   launch straight out of the ring, longest first.

The ring is one uint8 buffer on the session's device::

    [ guard: GUARD bytes | slot 0 | slot 1 | ... | slot RING_BLOCKS-1 ]

with slots of ``block`` bytes and GUARD = HALO + max_size rounded up to
a multiple of 64 (so every slot minus its halo starts 16-byte aligned).
During pass p, which holds stream bytes [p * R * block, (p + 1) * R *
block) with R = RING_BLOCKS, stream offset s lies at ring position
GUARD + s - p * R * block. Invariants:

- Slot reuse: block k of pass p goes to slot k. Before slot 0 of a pass
  p > 0 is written, the session processes every block in flight, so
  every byte before the pass is cut or lies in the uncut tail (at most
  max_size bytes); launches S1 over every span recorded so far (all in
  pass p - 1's positions); and copies the ring's last GUARD bytes into
  the guard. Copies and kernels share the session's stream, so that
  launch reads the slots before the copy that overwrites them. With a
  shared hash service (``service=``, ``chunker/service.py``) the pass is
  submitted instead of launched, and before the guard copy the session
  waits until the service has enqueued the launch that reads the ring,
  then makes its stream wait on that launch's done event (no host
  synchronisation with the card).
- Guard contents: during pass p the guard holds stream bytes
  [p * R * block - GUARD, p * R * block). The uncut tail, and so any
  chunk that straddles the wrap, is contiguous on the card, and G1's
  halo for slot 0 is the guard's last HALO bytes.
- In-flight depth: at most PIPELINE_DEPTH <= RING_BLOCKS - 1 Gear
  launches are in flight, and the pipeline drains at each wrap, so no
  slot is written while a launch that reads it is pending.

The host waits on the oldest block's event once ``PIPELINE_DEPTH``
blocks are in flight, so the card scans while the caller produces bytes;
pinned host blocks are reused once their bitmap has come back.

The session's stream is the caller's current one unless that is the
device's default stream: then it is a stream of the constructing
thread's own (one per thread and device), so concurrent builds in one
process (a worker's handler threads) overlap on the card instead of
serialising on the default stream.

The session runs on the card unless it is built with ``device="cpu"``,
where the same ring is a CPU tensor and the same code runs the kernels'
plain versions (the tests' route). A device error raises: chunk
fingerprints are cache identity, and nothing here falls back to another
route. On the card a session first waits, bounded, for the device plane
to come up (``backend.require_ready``) and raises its summary if it does
not; every host wait on a bitmap or the digests is bounded
(``backend.sync_bounded``, ``MAKISU_TPU_SYNC_TIMEOUT``), so a hung
kernel raises ``TimeoutError`` naming the wait. A session that raises
drops its ring and pinned blocks at once, as ``finish`` does.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import threading
import time
import typing

import numpy as np
import torch

from makisu_tpu_torch.ops import backend, gear, gear_cuda, sha256_cuda
from makisu_tpu_torch.utils import metrics

BLOCK = 4 * 1024 * 1024  # stream bytes per Gear kernel launch
HALO = 128  # ring bytes in front of each block that G1 reads (>= WINDOW-1)
MAX_CHUNK = gear.DEFAULT_MAX_SIZE  # the largest max_size a session takes
# makisu_chunk_size_bytes buckets (the reference's): powers of two
# around the 8 KiB average and 64 KiB max chunk policy.
CHUNK_SIZE_BUCKETS = (1024.0, 2048.0, 4096.0, 8192.0, 16384.0,
                      32768.0, 65536.0, 131072.0)

# Fingerprint observer: a per-context callback ``cb(hex_digest)`` that
# sees every chunk fingerprint a session produces (the chunk-dedup
# cache's prefetch hook). Context-scoped so concurrent builds never see
# each other's chunks. An observer that raises is dropped for the rest
# of the session; the chunks stand.
_chunk_observer: "contextvars.ContextVar" = contextvars.ContextVar(
    "makisu_torch_chunk_observer", default=None)


def set_chunk_observer(cb):
    """Bind a per-context fingerprint callback ``cb(hex_digest)``.
    Returns a token for :func:`reset_chunk_observer`."""
    return _chunk_observer.set(cb)


def reset_chunk_observer(token) -> None:
    _chunk_observer.reset(token)


_thread_streams = threading.local()


def _session_stream(device: torch.device):
    """The caller's current stream on ``device``, or this thread's own
    stream when the current one is the default stream."""
    current = torch.cuda.current_stream(device)
    if current != torch.cuda.default_stream(device):
        return current
    streams = getattr(_thread_streams, "streams", None)
    if streams is None:
        streams = _thread_streams.streams = {}
    key = str(current.device)
    if key not in streams:
        streams[key] = torch.cuda.Stream(device)
    return streams[key]


class Chunk(typing.NamedTuple):
    offset: int
    length: int
    digest: bytes  # 32-byte sha256

    @property
    def hex(self) -> str:
        return self.digest.hex()


class _HostBlock:
    """One block's host side: its bytes before the copy to the ring and
    its bitmap after the scan (both pinned for the card)."""

    def __init__(self, block: int, device: torch.device) -> None:
        pin = device.type == "cuda"
        self.host = torch.empty(block, dtype=torch.uint8, pin_memory=pin)
        self.host_np = self.host.numpy()
        self.words = torch.empty((HALO + block) // 32, dtype=torch.uint32,
                                 pin_memory=pin)
        self.words_np = self.words.numpy()
        self.done = None  # CUDA event after the bitmap's copy to the host


class ChunkSession:
    """One layer stream -> content-defined chunks with fingerprints."""

    # Gear launches in flight before the host waits on the oldest one.
    PIPELINE_DEPTH = 2
    # Slots of the device ring: one S1 launch per RING_BLOCKS blocks
    # (256 MiB of stream at the default block, about 32k chunks).
    RING_BLOCKS = 64

    def __init__(self, avg_bits: int = gear.DEFAULT_AVG_BITS,
                 min_size: int = gear.DEFAULT_MIN_SIZE,
                 max_size: int = gear.DEFAULT_MAX_SIZE,
                 block: int = BLOCK, device=None, service=None) -> None:
        if block <= 0 or block % 32:
            raise ValueError("block size must be a positive multiple of 32")
        if not 0 < min_size <= max_size <= MAX_CHUNK:
            raise ValueError(
                f"chunk sizes need 0 < min ({min_size}) <= max "
                f"({max_size}) <= {MAX_CHUNK}")
        self.guard = HALO + -(-max_size // 64) * 64
        ring_bytes = self.RING_BLOCKS * block
        if self.RING_BLOCKS <= self.PIPELINE_DEPTH or \
                ring_bytes < self.guard or \
                self.guard + ring_bytes >= 1 << 31:
            raise ValueError(
                f"a ring of {self.RING_BLOCKS} blocks of {block} bytes "
                f"needs more than {self.PIPELINE_DEPTH} slots, at least "
                f"{self.guard} bytes and positions below 2^31")
        self.device = backend.resolve_device(device)
        self.avg_bits = avg_bits
        self.min_size = min_size
        self.max_size = max_size
        self.block = block
        # Optional shared hash service (chunker/service.py): each ring
        # pass goes to it instead of to an S1 launch of the session's own.
        if service is not None and service.device.type != self.device.type:
            raise ValueError(f"a session on {self.device} with a hash "
                             f"service on {service.device}")
        self.service = service
        # The session's copies and launches run on its stream
        # (``_session_stream``), whatever thread later feeds it (the
        # native sink's tap calls update from inside a C++ call).
        self._stream = None
        if self.device.type == "cuda":
            backend.require_ready(self.device)
            self._stream = _session_stream(self.device)
        with self._on_stream():
            self._ring = torch.empty(self.guard + ring_bytes,
                                     dtype=torch.uint8, device=self.device)
        self._cur: _HostBlock | None = None  # the block being filled
        self._fill = 0                # bytes in it
        self._free: list[_HostBlock] = []
        self._inflight: collections.deque = collections.deque()
        self._scanned = 0             # stream bytes sent to the ring
        self._processed = 0           # stream bytes whose cuts are made
        self._pass_start = 0          # stream offset of slot 0's first byte
        self._prev_cut = 0            # stream offset of the last cut
        self._spans: list[tuple[int, int]] = []  # cut since the last S1
        # Per S1 launch, oldest first: (digests, done event or None,
        # sorted spans [S, 2], metadata, H2D bytes, live bytes); with a
        # service, (PassRequest, sorted spans) per submitted pass.
        self._pending: list[tuple] = []
        self._errors = sha256_cuda.LaunchErrors()  # this session's words
        self._last_pass = None  # the pass submitted by the last wrap
        self._observer = _chunk_observer.get()
        # Host seconds spent inside update() and finish(), and the part
        # of them spent waiting for a bitmap.
        self.host_seconds = 0.0
        self.wait_seconds = 0.0
        self.blocks = 0
        self.span_launches = 0
        self.service_passes = 0  # ring passes hashed by the service
        self.h2d_bytes = 0  # stream bytes + span metadata sent to the ring
        self._h2d_unlaunched = 0  # slot bytes since the last S1 launch
        # The card's seconds in this session's G1 and S1 kernels, from a
        # pair of timing events around each launch, summed once the
        # digests are back: by then every pair has completed. Nothing is
        # timed on the CPU.
        self.device_seconds = 0.0
        self._timer = (backend.KernelTimer() if self.device.type == "cuda"
                       else None)
        # Telemetry labels: the route's device, and the one program
        # capacity (the ring's bytes) that buckets the device series.
        self._backend_label = self.device.type
        self._bucket = ring_bytes

    # -- byte intake ------------------------------------------------------

    def update(self, data) -> None:
        t0 = time.perf_counter()
        src = np.frombuffer(data, dtype=np.uint8)
        i = 0
        try:
            while i < len(src):
                if self._cur is None:
                    self._cur = self._free.pop() if self._free else \
                        _HostBlock(self.block, self.device)
                take = min(self.block - self._fill, len(src) - i)
                self._cur.host_np[self._fill:self._fill + take] = \
                    src[i:i + take]
                self._fill += take
                i += take
                if self._fill == self.block:
                    with self._on_stream():
                        self._dispatch_block()
        except BaseException:
            self._release()
            raise
        self.host_seconds += time.perf_counter() - t0

    def finish(self) -> list[Chunk]:
        t0 = time.perf_counter()
        try:
            with self._on_stream():
                if self._fill:
                    self._dispatch_block()
                while self._inflight:
                    self._process_block(self._inflight.popleft())
                self._take(self._processed)  # the final chunk
                self._launch_spans()
            chunks = self._drain()
            if self._timer is not None:
                for kernel, seconds in self._timer.seconds().items():
                    metrics.counter_add(metrics.DEVICE_BUSY_SECONDS,
                                        seconds, kernel=kernel)
                    self.device_seconds += seconds
        finally:
            # The session is spent, or raised: its ring and pinned
            # blocks go now, not when the collector finds the session. A
            # build commits layer after layer, and a resident process
            # builds again and again.
            self._release()
        chunks.sort(key=lambda c: c.offset)
        for c in chunks:
            self._notify(c.hex)
        if chunks:
            # One batched fold per stream, never per chunk.
            metrics.observe_batch("makisu_chunk_size_bytes",
                                  [c.length for c in chunks],
                                  buckets=CHUNK_SIZE_BUCKETS)
        self.host_seconds += time.perf_counter() - t0
        return chunks

    # -- internals --------------------------------------------------------

    def _release(self) -> None:
        """Drop the ring, the pinned blocks and the pending launches. A
        launch still queued on the session's stream keeps its memory
        safe: the allocator reuses a freed block on that stream only,
        after it, and a pinned block only once its copies are done."""
        self._ring = None
        self._last_pass = None  # its request holds the ring too
        self._cur = None
        self._free.clear()
        self._inflight.clear()
        self._pending = []

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _notify(self, hex_digest: str) -> None:
        """Pass one fingerprint to the bound observer. Never raises: an
        observer's failure drops the observer, not the chunks."""
        if self._observer is None:
            return
        try:
            self._observer(hex_digest)
        except Exception:  # noqa: BLE001 - observer plane
            self._observer = None

    def _dispatch_block(self) -> None:
        """Copy the filled host block into its ring slot, launch the Gear
        kernel on it and its halo, and process the oldest in-flight block
        once the pipeline is full."""
        blk, live = self._cur, self._fill
        self._cur, self._fill = None, 0
        ring_bytes = self.RING_BLOCKS * self.block
        if self._scanned - self._pass_start == ring_bytes:
            self._wrap()
        pos = self.guard + self._scanned - self._pass_start
        halo = min(HALO, self._scanned)
        n = live + (-live) % 32  # the final block is zero-padded
        ring = self._ring
        ring[pos:pos + live].copy_(blk.host[:live], non_blocking=True)
        if n > live:
            ring[pos + live:pos + n].zero_()
        first_gear = not backend.launched("gear")
        t_launch = time.perf_counter()
        words = gear_cuda.gear_bitmap(ring[pos - halo:pos + n],
                                      self.avg_bits, timer=self._timer)
        nwords = (halo + n) // 32
        if self.device.type == "cuda":
            blk.words[:nwords].copy_(words, non_blocking=True)
            blk.done = torch.cuda.Event()
            blk.done.record()
        else:
            blk.words[:nwords] = words
        if first_gear:
            # The process's first G1 launch: its wait includes loading
            # the kernel library.
            backend.sync_bounded(blk.done, "gear bitmap readback")
            backend.note_first_launch("gear", self.block,
                                      time.perf_counter() - t_launch)
        metrics.counter_add("makisu_gear_scan_bytes_total", live,
                            backend=self._backend_label)
        self._inflight.append((blk, halo, live, self._scanned))
        self._scanned += live
        self.blocks += 1
        self.h2d_bytes += live
        self._h2d_unlaunched += live
        while len(self._inflight) > self.PIPELINE_DEPTH:
            self._process_block(self._inflight.popleft())

    def _wrap(self) -> None:
        """Start the next pass over the ring (see the module docstring)."""
        while self._inflight:
            self._process_block(self._inflight.popleft())
        self._last_pass = None
        self._launch_spans()
        if self._last_pass is not None:
            # The service's launch must read this pass before the guard
            # copy and the next slots overwrite it.
            req = self._last_pass
            req.launched.wait()
            if req.done is not None:
                self._stream.wait_event(req.done)
            elif req.future.done() and req.future.exception() is not None:
                raise req.future.exception()
        ring_bytes = self.RING_BLOCKS * self.block
        self._ring[:self.guard].copy_(
            self._ring[ring_bytes:ring_bytes + self.guard])
        self._pass_start += ring_bytes

    def _process_block(self, entry: tuple) -> None:
        """Wait for one block's bitmap and cut chunks at its candidates."""
        blk, halo, live, base = entry
        if blk.done is not None:
            t0 = time.perf_counter()
            backend.sync_bounded(blk.done, "gear bitmap readback")
            self.wait_seconds += time.perf_counter() - t0
        end = halo + live
        candidates = gear.candidates_np(
            blk.words_np[:(end + 31) // 32], halo, end) - halo + base
        self._free.append(blk)
        self._processed = base + live
        for pos in candidates.tolist():
            self._cut_to(pos + 1)  # cut after the boundary byte
        # An oversize span without candidates: force max-size cuts.
        while self._processed - self._prev_cut > self.max_size:
            self._take(self._prev_cut + self.max_size)

    def _cut_to(self, end: int) -> None:
        if end - self._prev_cut < self.min_size:
            return
        while end - self._prev_cut > self.max_size:
            self._take(self._prev_cut + self.max_size)
        if end - self._prev_cut >= self.min_size:
            self._take(end)

    def _take(self, end: int) -> None:
        """Record the chunk [_prev_cut, end) as a span to hash."""
        n = end - self._prev_cut
        if n <= 0:
            return
        self._spans.append((self._prev_cut, n))
        self._prev_cut = end

    def _launch_spans(self) -> None:
        """Hash every span recorded since the last launch, longest first
        (so a warp's lanes have nearly equal block counts), out of the
        ring at the current pass's positions."""
        if not self._spans:
            return
        spans = np.array(self._spans, dtype=np.int64)
        self._spans = []
        spans = spans[np.argsort(-spans[:, 1], kind="stable")]
        cuda = self.device.type == "cuda"
        meta = torch.empty((2, len(spans)), dtype=torch.int32,
                           pin_memory=cuda)
        meta_np = meta.numpy()
        meta_np[0] = spans[:, 0] + (self.guard - self._pass_start)
        meta_np[1] = spans[:, 1]
        if self.service is not None:
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record(self._stream)  # after its last slot copy
            req = self.service.submit_pass(
                self._ring, meta_np[0], meta_np[1], event=event,
                owner=id(self), h2d=self._h2d_unlaunched)
            self._pending.append((req, spans))
            self._last_pass = req
            self._h2d_unlaunched = 0
            self.service_passes += 1
            return
        if cuda:
            dev = meta.to(self.device, non_blocking=True)
            digests = sha256_cuda.sha256_spans(self._ring, dev[0], dev[1],
                                               errors=self._errors,
                                               timer=self._timer)
            out = torch.empty(digests.shape, dtype=torch.uint32,
                              pin_memory=True)
            out.copy_(digests, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            out = sha256_cuda.sha256_spans(self._ring, meta[0], meta[1])
            done = None
        live = int(spans[:, 1].sum())
        metrics.counter_add("makisu_bytes_hashed_total", live,
                            backend=self._backend_label, path="cdc")
        meta_bytes = meta.numel() * meta.element_size()
        # The pinned metadata stays referenced until its copy is done.
        self._pending.append((out, done, spans, meta,
                              self._h2d_unlaunched + meta_bytes, live))
        self._h2d_unlaunched = 0
        self.span_launches += 1
        self.h2d_bytes += meta_bytes

    def _drain(self) -> list[Chunk]:
        """Wait for every S1 launch and pair digests with their spans."""
        out: list[Chunk] = []
        for entry in self._pending:
            if len(entry) == 2:  # a pass the service hashed
                req, spans = entry
                raw = req.future.result().astype(">u4").tobytes()
                out.extend(Chunk(off, n, raw[32 * i:32 * i + 32])
                           for i, (off, n) in enumerate(spans.tolist()))
                continue
            digests, done, spans, meta, h2d, live = entry
            # Timed around the host's wait for the digests only: the
            # host scanned on between the launch and here, and that is
            # not the card's time.
            t0 = time.perf_counter()
            backend.sync_bounded(done, "span digest readback")
            wait = time.perf_counter() - t0
            backend.note_span_launch(backend.SpanLaunch(
                len(spans), live, meta.numel() * meta.element_size(),
                wait))
            backend.note_device_dispatch(self._bucket, len(spans),
                                         len(spans), live, wait, h2d)
            raw = digests.numpy().astype(">u4").tobytes()
            out.extend(Chunk(off, n, raw[32 * i:32 * i + 32])
                       for i, (off, n) in enumerate(spans.tolist()))
        self._pending = []
        self._errors.check()
        return out
