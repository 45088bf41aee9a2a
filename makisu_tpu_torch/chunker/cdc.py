"""Streaming content-defined chunking + lane-parallel chunk hashing.

A ``ChunkSession`` consumes a layer's tar stream in fixed-size blocks
and produces content-defined chunks with SHA-256 fingerprints:

1. Each block, with the previous block's last ``HALO`` bytes in front,
   is copied to the card once; the Gear bitmap kernel
   (``ops/gear_cuda.py``) returns its packed candidate bitmap (1/8 of
   the input bytes), which comes back into a pinned host buffer.
2. A host pass applies the min/max chunk-size policy to the candidate
   positions (a few comparisons per candidate, not per byte).
3. Chunk bytes are packed into the fixed [lanes, cap] buffers of two
   lane buckets and hashed by the lane SHA-256 kernel
   (``ops/sha256_cuda.py``) when a bucket fills, and at ``finish()``.

Copies and launches are asynchronous on the current CUDA stream: up to
``PIPELINE_DEPTH`` blocks are in flight before the host waits on the
oldest block's event, so the card scans while the caller produces bytes.
Pinned host buffers are reused once their copy's event has completed.

The session runs on the card unless it is built with ``device="cpu"``,
where the same pipeline runs the kernels' plain versions (the tests'
route). A device error raises: chunk fingerprints are cache identity,
and nothing here falls back to another route.
"""

from __future__ import annotations

import collections
import contextvars
import time
import typing

import numpy as np
import torch

from makisu_tpu_torch.ops import backend, gear, gear_cuda, sha256_cuda

BLOCK = 4 * 1024 * 1024  # stream bytes per Gear kernel launch
HALO = 128  # previous-block bytes in front of each block (>= WINDOW-1)

# Lane buckets: (capacity, lanes). Chunks average 8 KiB and reach 64 KiB,
# so most hash in the 16 KiB bucket. A chunk of n bytes takes the first
# bucket with n <= cap - 64 (room for the SHA-256 padding).
_BUCKETS = ((16 * 1024, 512), (gear.DEFAULT_MAX_SIZE + 64, 128))

# Fingerprint observer: a per-context callback ``cb(hex_digest)`` that
# sees every chunk fingerprint a session produces (the chunk-dedup
# cache's prefetch hook). Context-scoped so concurrent builds never see
# each other's chunks. Observers must not raise.
_chunk_observer: "contextvars.ContextVar" = contextvars.ContextVar(
    "makisu_torch_chunk_observer", default=None)


def set_chunk_observer(cb):
    """Bind a per-context fingerprint callback ``cb(hex_digest)``.
    Returns a token for :func:`reset_chunk_observer`."""
    return _chunk_observer.set(cb)


def reset_chunk_observer(token) -> None:
    _chunk_observer.reset(token)


class Chunk(typing.NamedTuple):
    offset: int
    length: int
    digest: bytes  # 32-byte sha256

    @property
    def hex(self) -> str:
        return self.digest.hex()


class _HostLanes:
    """One lane bucket's host staging buffers (pinned for the card)."""

    def __init__(self, lanes: int, cap: int, pin: bool) -> None:
        self.data = torch.empty((lanes, cap), dtype=torch.uint8,
                                pin_memory=pin)
        self.lengths = torch.zeros(lanes, dtype=torch.int32, pin_memory=pin)
        self.data_np = self.data.numpy()
        self.lengths_np = self.lengths.numpy()
        self.copied = None  # CUDA event after the buffers' H2D copy


class _LaneBatcher:
    """Packs chunks into one bucket's [lanes, cap] buffer and launches
    the lane SHA-256 kernel when it is full."""

    def __init__(self, cap: int, lanes: int, device: torch.device) -> None:
        self.cap = cap
        self.lanes = lanes
        self.device = device
        self._cuda = device.type == "cuda"
        if self._cuda:
            sha256_cuda.parity_probe(lanes, cap, device)
            self._dev_data = torch.empty((lanes, cap), dtype=torch.uint8,
                                         device=device)
            self._dev_lengths = torch.empty(lanes, dtype=torch.int32,
                                            device=device)
        # Two host buffers alternate on the card: one fills while the
        # other's copy drains.
        self._host = [_HostLanes(lanes, cap, self._cuda)
                      for _ in range(2 if self._cuda else 1)]
        self._cur = 0
        self.meta: list[tuple[int, int]] = []  # (offset, length) per lane
        # (digests, done event or None, meta) per launch, oldest first.
        self.pending: list[tuple[torch.Tensor, object, list]] = []

    def add(self, off: int, data: memoryview) -> None:
        i = len(self.meta)
        n = len(data)
        host = self._host[self._cur]
        host.data_np[i, :n] = np.frombuffer(data, dtype=np.uint8)
        host.lengths_np[i] = n
        self.meta.append((off, n))
        if len(self.meta) == self.lanes:
            self.flush()

    def flush(self) -> None:
        if not self.meta:
            return
        host = self._host[self._cur]
        # Lanes past the filled ones hash as empty messages; bytes past
        # a lane's length are ignored, so the buffer is never cleared.
        host.lengths_np[len(self.meta):] = 0
        if not self._cuda:
            digests = sha256_cuda.sha256_lanes(host.data, host.lengths)
            self.pending.append((digests, None, self.meta))
            self.meta = []
            return
        self._dev_data.copy_(host.data, non_blocking=True)
        self._dev_lengths.copy_(host.lengths, non_blocking=True)
        host.copied = torch.cuda.Event()
        host.copied.record()
        digests = sha256_cuda.sha256_lanes(self._dev_data, self._dev_lengths)
        out = torch.empty((self.lanes, 8), dtype=torch.uint32,
                          pin_memory=True)
        out.copy_(digests, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self.pending.append((out, done, self.meta))
        self.meta = []
        self._cur = (self._cur + 1) % len(self._host)
        nxt = self._host[self._cur]
        if nxt.copied is not None:
            nxt.copied.synchronize()  # its previous copy must have left

    def drain(self) -> list[Chunk]:
        self.flush()
        out: list[Chunk] = []
        for digests, done, meta in self.pending:
            t0 = time.perf_counter()
            if done is not None:
                done.synchronize()
            backend.note_device_dispatch(
                self.cap, self.lanes, len(meta), sum(n for _, n in meta),
                time.perf_counter() - t0)
            raw = digests.numpy()[:len(meta)].astype(">u4").tobytes()
            out.extend(Chunk(off, n, raw[32 * i:32 * i + 32])
                       for i, (off, n) in enumerate(meta))
        self.pending = []
        sha256_cuda.check_lengths(self.device)
        return out


class _BlockSlot:
    """Staging for one Gear launch: the halo-prefixed block on the host
    (pinned for the card), its device copy, and the bitmap's host copy."""

    def __init__(self, size: int, device: torch.device) -> None:
        pin = device.type == "cuda"
        self.host = torch.empty(size, dtype=torch.uint8, pin_memory=pin)
        self.host_np = self.host.numpy()
        self.dev = (torch.empty(size, dtype=torch.uint8, device=device)
                    if pin else self.host)
        self.words = torch.empty(size // 32, dtype=torch.uint32,
                                 pin_memory=pin)
        self.words_np = self.words.numpy()
        self.done = None  # CUDA event after the bitmap's D2H copy


class ChunkSession:
    """One layer stream -> content-defined chunks with fingerprints."""

    # Gear launches in flight before the host waits on the oldest one.
    PIPELINE_DEPTH = 2

    def __init__(self, avg_bits: int = gear.DEFAULT_AVG_BITS,
                 min_size: int = gear.DEFAULT_MIN_SIZE,
                 max_size: int = gear.DEFAULT_MAX_SIZE,
                 block: int = BLOCK, device=None) -> None:
        if block <= 0 or block % 32:
            raise ValueError("block size must be a positive multiple of 32")
        if not 0 < min_size <= max_size <= _BUCKETS[-1][0] - 64:
            raise ValueError(
                f"chunk sizes need 0 < min ({min_size}) <= max "
                f"({max_size}) <= {_BUCKETS[-1][0] - 64}")
        self.device = backend.resolve_device(device)
        self.avg_bits = avg_bits
        self.min_size = min_size
        self.max_size = max_size
        self.block = block
        self._staging = bytearray()   # bytes not yet scanned
        self._tail = bytearray()      # scanned bytes after the last cut
        self._tail_offset = 0         # stream offset of _tail[0]
        self._scanned = 0             # stream bytes dispatched so far
        self._halo = b""              # last HALO bytes of the last block
        self._prev_cut = 0            # stream offset of the last cut
        self._inflight: collections.deque = collections.deque()
        self._free: list[_BlockSlot] = []
        self._batchers = [_LaneBatcher(cap, lanes, self.device)
                          for cap, lanes in _BUCKETS]
        self._chunks: list[Chunk] = []
        self._observer = _chunk_observer.get()
        # Host seconds spent inside update() and finish(), and the part
        # of them spent waiting for a bitmap.
        self.host_seconds = 0.0
        self.wait_seconds = 0.0
        self.blocks = 0

    # -- byte intake ------------------------------------------------------

    def update(self, data) -> None:
        t0 = time.perf_counter()
        self._staging += data
        while len(self._staging) >= self.block:
            self._dispatch_block(self.block)
        self.host_seconds += time.perf_counter() - t0

    def finish(self) -> list[Chunk]:
        t0 = time.perf_counter()
        if self._staging:
            self._dispatch_block(len(self._staging))
        while self._inflight:
            self._process_block(self._inflight.popleft())
        stream_end = self._tail_offset + len(self._tail)
        if stream_end > self._prev_cut:
            self._take(stream_end)  # the final chunk
        for b in self._batchers:
            self._chunks.extend(b.drain())
        self._chunks.sort(key=lambda c: c.offset)
        if self._observer is not None:
            for c in self._chunks:
                self._observer(c.hex)
        self.host_seconds += time.perf_counter() - t0
        return self._chunks

    # -- internals --------------------------------------------------------

    def _dispatch_block(self, live: int) -> None:
        """Stage the halo and the next ``live`` staged bytes, launch the
        Gear kernel on them, and process the oldest in-flight block once
        the pipeline is full."""
        slot = self._free.pop() if self._free else \
            _BlockSlot(HALO + self.block, self.device)
        halo_len = len(self._halo)
        end = halo_len + live
        n = end + (-live) % 32  # the final block is zero-padded
        buf = slot.host_np
        buf[:halo_len] = np.frombuffer(self._halo, dtype=np.uint8)
        with memoryview(self._staging) as mv:
            buf[halo_len:end] = np.frombuffer(mv[:live], dtype=np.uint8)
        del self._staging[:live]
        buf[end:n] = 0
        self._halo = buf[max(0, end - HALO):end].tobytes()
        if self.device.type == "cuda":
            slot.dev[:n].copy_(slot.host[:n], non_blocking=True)
            words = gear_cuda.gear_bitmap(slot.dev[:n], self.avg_bits)
            slot.words[:n // 32].copy_(words, non_blocking=True)
            slot.done = torch.cuda.Event()
            slot.done.record()
        else:
            slot.words[:n // 32] = gear_cuda.gear_bitmap(slot.dev[:n],
                                                         self.avg_bits)
        self._inflight.append((slot, halo_len, live, self._scanned))
        self._scanned += live
        self.blocks += 1
        while len(self._inflight) > self.PIPELINE_DEPTH:
            self._process_block(self._inflight.popleft())

    def _process_block(self, entry: tuple) -> None:
        """Wait for one block's bitmap and cut chunks at its candidates."""
        slot, halo_len, live, base = entry
        if slot.done is not None:
            t0 = time.perf_counter()
            slot.done.synchronize()
            self.wait_seconds += time.perf_counter() - t0
        end = halo_len + live
        candidates = gear.candidates_np(
            slot.words_np[:(end + 31) // 32], halo_len, end) - halo_len + base
        self._tail += memoryview(slot.host_np[halo_len:end])
        self._free.append(slot)
        for pos in candidates.tolist():
            self._cut_to(pos + 1)  # cut after the boundary byte
        # An oversize span without candidates: force max-size cuts.
        while (self._tail_offset + len(self._tail) - self._prev_cut
               > self.max_size):
            self._take(self._prev_cut + self.max_size)

    def _cut_to(self, end: int) -> None:
        if end - self._prev_cut < self.min_size:
            return
        while end - self._prev_cut > self.max_size:
            self._take(self._prev_cut + self.max_size)
        if end - self._prev_cut >= self.min_size:
            self._take(end)

    def _take(self, end: int) -> None:
        """Cut the chunk [_prev_cut, end) off the tail into a lane."""
        n = end - self._prev_cut
        if n <= 0:
            return
        with memoryview(self._tail) as mv:
            for b in self._batchers:
                if n <= b.cap - 64:
                    b.add(self._tail_offset, mv[:n])
                    break
        del self._tail[:n]
        self._tail_offset = end
        self._prev_cut = end
