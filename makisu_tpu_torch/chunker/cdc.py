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
  the guard. Copies and kernels share the current stream, so that launch
  reads the slots before the copy that overwrites them.
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

The session runs on the card unless it is built with ``device="cpu"``,
where the same ring is a CPU tensor and the same code runs the kernels'
plain versions (the tests' route). A device error raises: chunk
fingerprints are cache identity, and nothing here falls back to another
route.
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
HALO = 128  # ring bytes in front of each block that G1 reads (>= WINDOW-1)
MAX_CHUNK = gear.DEFAULT_MAX_SIZE  # the largest max_size a session takes

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
                 block: int = BLOCK, device=None) -> None:
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
        if self.device.type == "cuda":
            sha256_cuda.parity_probe(self.device)
        self._ring = torch.empty(self.guard + ring_bytes, dtype=torch.uint8,
                                 device=self.device)
        self._cur: _HostBlock | None = None  # the block being filled
        self._fill = 0                # bytes in it
        self._free: list[_HostBlock] = []
        self._inflight: collections.deque = collections.deque()
        self._scanned = 0             # stream bytes sent to the ring
        self._processed = 0           # stream bytes whose cuts are made
        self._pass_start = 0          # stream offset of slot 0's first byte
        self._prev_cut = 0            # stream offset of the last cut
        self._spans: list[tuple[int, int]] = []  # cut since the last S1
        # (digests, done event or None, sorted spans [S, 2], metadata)
        # per S1 launch, oldest first.
        self._pending: list[tuple] = []
        self._observer = _chunk_observer.get()
        # Host seconds spent inside update() and finish(), and the part
        # of them spent waiting for a bitmap.
        self.host_seconds = 0.0
        self.wait_seconds = 0.0
        self.blocks = 0
        self.span_launches = 0
        self.h2d_bytes = 0  # stream bytes + span metadata sent to the ring

    # -- byte intake ------------------------------------------------------

    def update(self, data) -> None:
        t0 = time.perf_counter()
        src = np.frombuffer(data, dtype=np.uint8)
        i = 0
        while i < len(src):
            if self._cur is None:
                self._cur = self._free.pop() if self._free else \
                    _HostBlock(self.block, self.device)
            take = min(self.block - self._fill, len(src) - i)
            self._cur.host_np[self._fill:self._fill + take] = src[i:i + take]
            self._fill += take
            i += take
            if self._fill == self.block:
                self._dispatch_block()
        self.host_seconds += time.perf_counter() - t0

    def finish(self) -> list[Chunk]:
        t0 = time.perf_counter()
        if self._fill:
            self._dispatch_block()
        while self._inflight:
            self._process_block(self._inflight.popleft())
        self._take(self._processed)  # the final chunk
        self._launch_spans()
        chunks = self._drain()
        chunks.sort(key=lambda c: c.offset)
        for c in chunks:
            self._notify(c.hex)
        self.host_seconds += time.perf_counter() - t0
        return chunks

    # -- internals --------------------------------------------------------

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
        words = gear_cuda.gear_bitmap(ring[pos - halo:pos + n],
                                      self.avg_bits)
        nwords = (halo + n) // 32
        if self.device.type == "cuda":
            blk.words[:nwords].copy_(words, non_blocking=True)
            blk.done = torch.cuda.Event()
            blk.done.record()
        else:
            blk.words[:nwords] = words
        self._inflight.append((blk, halo, live, self._scanned))
        self._scanned += live
        self.blocks += 1
        self.h2d_bytes += live
        while len(self._inflight) > self.PIPELINE_DEPTH:
            self._process_block(self._inflight.popleft())

    def _wrap(self) -> None:
        """Start the next pass over the ring (see the module docstring)."""
        while self._inflight:
            self._process_block(self._inflight.popleft())
        self._launch_spans()
        ring_bytes = self.RING_BLOCKS * self.block
        self._ring[:self.guard].copy_(
            self._ring[ring_bytes:ring_bytes + self.guard])
        self._pass_start += ring_bytes

    def _process_block(self, entry: tuple) -> None:
        """Wait for one block's bitmap and cut chunks at its candidates."""
        blk, halo, live, base = entry
        if blk.done is not None:
            t0 = time.perf_counter()
            blk.done.synchronize()
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
        if cuda:
            dev = meta.to(self.device, non_blocking=True)
            digests = sha256_cuda.sha256_spans(self._ring, dev[0], dev[1])
            out = torch.empty(digests.shape, dtype=torch.uint32,
                              pin_memory=True)
            out.copy_(digests, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            out = sha256_cuda.sha256_spans(self._ring, meta[0], meta[1])
            done = None
        # The pinned metadata stays referenced until its copy is done.
        self._pending.append((out, done, spans, meta))
        self.span_launches += 1
        self.h2d_bytes += meta.numel() * meta.element_size()

    def _drain(self) -> list[Chunk]:
        """Wait for every S1 launch and pair digests with their spans."""
        out: list[Chunk] = []
        for digests, done, spans, meta in self._pending:
            t0 = time.perf_counter()
            if done is not None:
                done.synchronize()
            backend.note_span_launch(backend.SpanLaunch(
                len(spans), int(spans[:, 1].sum()),
                meta.numel() * meta.element_size(),
                time.perf_counter() - t0))
            raw = digests.numpy().astype(">u4").tobytes()
            out.extend(Chunk(off, n, raw[32 * i:32 * i + 32])
                       for i, (off, n) in enumerate(spans.tolist()))
        self._pending = []
        sha256_cuda.check_lengths(self.device)
        return out
