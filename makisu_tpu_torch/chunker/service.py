"""Shared hash service: many concurrent builds, one card.

Counterpart of ``makisu_tpu/chunker/service.py``, redesigned for the
device ring. A build farm node (a worker: BASELINE.md config 5, 64
concurrent build jobs sharing one accelerator) should not have each
build launch S1 over its own ring pass alone. The reference batches
chunk *bytes* into fixed lane buckets; the port keeps a layer's chunks
in its session's ring as spans, so a request here is one **ring pass**:
the session's ring tensor, the pass's spans (ring offset, length) and an
event recorded on the session's stream after its last slot copy.

One dispatcher thread takes the first request and lingers up to
``utils.concurrency.hash_linger_ms()`` for more (taking at once whatever
is already queued), up to ``max_batch`` passes. It makes the service's
stream wait on every request's event, launches S1's multi-buffer entry
once over all the batch's spans (longest first across the requests),
records a done event, marks each request launched (a session must not
write its ring again before that: it makes its own stream wait on the
done event) and resolves every request's future with its digests, in
the request's span order, once they are back on the host. The batch
holds each ring until then.

A launch error, a span outside its ring or a readback that outlasts
``backend.sync_timeout()`` raises in every future of the batch; nothing
retries on the CPU. On the card the service waits, bounded, for the
device plane to come up (``backend.require_ready``) before its first
launch, and raises the probe's summary if it does not. ``submit_pass``
blocks once ``QUEUE_DEPTH_BATCHES`` full batches of passes are waiting
(backpressure). With ``device="cpu"`` the same service runs the plain
multi-buffer version (the tests' route); a ring pass is then hashed
before the request is marked launched.

Telemetry per batch, in the process registry (the dispatcher runs
outside any build's context; a batch can mix builds):
``makisu_hash_batches_total``, ``makisu_hash_cross_build_batches_total``
(batches with passes of more than one session), ``makisu_hash_batch_
seconds`` (launch to digests on the host), ``makisu_hash_batch_fill``
(passes per launch), ``makisu_hash_batch_occupancy`` (passes / the
service's largest batch, ``max_batch``), ``makisu_hash_batch_linger_
seconds``, ``makisu_hash_queue_depth``, ``makisu_hash_batch_failures_
total``, ``makisu_bytes_hashed_total{path="service"}``, one
``note_device_dispatch`` per launch and, on the card, the launch's
kernel seconds (``backend.KernelTimer``),
``makisu_device_busy_seconds_total{kernel="sha256_multi"}``.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from makisu_tpu_torch.chunker import cdc
from makisu_tpu_torch.ops import backend, sha256_cuda
from makisu_tpu_torch.utils import concurrency, metrics

# makisu_hash_batch_fill buckets: passes per launch, powers of two up to
# the default largest batch.
_FILL_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
# makisu_hash_batch_occupancy buckets: passes / the largest batch.
_OCCUPANCY_BUCKETS = (0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)


class PassRequest:
    """One ring pass submitted to the service. ``launched`` is set once
    the batch's S1 launch is enqueued (on the CPU: once it ran) or the
    batch failed; ``done`` is then the batch's CUDA done event (None on
    the CPU or after a failure); ``future`` resolves to uint32 [S, 8]
    digest words in the request's span order."""

    __slots__ = ("ring", "offsets", "lengths", "event", "owner", "h2d",
                 "future", "launched", "done")

    def __init__(self, ring: torch.Tensor, offsets: np.ndarray,
                 lengths: np.ndarray, event, owner, h2d: int) -> None:
        self.ring = ring
        self.offsets = offsets
        self.lengths = lengths
        self.event = event
        self.owner = owner
        self.h2d = h2d
        self.future: Future = Future()
        self.launched = threading.Event()
        self.done = None

    def fail(self, exc: BaseException) -> None:
        self.ring = None
        self.launched.set()
        if not self.future.done():
            self.future.set_exception(exc)


class HashService:
    """Cross-build ring-pass batcher. Thread-safe; one per process and
    device (``shared_service``). ``device=None`` is the card."""

    # Backpressure: at most this many full batches of passes wait.
    QUEUE_DEPTH_BATCHES = 2
    # Passes per launch at most: config 5's 64 concurrent builds.
    MAX_BATCH = 64

    def __init__(self, linger_seconds: float | None = None, device=None,
                 max_batch: int = MAX_BATCH) -> None:
        if linger_seconds is None:
            linger_seconds = concurrency.hash_linger_ms() / 1000.0
        if max_batch < 1:
            raise ValueError(f"max_batch must be at least 1, got {max_batch}")
        self.device = backend.resolve_device(device)
        self.linger = linger_seconds
        self.max_batch = max_batch
        self._stream = None
        self._timer = None  # each launch's kernel seconds, on the card
        if self.device.type == "cuda":
            backend.require_ready(self.device)
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self.device)
            self._timer = backend.KernelTimer()
        # The bucket label of the service's series: the default ring's
        # bytes, the program capacity the direct route exports under.
        self.bucket = cdc.ChunkSession.RING_BLOCKS * cdc.BLOCK
        self._queue: queue.Queue = queue.Queue(
            maxsize=max_batch * self.QUEUE_DEPTH_BATCHES)
        self._closed = threading.Event()
        self.batches = 0  # S1 launches
        # Batches that mixed passes of more than one session: concurrent
        # builds sharing a launch.
        self.cross_build_batches = 0
        self.passes = 0
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True, name="hashsvc")
        self._thread.start()

    # -- submission ---------------------------------------------------------

    def submit_pass(self, ring: torch.Tensor, offsets, lengths, event=None,
                    owner=None, h2d: int = 0) -> PassRequest:
        """Queue one ring pass: spans (``offsets[i]``, ``lengths[i]``) of
        the uint8 ``ring``, readable once ``event`` (recorded on the
        writer's stream after its last write; None on the CPU) fired.
        ``owner`` names the submitting session, ``h2d`` the bytes its
        slot copies moved since its last pass (the device plane's H2D
        series). Blocks while the queue is full."""
        if ring.device != self.device:
            raise ValueError(f"a ring on {ring.device} submitted to the "
                             f"hash service on {self.device}")
        req = PassRequest(ring, np.asarray(offsets, dtype=np.int64),
                          np.asarray(lengths, dtype=np.int64), event, owner,
                          h2d)
        self._put(req)
        return req

    def _put(self, req: PassRequest) -> None:
        while True:
            if self._closed.is_set():
                raise RuntimeError("hash service closed")
            try:
                self._queue.put(req, timeout=0.1)
                break
            except queue.Full:
                continue
        if self._closed.is_set():
            self._fail_queued()  # queued after close drained the queue

    # -- the dispatcher -----------------------------------------------------

    def _dispatch_loop(self) -> None:
        while not self._closed.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            t0 = time.monotonic()
            while len(batch) < self.max_batch:
                remaining = self.linger - (time.monotonic() - t0)
                try:
                    batch.append(self._queue.get(timeout=remaining)
                                 if remaining > 0 else
                                 self._queue.get_nowait())
                except queue.Empty:
                    break
            metrics.observe(metrics.HASH_BATCH_LINGER,
                            time.monotonic() - t0, bucket=self.bucket)
            metrics.gauge_set(metrics.HASH_QUEUE_DEPTH, self._queue.qsize(),
                              bucket=self.bucket)
            self._run_batch(batch)

    def _run_batch(self, batch: list[PassRequest]) -> None:
        counts = [len(r.offsets) for r in batch]
        index = np.repeat(np.arange(len(batch), dtype=np.int64), counts)
        offsets = np.concatenate([r.offsets for r in batch])
        lengths = np.concatenate([r.lengths for r in batch])
        order = np.argsort(-lengths, kind="stable")  # longest first
        bufs = [r.ring for r in batch]
        meta_bytes = (sha256_cuda.MULTI_META_BYTES * len(order)
                      + 8 * len(batch))
        t0 = time.monotonic()
        try:
            sorted_words = self._launch(batch, bufs, index[order],
                                        offsets[order], lengths[order])
        except BaseException as e:  # noqa: BLE001 - fails every future
            metrics.counter_add(metrics.HASH_BATCH_FAILURES,
                                bucket=self.bucket)
            for r in batch:
                r.fail(e)
            return
        seconds = time.monotonic() - t0
        words = np.empty_like(sorted_words)
        words[order] = sorted_words
        live = int(lengths.sum())
        self.batches += 1
        self.passes += len(batch)
        backend.note_device_dispatch(
            self.bucket, len(order), len(order), live, seconds,
            meta_bytes + sum(r.h2d for r in batch))
        owners = {r.owner for r in batch if r.owner is not None}
        if len(owners) > 1:
            self.cross_build_batches += 1
            metrics.counter_add(metrics.HASH_CROSS_BUILD_BATCHES)
        metrics.counter_add(metrics.HASH_BATCHES, bucket=self.bucket)
        metrics.counter_add("makisu_bytes_hashed_total", live,
                            backend=self.device.type, path="service")
        metrics.observe(metrics.HASH_BATCH_SECONDS, seconds,
                        bucket=self.bucket)
        metrics.observe(metrics.HASH_BATCH_FILL, len(batch),
                        buckets=_FILL_BUCKETS, bucket=self.bucket)
        metrics.observe(metrics.HASH_BATCH_OCCUPANCY,
                        len(batch) / self.max_batch,
                        buckets=_OCCUPANCY_BUCKETS, bucket=self.bucket)
        start = 0
        for r, n in zip(batch, counts):
            mine = words[start:start + n]
            start += n
            r.ring = None  # read: the session may free or reuse it
            r.future.set_result(mine)

    def _launch(self, batch: list[PassRequest], bufs, index, offsets,
                lengths) -> np.ndarray:
        """One S1 launch over the batch's sorted spans -> host digest
        words in that order. Marks every request launched once the
        launch is enqueued (the CPU: once it ran)."""
        if self._stream is None:
            words = sha256_cuda.sha256_multi(bufs, index, offsets, lengths)
            for r in batch:
                r.launched.set()
            return words.numpy()
        errors = sha256_cuda.LaunchErrors()
        with torch.cuda.stream(self._stream):
            for r in batch:
                if r.event is not None:
                    self._stream.wait_event(r.event)
            words = sha256_cuda.sha256_multi(bufs, index, offsets, lengths,
                                             errors=errors,
                                             timer=self._timer)
            host = torch.empty(words.shape, dtype=torch.uint32,
                               pin_memory=True)
            host.copy_(words, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        for r in batch:
            r.done = done
            r.launched.set()
        backend.sync_bounded(done, "service batch readback")
        for kernel, seconds in self._timer.seconds().items():
            metrics.counter_add(metrics.DEVICE_BUSY_SECONDS, seconds,
                                kernel=kernel)
        errors.check()
        return host.numpy()

    def close(self) -> None:
        """Stop the dispatcher; fail every pass still queued, and every
        submit still blocked on a full queue, so no caller waits forever
        on its future."""
        self._closed.set()
        self._thread.join(timeout=5)
        self._fail_queued()

    def _fail_queued(self) -> None:
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.fail(RuntimeError("hash service closed"))


_services: dict[str, HashService] = {}
_services_lock = threading.Lock()


def shared_service(device=None) -> HashService:
    """The process-wide service of ``device`` (None: the card). A worker
    turns it on for every build (``MAKISU_TPU_SHARED_HASH=1``)."""
    dev = backend.resolve_device(device)
    with _services_lock:
        svc = _services.get(str(dev))
        if svc is None:
            svc = _services[str(dev)] = HashService(device=dev)
        return svc
