"""Bounded-memory parallel transfer engine for registry wire traffic.

One process-wide engine fronts every blob-plane transfer — base-image
pulls, layer pushes, chunk/pack fetches — so concurrency and memory are
governed globally instead of per call site (the reference bounds
transfers with a per-registry WorkerPool, lib/registry/client.go:111-214;
"Bounded-Memory Parallel Image Pulling for Large Container Images",
PAPERS.md, shows parallel ranged pulls under a global memory budget
beating serial streaming without unbounded host RAM).

Two pools, strictly tiered to make deadlock impossible by construction:

- the **blob pool** runs blob-granular leaf operations (one whole-blob
  pull/push, one pack-run fetch). Blob tasks never submit further blob
  tasks.
- the **part pool** runs the ranged parts a large blob splits into.
  Part tasks are pure leaves.

The **memory budget** bounds bytes simultaneously materialized in RAM
by transfers: every ranged part reserves its length before the request
goes out and releases after its bytes hit the destination file;
streaming whole-blob transfers reserve only their 1MiB read buffer.
The ``makisu_transfer_inflight_bytes`` gauge tracks the reservation
level and can never exceed the configured budget.

Copy of ``makisu_tpu/registry/transfer.py``, its gauges and progress
clock included.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Iterable

from makisu_tpu_torch.utils import events
from makisu_tpu_torch.utils import logging as log
from makisu_tpu_torch.utils import metrics

# Monotonic timestamp of the engine's last observable progress (task
# admitted or finished, budget bytes released) — the transfer half of
# the build-progress clock; utils/flightrecorder.py combines it with
# the event bus's half for the stall watchdog and /healthz.
_last_progress = time.monotonic()


def last_progress_monotonic() -> float:
    return _last_progress


def _note_progress() -> None:
    global _last_progress
    _last_progress = time.monotonic()
    # Also stamp the calling build's per-context progress cell (task
    # bodies run under the submitter's copied context): a per-build
    # watchdog must see ITS transfers move, not just the process's.
    events.note_progress()

DEFAULT_CONCURRENCY = 8
DEFAULT_MEMORY_BUDGET = 256 * 1024 * 1024   # bytes in flight across pools
DEFAULT_PART_SIZE = 16 * 1024 * 1024        # ranged-part granularity

# Budget charged by a streaming (non-ranged) transfer: its resident
# footprint is one read buffer, not the blob.
STREAM_RESERVE = 1 << 20


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class MemoryBudget:
    """Counting semaphore over bytes. ``acquire`` blocks until the
    reservation fits; a single reservation larger than the whole budget
    is admitted only alone (it must not deadlock, and refusing it would
    turn an oversized blob into a build failure instead of a serial
    transfer). Deliberately BARGING (condition wait, no arrival
    ordering): a small part must be admittable past a blocked oversized
    reservation, or transfer throughput would head-of-line block."""

    def __init__(self, limit: int) -> None:
        self.limit = max(int(limit), 1)
        self._used = 0
        self._cond = threading.Condition()

    @property
    def inflight(self) -> int:
        with self._cond:
            return self._used

    def acquire(self, nbytes: int) -> None:
        nbytes = max(int(nbytes), 0)
        with self._cond:
            while self._used + nbytes > self.limit and self._used > 0:
                self._cond.wait()
            self._used += nbytes
            metrics.gauge_set("makisu_transfer_inflight_bytes",
                              self._used)

    def release(self, nbytes: int) -> None:
        nbytes = max(int(nbytes), 0)
        _note_progress()  # bytes landed: the transfer is moving
        with self._cond:
            self._used = max(self._used - nbytes, 0)
            metrics.gauge_set("makisu_transfer_inflight_bytes",
                              self._used)
            self._cond.notify_all()

    @contextlib.contextmanager
    def reserve(self, nbytes: int):
        self.acquire(nbytes)
        try:
            yield
        finally:
            self.release(nbytes)


class TransferEngine:
    """Shared bounded transfer pools + in-flight-bytes budget."""

    def __init__(self, concurrency_: int | None = None,
                 memory_budget: int | None = None,
                 part_size: int | None = None) -> None:
        self.concurrency = max(concurrency_ or _env_int(
            "MAKISU_TPU_TRANSFER_CONCURRENCY", DEFAULT_CONCURRENCY), 1)
        self.part_size = max(part_size or _env_int(
            "MAKISU_TPU_TRANSFER_PART_MB",
            DEFAULT_PART_SIZE >> 20) << 20, 1 << 20)
        budget = memory_budget or _env_int(
            "MAKISU_TPU_TRANSFER_MEMORY_BUDGET_MB",
            DEFAULT_MEMORY_BUDGET >> 20) << 20
        self.budget = MemoryBudget(budget)
        self._blob_pool = ThreadPoolExecutor(
            self.concurrency, thread_name_prefix="transfer-blob")
        self._part_pool = ThreadPoolExecutor(
            self.concurrency, thread_name_prefix="transfer-part")
        self._depth = 0
        self._depth_lock = threading.Lock()

    # -- queue-depth accounting -------------------------------------------

    def _enter(self) -> None:
        _note_progress()
        with self._depth_lock:
            self._depth += 1
            metrics.gauge_set("makisu_transfer_queue_depth", self._depth)

    def _exit(self) -> None:
        _note_progress()
        with self._depth_lock:
            self._depth = max(self._depth - 1, 0)
            metrics.gauge_set("makisu_transfer_queue_depth", self._depth)

    def snapshot(self) -> dict[str, Any]:
        """In-flight state for diagnostic bundles: how much work (and
        memory) was mid-air when the build died. Deliberately
        LOCK-FREE dirty reads: a signal handler may call this having
        interrupted a frame that holds ``_depth_lock`` or the budget
        condition — int attribute reads are atomic under the GIL and
        a slightly stale value is fine for forensics, a deadlocked
        dying process is not."""
        return {
            "queue_depth": self._depth,
            "inflight_bytes": self.budget._used,
            "budget_limit_bytes": self.budget.limit,
            "concurrency": self.concurrency,
            "part_size_bytes": self.part_size,
            "last_progress_seconds": round(
                time.monotonic() - _last_progress, 3),
        }

    # -- blob-granular API -------------------------------------------------

    def submit(self, fn: Callable, *args: Any) -> Future:
        """Run a blob-granular task on the shared pool, carrying the
        caller's contextvars (build telemetry registry / trace id) like
        ``concurrency.ctx_map`` does. Blob tasks must be leaves: they
        may use the part pool and the budget, never ``submit``/``map``
        (the tier rule that keeps the shared pool deadlock-free)."""
        import contextvars
        ctx = contextvars.copy_context()
        self._enter()
        future = self._blob_pool.submit(ctx.run, fn, *args)
        # Done-callback, not a task-body finally: it fires for
        # cancelled futures too (an abandoned pull's), so the
        # queue-depth gauge can't leak.
        future.add_done_callback(lambda _: self._exit())
        return future

    def map(self, fn: Callable[[Any], Any], items: Iterable[Any]) -> list:
        """Blocking parallel map of a blob-granular leaf over items."""
        futures = [self.submit(fn, item) for item in items]
        # Collect everything before raising so a failure never leaks
        # still-running siblings past the call.
        results, first_error = [], None
        for f in futures:
            try:
                results.append(f.result())
            except BaseException as e:  # noqa: BLE001 - re-raised below
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error
        return results

    # -- ranged multi-part pulls ------------------------------------------

    def should_split(self, size: int) -> bool:
        return size >= 2 * self.part_size and self.concurrency > 1

    def pull_blob_parts(self, client, digest, size: int,
                        dest_path: str) -> str | None:
        """Download one large blob as concurrent HTTP Range parts
        reassembled at-offset into ``dest_path``. Returns the hex
        sha256 of the reassembled bytes, or None when the caller must
        fall back to a streaming whole-blob GET (Range unsupported
        parts exhausted their retries). A 200 "full" response — the
        server ignored Range — short-circuits: its body IS the blob,
        the remaining parts are cancelled, and nothing is wasted.

        Memory: each in-flight part reserves its length against the
        engine budget before its request is issued, so peak resident
        bytes never exceed the budget no matter how many blobs pull
        concurrently. The first part is a sequential PROBE that
        STREAMS to the destination file: a server that ignores Range
        answers it with the whole blob as one 200, which then flows to
        disk through a 1MiB buffer — never a whole-blob
        materialization in RAM, and never one full copy per concurrent
        part."""
        parts = [(off, min(off + self.part_size, size))
                 for off in range(0, size, self.part_size)]
        # The probe streams: resident bytes are one read buffer, or
        # the whole part when the part is smaller than the buffer.
        with self.budget.reserve(min(STREAM_RESERVE,
                                     parts[0][1] - parts[0][0])):
            probe = client.pull_blob_range_to_file(
                digest, parts[0][0], parts[0][1], dest_path)
        if probe is None:
            return None
        kind, nbytes, sha = probe
        if kind == "full":
            if nbytes != size:
                return None  # truncated 200: the streaming route retries
            if sha:
                return sha
        elif len(parts) > 1:
            done = threading.Event()  # unrecoverable: stop other parts
            fd = os.open(dest_path, os.O_WRONLY)

            def fetch(span: tuple[int, int]) -> bool:
                start, end = span
                for attempt in range(2):
                    if done.is_set():
                        return False
                    # The reservation covers the part bytes from the
                    # moment the request goes out until they are on
                    # disk.
                    with self.budget.reserve(end - start):
                        got = client.pull_blob_range(digest, start, end)
                        if got is not None:
                            part_kind, data = got
                            if part_kind == "full":
                                # The probe got a 206 but this part a
                                # 200: Range semantics are broken here
                                # — degrade to the streaming route.
                                done.set()
                                return False
                            os.pwrite(fd, data, start)
                            return True
                    if attempt == 0:
                        metrics.counter_add(
                            "makisu_transfer_part_retries_total")
                done.set()
                return False

            import contextvars
            try:
                os.ftruncate(fd, size)
                futures = []
                for span in parts[1:]:
                    ctx = contextvars.copy_context()
                    futures.append(
                        self._part_pool.submit(ctx.run, fetch, span))
                # Drain EVERY future before the fd can close: a part
                # failing fast must not leave siblings pwriting into a
                # closed (possibly reused) descriptor.
                ok, first_error = True, None
                for future in futures:
                    try:
                        ok = future.result() and ok
                    except BaseException as e:  # noqa: BLE001
                        done.set()
                        ok = False
                        if first_error is None:
                            first_error = e
                if first_error is not None:
                    raise first_error
                if not ok:
                    return None
            finally:
                os.close(fd)
        import hashlib
        h = hashlib.sha256()
        with open(dest_path, "rb") as f:
            for block in iter(lambda: f.read(1 << 20), b""):
                h.update(block)
        return h.hexdigest()


# -- process-global engine --------------------------------------------------

_engine: TransferEngine | None = None
_engine_lock = threading.Lock()


def engine() -> TransferEngine:
    """The process-wide engine, created lazily from the environment
    (``MAKISU_TPU_TRANSFER_CONCURRENCY`` / ``..._MEMORY_BUDGET_MB`` /
    ``..._PART_MB``; the CLI's ``--transfer-*`` flags feed these)."""
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = TransferEngine()
        return _engine


def peek() -> TransferEngine | None:
    """The live engine WITHOUT creating one — diagnostics must not
    spin up transfer pools in a process that never transferred.
    Lock-free on purpose: a signal handler calls this and may have
    interrupted a frame inside engine()/configure() that holds
    ``_engine_lock``; a module-global read is atomic under the GIL."""
    return _engine


def configure(concurrency_: int = 0, memory_budget_mb: int = 0) -> None:
    """Apply CLI flags. Before the engine exists, flags land in the
    environment so the lazy constructor sees them; after (a later
    command in the same process with other flags), the budget adjusts in
    place — it is just a limit — while a concurrency change only logs:
    resizing a pool under live transfers is not worth the risk."""
    if concurrency_:
        os.environ["MAKISU_TPU_TRANSFER_CONCURRENCY"] = str(concurrency_)
    if memory_budget_mb:
        os.environ["MAKISU_TPU_TRANSFER_MEMORY_BUDGET_MB"] = \
            str(memory_budget_mb)
    with _engine_lock:
        live = _engine
    if live is None:
        return
    if memory_budget_mb:
        live.budget.limit = max(memory_budget_mb << 20, 1)
    if concurrency_ and concurrency_ != live.concurrency:
        log.warning("transfer engine already running with concurrency "
                    "%d; --transfer-concurrency %d ignored for this "
                    "process", live.concurrency, concurrency_)
