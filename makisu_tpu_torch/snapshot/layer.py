"""Layer model: the set of changes one build step commits.

A layer maps logical paths to entries — file content (with its on-disk
source for tar streaming) or whiteouts (deletions). Committing writes
entries to a tar stream in sorted path order, which both makes layer bytes
deterministic and groups whiteouts with their siblings.

Copy of ``makisu_tpu/snapshot/layer.py`` with its pooled read-ahead and
its stage metrics (reference capability: lib/snapshot/mem_layer.go).
"""

from __future__ import annotations

import dataclasses
import os
import tarfile
import threading
import time

from makisu_tpu_torch import tario
from makisu_tpu_torch.snapshot.walk import WHITEOUT_PREFIX
from makisu_tpu_torch.utils import concurrency, metrics, pathutils


@dataclasses.dataclass
class ContentEntry:
    """A file/dir/symlink present in the layer; content streams from
    ``src`` on disk at commit time."""

    src: str
    dst: str  # logical absolute path; layer key
    hdr: tarfile.TarInfo

    def commit(self, tw: tarfile.TarFile,
               data: bytes | None = None) -> None:
        tario.write_entry(tw, self.src, self.hdr, data=data)


@dataclasses.dataclass
class WhiteoutEntry:
    """A deletion: commits as an empty ``.wh.<name>`` marker."""

    deleted: str  # logical absolute path being deleted; layer key

    def commit(self, tw: tarfile.TarFile,
               data: bytes | None = None) -> None:
        d, b = os.path.split(self.deleted)
        hdr = tarfile.TarInfo(
            pathutils.rel_path(os.path.join(d, WHITEOUT_PREFIX + b)))
        tw.addfile(hdr)


class _ReadAhead:
    """File read-ahead for a Python tar writer: upcoming ContentEntry
    bytes are read on the commit pool and handed to the (strictly
    ordered) writer, so the disk read happens ahead, off-thread.

    The native ``add_path`` writer gets none: its C++ reads follow the
    writer, and a second open and read of every file, only to warm the
    page cache, cost more than it saved where opens are slow (a 1 GiB
    commit of ~50k files took 26.5-27.4 s with it, 17.1-17.3 s without,
    on a host at ~0.3 ms an open).

    Prefetch results are advisory: any read error, or a file whose size
    changed since its header was recorded, yields ``None`` and the
    writer streams from disk, which surfaces errors through the same
    code path as the serial commit. In-flight bytes are budgeted so a
    layer of large files can't balloon memory.
    """

    MAX_FILE_BYTES = 8 * 1024 * 1024   # larger files stream as before
    BUDGET_BYTES = 64 * 1024 * 1024    # in-flight prefetch cap

    def __init__(self, items: list[tuple[str, "ContentEntry"]],
                 workers: int) -> None:
        self._queue = list(items)  # (key, entry), commit order
        self._queue.reverse()      # pop() from the front cheaply
        self._pool = concurrency.hash_pool()
        # Bounded by TASKS as well as bytes: a layer of 50k tiny files
        # must not enqueue 50k reads ahead of the other tasks of the
        # shared FIFO pool (the chunk index's probes, pgzip's lanes).
        self._max_tasks = max(4 * workers, 8)
        self._futs: dict[str, tuple] = {}  # key -> (future, size)
        self._inflight = 0
        self._lock = threading.Lock()
        self._busy = 0.0  # worker read seconds (flushed at close)
        self._top_up()

    def _top_up(self) -> None:
        while (self._queue and self._inflight < self.BUDGET_BYTES
               and len(self._futs) < self._max_tasks):
            key, entry = self._queue.pop()
            size = entry.hdr.size
            self._inflight += size
            self._futs[key] = (concurrency.submit_ctx(
                self._pool, self._read, entry.src, size), size)
        metrics.stage_queue_depth("read_ahead", len(self._futs))

    def _read(self, src: str, size: int) -> bytes | None:
        t0 = time.monotonic()
        try:
            with open(src, "rb") as f:
                data = f.read(size + 1)
        except OSError:
            return None  # the writer re-reads and surfaces the real error
        finally:
            with self._lock:
                self._busy += time.monotonic() - t0
        # A size change since the scan means the header no longer
        # matches the content; the streaming path owns that failure
        # mode (tarfile raises on short reads), so fall back to it.
        return data if len(data) == size else None

    def take(self, key: str) -> bytes | None:
        """Prefetched bytes for ``key``, else None. Tops the pipeline
        back up as the writer consumes entries."""
        fut, size = self._futs.pop(key, (None, 0))
        if fut is None:
            return None
        self._inflight -= size
        self._top_up()
        return fut.result()

    def close(self) -> None:
        # Cancel what never started: orphaned reads would otherwise
        # occupy pool slots ahead of the next layer's tasks (reads
        # already running finish on their own, harmlessly).
        for fut, _ in self._futs.values():
            fut.cancel()
        self._futs.clear()
        self._queue = []
        metrics.stage_busy_add("read_ahead", self._busy)
        metrics.stage_queue_depth("read_ahead", 0)


class Layer:
    """Ordered path → entry map for one committed layer."""

    def __init__(self) -> None:
        self.entries: dict[str, ContentEntry | WhiteoutEntry] = {}

    def __len__(self) -> int:
        return len(self.entries)

    def add_header(self, src: str, dst: str,
                   hdr: tarfile.TarInfo) -> ContentEntry | WhiteoutEntry:
        """Record a content entry (or a whiteout, if dst basename carries
        the whiteout prefix — as found in pulled layer tars)."""
        dst = pathutils.abs_path(dst)
        d, b = os.path.split(dst)
        if b.startswith(WHITEOUT_PREFIX):
            entry = WhiteoutEntry(os.path.join(d, b[len(WHITEOUT_PREFIX):]))
            self.entries[entry.deleted] = entry
        else:
            entry = ContentEntry(src, dst, hdr)
            self.entries[dst] = entry
        return entry

    def add_whiteout(self, deleted: str) -> WhiteoutEntry:
        deleted = pathutils.abs_path(deleted)
        if os.path.basename(deleted).startswith(WHITEOUT_PREFIX):
            raise ValueError(f"path already carries whiteout prefix: {deleted}")
        entry = WhiteoutEntry(deleted)
        self.entries[deleted] = entry
        return entry

    def commit(self, tw: tarfile.TarFile,
               workers: int | None = None) -> None:
        """Write entries in sorted path order (cache-identity-bearing).
        With ``workers > 1`` (default: ``concurrency.hash_workers()``)
        and a Python tar writer, file content prefetches ahead of the
        writer on the commit pool; the native writer streams each file
        in C++ (see ``_ReadAhead``). The tar bytes are the same either
        way."""
        keys = sorted(self.entries)
        if workers is None:
            workers = concurrency.hash_workers()
        ra = None
        if workers > 1 and getattr(tw, "add_path", None) is None:
            eligible = [
                (k, e) for k in keys
                if isinstance(e := self.entries[k], ContentEntry)
                and e.hdr.isreg()
                and 0 < e.hdr.size <= _ReadAhead.MAX_FILE_BYTES]
            if len(eligible) > 1:
                ra = _ReadAhead(eligible, workers=workers)
        try:
            for key in keys:
                data = ra.take(key) if ra is not None else None
                self.entries[key].commit(tw, data=data)
        finally:
            if ra is not None:
                ra.close()
