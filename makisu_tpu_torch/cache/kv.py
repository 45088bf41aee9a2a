"""Key-value stores backing the layer cache.

Copy of ``makisu_tpu/cache/kv.py``'s in-memory and file stores, with the
same file format (``<storage>/cache_key_value.json``), so a storage dir
is shared with makisu_tpu builds. The Redis and HTTP stores are not part
of the port yet. Reference: lib/cache/keyvalue/ (fsStore with TTL
eviction + atomic writes fs_store.go:44-121). All stores map cache-ID
strings to entry strings.
"""

from __future__ import annotations

import json
import os
import threading
import time

from makisu_tpu_torch.utils import fileio


class MemoryStore:
    """In-memory store (tests and single-process builds)."""

    def __init__(self) -> None:
        self._data: dict[str, str] = {}
        self._lock = threading.Lock()

    def get(self, key: str) -> str | None:
        with self._lock:
            return self._data.get(key)

    def put(self, key: str, value: str) -> None:
        with self._lock:
            self._data[key] = value


class FSStore:
    """Single-JSON-file store with TTL eviction on load and atomic
    tmp+rename persistence (reference: fs_store.go)."""

    def __init__(self, path: str, ttl_seconds: float = 336 * 3600) -> None:
        self.path = path
        self.ttl = ttl_seconds
        self._lock = threading.Lock()
        self._data: dict[str, tuple[str, float]] = {}
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return
        now = time.time()
        for key, (value, ts) in raw.items():
            if now - ts < self.ttl:
                self._data[key] = (value, ts)

    def _persist_locked(self) -> None:
        # Atomic + fsynced (unique temp, rename): a SIGTERM mid-save
        # must not truncate the whole KV file — every cached entry of
        # every build sharing this storage dir dies with it. The old
        # fixed ".tmp" name also cross-clobbered under concurrent
        # writers; write_json_atomic's pid+tid temp name cannot.
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fileio.write_json_atomic(self.path, self._data)

    def get(self, key: str) -> str | None:
        with self._lock:
            hit = self._data.get(key)
            if hit is None:
                return None
            value, ts = hit
            if time.time() - ts >= self.ttl:
                del self._data[key]
                return None
            return value

    def put(self, key: str, value: str) -> None:
        with self._lock:
            # Merge-on-write: another process (worker + CLI sharing a
            # storage dir) may have persisted entries since our load;
            # last-writer-wins per KEY instead of per file.
            current = dict(self._data)
            self._data = {}
            self._load()
            self._data.update(current)
            self._data[key] = (value, time.time())
            self._persist_locked()
