"""Thread-safe content-addressed store with LRU eviction.

Copy of ``makisu_tpu/storage/cas.py`` for the layer-blob store, with the
same on-disk layout (``root/<aa>/<name>``), so one storage dir serves
both builders. The chunk store's background LRU seeding and pin hooks
are not part of the port (chunk dedup is not wired yet). Reference
capabilities: lib/storage/layer_tar_store.go (CAS by hex digest,
hardlink in/out, LRU 256).
"""

from __future__ import annotations

import heapq
import os
import shutil
import tempfile
import threading
import time
from typing import BinaryIO, Callable

_SHARD_CHARS = 2


class CASStore:
    """Content-addressed files under ``root/<aa>/<name>``.

    Files land via ``write_file``/``write_bytes``/``link_file``, always
    committed with an atomic rename so readers never observe partial
    content. ``max_entries`` bounds the store; least-recently-used
    entries are evicted on overflow.
    """

    def __init__(self, root: str, max_entries: int = 256) -> None:
        self.root = root
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._last_access: dict[str, float] = {}
        os.makedirs(root, exist_ok=True)
        self._tmp_dir = os.path.join(root, "_tmp")
        os.makedirs(self._tmp_dir, exist_ok=True)
        for name in self.keys():
            self._last_access[name] = os.path.getmtime(self._path(name))

    def _path(self, name: str) -> str:
        shard = name[:_SHARD_CHARS] if len(name) > _SHARD_CHARS else "__"
        return os.path.join(self.root, shard, name)

    def _touch(self, name: str) -> None:
        self._last_access[name] = time.time()

    # -- queries ----------------------------------------------------------

    def exists(self, name: str) -> bool:
        with self._lock:
            if os.path.isfile(self._path(name)):
                self._touch(name)
                return True
            return False

    def keys(self) -> list[str]:
        out = []
        for shard in os.listdir(self.root):
            sharddir = os.path.join(self.root, shard)
            if shard == "_tmp" or not os.path.isdir(sharddir):
                continue
            out.extend(os.listdir(sharddir))
        return out

    # -- ingest -----------------------------------------------------------

    def write_file(self, name: str, write: Callable[[BinaryIO], None]) -> str:
        """Stream content into the store via ``write(fileobj)``; atomic."""
        fd, tmp = tempfile.mkstemp(dir=self._tmp_dir)
        try:
            with os.fdopen(fd, "wb") as f:
                write(f)
            return self._commit(name, tmp)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def write_bytes(self, name: str, data: bytes) -> str:
        return self.write_file(name, lambda f: f.write(data))

    def link_file(self, name: str, src: str) -> str:
        """Ingest an existing file by hardlink (falls back to copy across
        filesystems)."""
        # A private subdir keeps the link target unique: os.link refuses
        # to overwrite.
        tmp_parent = tempfile.mkdtemp(dir=self._tmp_dir)
        tmp = os.path.join(tmp_parent, "link")
        try:
            try:
                os.link(src, tmp)
            except OSError:
                shutil.copy2(src, tmp)
            return self._commit(name, tmp)
        finally:
            shutil.rmtree(tmp_parent, ignore_errors=True)

    def _commit(self, name: str, tmp: str) -> str:
        dst = self._path(name)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with self._lock:
            if os.path.isfile(dst):
                self._touch(name)  # first writer wins; content is identical
                return dst
            os.rename(tmp, dst)
            self._touch(name)
            self._evict_locked()
        return dst

    # -- egress -----------------------------------------------------------

    def path(self, name: str) -> str:
        """Path of a stored file (raises FileNotFoundError if absent)."""
        p = self._path(name)
        with self._lock:
            if not os.path.isfile(p):
                raise FileNotFoundError(f"{name} not in store {self.root}")
            self._touch(name)
        return p

    def open(self, name: str) -> BinaryIO:
        try:
            f = open(self._path(name), "rb")
        except FileNotFoundError:
            raise FileNotFoundError(
                f"{name} not in store {self.root}") from None
        with self._lock:
            self._touch(name)
        return f

    # -- eviction ---------------------------------------------------------

    def _evict_locked(self) -> None:
        excess = len(self._last_access) - self.max_entries
        if excess <= 0:
            return
        pool = self._last_access
        for victim in heapq.nsmallest(excess, pool, key=pool.get):
            p = self._path(victim)
            if os.path.isfile(p):
                os.unlink(p)
            del self._last_access[victim]
