"""Thread-safe content-addressed store with LRU eviction.

Copy of ``makisu_tpu/storage/cas.py`` for the layer-blob store and the
chunk CAS, with the same on-disk layout (``root/<aa>/<name>``), so one
storage dir serves both builders. Reference capabilities:
lib/storage/layer_tar_store.go (CAS by hex digest, hardlink in/out, LRU
256).
"""

from __future__ import annotations

import heapq
import os
import shutil
import tempfile
import threading
import time
from typing import BinaryIO, Callable, Iterator

_SHARD_CHARS = 2


class CASStore:
    """Content-addressed files under ``root/<aa>/<name>``.

    Files land via ``write_file``/``write_bytes``/``link_file``, always
    committed with an atomic rename so readers never observe partial
    content. ``max_entries`` bounds the store; least-recently-used
    entries are evicted on overflow.
    """

    # Stores below this cap seed their LRU map eagerly at construction
    # (a few hundred stats); at or above it (the ~1M-entry chunk CAS)
    # seeding runs on a background thread armed by the first write, and
    # eviction defers until the scan lands (advisory LRU: a few deferred
    # evictions cost disk headroom, never correctness). That scan lists
    # names only, a listdir a shard: an entry it found has no recency
    # (None) until an eviction has to rank it and stats it then, so a
    # build that evicts nothing pays no stat per stored file.
    _EAGER_SEED_BELOW = 4096

    def __init__(self, root: str, max_entries: int = 256) -> None:
        self.root = root
        self.max_entries = max_entries
        self._lock = threading.Lock()
        # name -> last access (mtime at seeding), None where the
        # background seed found the name and no stat has read it yet.
        self._last_access: dict[str, float | None] = {}
        self._shards: set[str] = set()  # shard dirs known to exist
        # Bumped, under the lock, each time entries leave the store
        # (eviction, delete): a shard listing read before a bump may
        # name an entry that is gone.
        self._removals = 0
        # Optional pin predicate (name -> bool): a True answer keeps the
        # entry out of eviction (the chunk store's in-flight reads).
        self.pin_check: Callable[[str], bool] | None = None
        os.makedirs(root, exist_ok=True)
        self._tmp_dir = os.path.join(root, "_tmp")
        os.makedirs(self._tmp_dir, exist_ok=True)
        self._seeded = False
        self._seeding = False
        if max_entries < self._EAGER_SEED_BELOW:
            for name in self.keys():
                self._last_access[name] = \
                    os.path.getmtime(self._path(name))
            self._seeded = True

    def _seed_async_locked(self) -> None:
        """Arm the background LRU seed (large stores). Runs at most once;
        merges the stored names under the lock, with no recency yet
        (live accesses recorded meanwhile win), then catches up the
        deferred eviction."""
        if self._seeded or self._seeding:
            return
        self._seeding = True

        def run() -> None:
            names: list[str] = []
            try:
                names = self.keys()
            finally:
                with self._lock:
                    for name in names:
                        self._last_access.setdefault(name, None)
                    self._seeded = True
                    self._seeding = False
                    self._evict_locked()

        threading.Thread(target=run, daemon=True,
                         name="cas-lru-seed").start()

    def seed_state(self) -> dict:
        """The background LRU seed's state: ``seeded`` (recency map
        complete), ``seeding`` (scan in flight), or ``unseeded`` (large
        store, seed not armed yet: it arms on the first write).
        Consumers that rank objects by recency (the storage census's
        eviction dry run) refuse to run unless ``seeded``."""
        with self._lock:
            if self._seeded:
                state = "seeded"
            elif self._seeding:
                state = "seeding"
            else:
                state = "unseeded"
            return {"state": state,
                    "seeded_entries": len(self._last_access)}

    @staticmethod
    def shard(name: str) -> str:
        """The shard directory (under the root) that holds ``name``."""
        return name[:_SHARD_CHARS] if len(name) > _SHARD_CHARS else "__"

    def _path(self, name: str) -> str:
        return os.path.join(self.root, self.shard(name), name)

    def _touch(self, name: str) -> None:
        self._last_access[name] = time.time()

    # -- queries ----------------------------------------------------------

    def exists(self, name: str) -> bool:
        with self._lock:
            if os.path.isfile(self._path(name)):
                self._touch(name)
                return True
            return False

    def size(self, name: str) -> int:
        with self._lock:
            size = os.path.getsize(self._path(name))  # raises if absent
            self._touch(name)
            return size

    def list_shard(self, shard: str) -> set[str]:
        """The names stored in one shard directory: one ``listdir``,
        outside the lock (a name committed meanwhile may be missing). A
        shard not made yet holds none."""
        try:
            return set(os.listdir(os.path.join(self.root, shard)))
        except FileNotFoundError:
            return set()

    def removals(self) -> int:
        """How many times entries have left the store so far."""
        with self._lock:
            return self._removals

    def touch_listed(self, name: str, removals: int) -> bool:
        """Record an access to ``name``, which a shard listing read when
        ``removals()`` was ``removals`` holds (the chunk store's probes):
        False, recording nothing, where entries have left the store
        since, so the listing may be stale and the caller stats."""
        with self._lock:
            if self._removals != removals:
                return False
            self._touch(name)
            return True

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
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

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
        """Rename ``tmp`` into place (or drop it if the name is already
        stored). Shard directories are made once per store: a chunk CAS
        commits tens of thousands of files, each syscall counts."""
        dst = self._path(name)
        shard = os.path.dirname(dst)
        if shard not in self._shards:
            os.makedirs(shard, exist_ok=True)
            self._shards.add(shard)
        with self._lock:
            if os.path.isfile(dst):
                self._touch(name)  # first writer wins; content is identical
                os.unlink(tmp)
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

    def link_out(self, name: str, dst: str) -> None:
        """Hardlink a stored file out to ``dst`` (copy across filesystems)."""
        src = self.path(name)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if os.path.exists(dst):
            os.unlink(dst)
        try:
            os.link(src, dst)
        except OSError:
            shutil.copy2(src, dst)

    def delete(self, name: str) -> None:
        with self._lock:
            p = self._path(name)
            if os.path.isfile(p):
                os.unlink(p)
            self._last_access.pop(name, None)
            self._removals += 1

    # -- eviction ---------------------------------------------------------

    def _evict_locked(self) -> None:
        """Evict the LRU overflow, never a pinned entry. Large stores
        (the chunk CAS) evict in 10% batches: a scan per insert is O(n),
        and at a few hundred thousand entries the store would spend its
        time scanning access times. Small stores (the layer-blob cache of
        warm multi-hundred-MB blobs) evict exactly the excess."""
        if not self._seeded:
            # LRU state still loading (large store): defer; the seed's
            # completion re-runs this.
            self._seed_async_locked()
            return
        if len(self._last_access) <= self.max_entries:
            return
        self._read_seeded_mtimes_locked()
        pool = self._last_access
        if self.pin_check is not None:
            pool = {name: ts for name, ts in pool.items()
                    if not self.pin_check(name)}
        excess = len(self._last_access) - self.max_entries
        batch = excess if self.max_entries < self._EAGER_SEED_BELOW \
            else max(excess, self.max_entries // 10)
        batch = min(batch, len(pool))
        for victim in heapq.nsmallest(batch, pool, key=pool.get):
            p = self._path(victim)
            if os.path.isfile(p):
                os.unlink(p)
            del self._last_access[victim]
        self._removals += 1

    def _read_seeded_mtimes_locked(self) -> None:
        """Stat the entries the background seed left without recency:
        their mtime, as the eager seed reads it; an entry gone from disk
        leaves the map."""
        for name in [n for n, ts in self._last_access.items() if ts is None]:
            try:
                self._last_access[name] = os.path.getmtime(self._path(name))
            except OSError:
                del self._last_access[name]  # racing delete

    def recency(self) -> dict[str, float]:
        """Last access per entry this store has read or touched; an
        entry the background seed only listed is left out (its mtime on
        disk is its recency)."""
        with self._lock:
            return {name: ts for name, ts in self._last_access.items()
                    if ts is not None}

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())
