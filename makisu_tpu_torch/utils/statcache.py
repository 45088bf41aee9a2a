"""Stat-keyed content-ID cache: skip re-hashing unchanged context files.

COPY/ADD cache identity covers the bytes being copied, so every build
hashes its context. This cache remembers each file's content crc32
keyed by its stat ``(size, mtime_ns, ctime_ns, inode, device)``; a warm
build re-reads only files whose stat changed. The keying is the git
index discipline: mtime and size alone can be spoofed by an editor that
restores timestamps, but a content write always moves ctime (utime
cannot restore it). ``MAKISU_TPU_STAT_CACHE=0`` disables the shortcut
(every file is read); either way the cache ID format is the same, so
toggling it never invalidates caches.

Racy-stat discipline (git's "racily clean" rule): a same-size edit in
the same timestamp tick as the hash would alias the stat key on file
systems with coarse timestamps, so an entry is trusted only when the
file's timestamps predate the recorded hash time by more than the
coarsest plausible granularity (2 s, covering 1 s file systems;
``MAKISU_TPU_STAT_CACHE_WINDOW_NS`` overrides it). Files touched within
that window of being hashed re-hash next build: a bounded cost, never a
stale identity.

Copy of ``makisu_tpu/utils/statcache.py`` with the resident-session
surfaces (``defer_save``, ``drain_mutations``, ``merge_entries``,
``namespace_items``, ``begin_build``) and one addition, ``flush``: a
resident process calls it before it exits, so a deferred or coalesced
save is not lost with the process. The file format is the same, so a
storage written by either package serves the other.
"""

from __future__ import annotations

import json
import os
import threading
import time

VERSION = 2
# A cached entry is trusted only if the file's mtime/ctime are at least
# this much older than the moment it was hashed.
RACY_WINDOW_NS = 2_000_000_000
# Entries the saving build did not touch are kept up to this many
# (other contexts share a storage dir); beyond it only touched ones are.
MAX_CARRIED_ENTRIES = 1_000_000


def enabled() -> bool:
    return os.environ.get("MAKISU_TPU_STAT_CACHE", "1") == "1"


def racy_window_ns() -> int:
    """``MAKISU_TPU_STAT_CACHE_WINDOW_NS`` overrides the racily-clean
    window (tests; operators on known fine-grained file systems)."""
    try:
        return int(os.environ.get("MAKISU_TPU_STAT_CACHE_WINDOW_NS",
                                  str(RACY_WINDOW_NS)))
    except ValueError:
        return RACY_WINDOW_NS


class ContentIDCache:
    """Per-storage-dir persistent map: rel path -> (stat key, crc32,
    hashed-at ns)."""

    def __init__(self, path: str, namespace: str = "") -> None:
        self.path = path
        # Entries are scoped by the build context dir (git scopes its
        # index per worktree the same way): contexts sharing one storage
        # dir have colliding rel paths.
        self._ns = namespace + "\x00"
        self._lock = threading.Lock()
        self._entries: dict[str, list] | None = None  # lazy load
        self._touched: set[str] = set()
        self._dirty = False
        # Resident sessions turn this on: save() then runs on a
        # background thread (the disk copy is durability only in a
        # resident process; the live dict is the source of truth).
        self.defer_save = False
        self._saver: threading.Thread | None = None
        # Keys written since the last drain_mutations(): the session
        # snapshot's dirty-shard signal (worker/snapshots.py), so an idle
        # checkpoint does not re-serialize every clean entry.
        self._mutated: set[str] = set()

    def _load_locked(self) -> dict[str, list]:
        if self._entries is None:
            self._entries = {}
            try:
                with open(self.path, encoding="utf-8") as f:
                    rec = json.load(f)
                # Shape-check everything: the file is shared state a
                # foreign tool or partial write can mangle, and an
                # advisory cache must start empty on any mismatch.
                if isinstance(rec, dict) and rec.get("version") == VERSION:
                    entries = rec.get("entries", {})
                    if isinstance(entries, dict):
                        self._entries = {
                            k: v for k, v in entries.items()
                            if isinstance(k, str)
                            and isinstance(v, list) and len(v) == 3
                            and isinstance(v[0], list)}
            except (OSError, ValueError):
                pass  # the cache is advisory; start empty
        return self._entries

    @staticmethod
    def _key(st: os.stat_result) -> list:
        # st_dev: rel paths repeat across bind mounts and file systems
        # where inode numbers restart.
        return [st.st_size, st.st_mtime_ns, st.st_ctime_ns, st.st_ino,
                st.st_dev]

    def get(self, rel: str, st: os.stat_result) -> int | None:
        return self.lookup(rel, st)[0]

    def lookup(self, rel: str,
               st: os.stat_result) -> tuple[int | None, str]:
        """``(crc, "hit")`` on a trusted entry, else ``(None, reason)``
        with reason ``disabled``, ``absent`` (first sight of this path),
        ``stat_changed`` (the file's stat moved: a real change) or
        ``racy`` (the entry is too fresh to trust)."""
        if not enabled():
            return None, "disabled"
        with self._lock:
            entry = self._load_locked().get(self._ns + rel)
            if entry is None:
                return None, "absent"
            if entry[0] != self._key(st):
                return None, "stat_changed"
            hashed_at = int(entry[2])
            newest = max(st.st_mtime_ns, st.st_ctime_ns)
            if hashed_at - newest < racy_window_ns():
                return None, "racy"
            self._touched.add(self._ns + rel)
            return int(entry[1]), "hit"

    def put(self, rel: str, st: os.stat_result, crc: int) -> None:
        with self._lock:
            self._load_locked()[self._ns + rel] = [
                self._key(st), int(crc), time.time_ns()]
            self._touched.add(self._ns + rel)
            self._mutated.add(self._ns + rel)
            self._dirty = True

    # -- session-snapshot surfaces (worker/snapshots.py) --

    def namespace_items(self) -> dict[str, list]:
        """A copy of this namespace's entries keyed by rel path (the
        namespace prefix, the context dir, is in the snapshot recipe)."""
        with self._lock:
            entries = self._load_locked()
            n = len(self._ns)
            return {k[n:]: list(v) for k, v in entries.items()
                    if k.startswith(self._ns)}

    def drain_mutations(self) -> set[str]:
        """Rel paths of this namespace written since the last drain
        (keys of other namespaces are dropped)."""
        with self._lock:
            mutated = self._mutated
            self._mutated = set()
            n = len(self._ns)
            return {k[n:] for k in mutated if k.startswith(self._ns)}

    def merge_entries(self, entries: dict[str, list]) -> int:
        """Adopt restored snapshot entries (rel path -> entry) that do not
        collide with local knowledge. They keep their ``hashed_at``, so
        the racily-clean guard and the per-lookup stat comparison apply
        unchanged: a restored entry whose file moved reads
        ``stat_changed`` and re-hashes. Returns the count adopted."""
        if not isinstance(entries, dict):
            return 0
        adopted = 0
        with self._lock:
            live = self._load_locked()
            for rel, entry in entries.items():
                if not (isinstance(rel, str) and isinstance(entry, list)
                        and len(entry) == 3
                        and isinstance(entry[0], list)):
                    continue
                key = self._ns + rel
                if key in live:
                    continue  # local knowledge is newer by definition
                live[key] = list(entry)
                adopted += 1
            if adopted:
                self._dirty = True
        return adopted

    def begin_build(self) -> None:
        """Reset the per-build touched set: a resident session reuses one
        instance across builds, and pruning must act as on a fresh cache
        every build."""
        with self._lock:
            self._touched.clear()

    def save(self) -> None:
        """Atomic write-back (``fileio.write_json_atomic``): a kill
        mid-save leaves the previous complete cache or the new one,
        never a truncation. Advisory: an I/O failure costs re-hashing
        next build, never correctness. The entries serialize from a copy
        outside the lock; with ``defer_save`` the write runs on a
        background thread, one at a time: a save that finds one in
        flight only marks the cache dirty again, and the next save (or
        ``flush``) writes its news."""
        with self._lock:
            if not self._dirty or self._entries is None:
                return
            entries = self._entries
            if len(entries) > MAX_CARRIED_ENTRIES:
                entries = {k: v for k, v in entries.items()
                           if k in self._touched}
            snapshot = dict(entries)
            self._dirty = False
            if self.defer_save:
                if self._saver is not None and self._saver.is_alive():
                    self._dirty = True
                    return
                self._saver = threading.Thread(
                    target=self._write, args=(snapshot,), daemon=True,
                    name="statcache-save")
                self._saver.start()
                return
        self._write(snapshot)

    def flush(self) -> None:
        """Wait for a background save, then write what it did not carry
        (a coalesced save's news) in the caller's thread."""
        saver = self._saver
        if saver is not None:
            saver.join()
        with self._lock:
            defer, self.defer_save = self.defer_save, False
        try:
            self.save()
        finally:
            self.defer_save = defer

    def _write(self, entries: dict) -> None:
        from makisu_tpu_torch.utils import fileio
        try:
            fileio.write_json_atomic(
                self.path, {"version": VERSION, "entries": entries})
        except OSError:
            with self._lock:
                self._dirty = True  # retry on the next save
