"""Resident build sessions: keep a context's warm state alive across the
builds of one process, so a warm rebuild is warm.

Copy of ``makisu_tpu/worker/session.py``, its session counters and
ledger records included. A **build session**, keyed by the context
path and the resolved flag identity, keeps resident per context:

- the stat cache (``utils/statcache.ContentIDCache``): no reload of its
  JSON per build;
- the context-scan memo: per ADD/COPY source subtree, the cache-ID
  checksum transition ``(source, checksum_in) -> checksum_out``, so an
  untouched subtree's part replays with no syscall;
- the MemFS layer-replay memo: the applied-entry stream of every cached
  layer keyed by (applied chain, blob digest), so a cached layer folds
  into the tree without opening, inflating or parsing its blob (or its
  chunks);
- the dirty-set tracker: an inotify watcher (ctypes, Linux) with the
  mtime-walk delta (``snapshot.walk.snapshot_delta``) as its fallback,
  gathering the paths that changed between builds.

The kernels stay loaded for free (one process); the session records the
kernel route it was made under (``_isa_identity``), so a route change
invalidates it rather than mixing routes.

Invalidation reasons (counted in ``SessionManager.invalidations``):
``flag_identity`` (same context, other resolved flags), ``isa_change``
(the kernel route moved under the process), ``ttl`` (idle beyond
``MAKISU_TPU_SESSION_TTL`` seconds), ``lru`` / ``lru_restore`` (past
``MAKISU_TPU_SESSION_MAX`` sessions or the ``MAKISU_TPU_SESSION_MAX_MB``
resident-byte budget), ``explicit`` (``invalidate``).

Correctness contract: a session only replays state that is a function of
inputs that provably did not change (stat signatures under the
racily-clean discipline, digest-keyed layer entries), so image digests
equal a cold build's at every point.
"""

from __future__ import annotations

import contextvars
import ctypes
import ctypes.util
import hashlib
import importlib
import json
import os
import struct
import threading
import time

from makisu_tpu_torch.utils import ledger, metrics
from makisu_tpu_torch.utils import logging as log

# The snapshot package exports the walk function under the module's own
# name; resolve the module explicitly.
walk_mod = importlib.import_module("makisu_tpu_torch.snapshot.walk")

# Rough per-unit resident-byte estimates for the byte budget: a safety
# cap, not a ledger, so stable estimates beat precise churn.
_BYTES_PER_LAYER_ENTRY = 600   # TarInfo + path strings
_BYTES_PER_CONTENT_ID = 200    # stat-cache entry
_BYTES_PER_MEMO = 160          # scan-memo key and value

# Scan-memo entries kept per session: keys are (source, checksum_in);
# upstream cache-ID churn mints new keys, so stale ones age out by cap.
_SCAN_MEMO_KEEP = 512


def enabled() -> bool:
    """Resident sessions are on by default (a session never reused costs
    one dict entry); MAKISU_TPU_SESSION=0 turns them off."""
    return os.environ.get("MAKISU_TPU_SESSION", "1") == "1"


def session_ttl() -> float:
    try:
        return float(os.environ.get("MAKISU_TPU_SESSION_TTL", "3600"))
    except ValueError:
        return 3600.0


def max_sessions() -> int:
    try:
        return int(os.environ.get("MAKISU_TPU_SESSION_MAX", "8"))
    except ValueError:
        return 8


def max_resident_bytes() -> int:
    try:
        mb = float(os.environ.get("MAKISU_TPU_SESSION_MAX_MB", "512"))
    except ValueError:
        mb = 512.0
    return int(mb * 1e6)


def max_watches() -> int:
    try:
        return int(os.environ.get("MAKISU_TPU_SESSION_MAX_WATCHES",
                                  "8192"))
    except ValueError:
        return 8192


# This build's residency: "resident" (session reused with an exact dirty
# set), "fresh" (a new session: the first build of this context and
# identity), "rescan" (reused, but the dirty knowledge was lost: a full
# scan), "restored" (the first build after a snapshot restore), "off"
# (sessions disabled or bypassed), "none" (not a build).
_warm_mode: "contextvars.ContextVar[str]" = contextvars.ContextVar(
    "makisu_torch_session_warm_mode", default="none")


def warm_mode() -> str:
    return _warm_mode.get()


def set_warm_mode(label: str) -> None:
    _warm_mode.set(label)


def _isa_identity() -> str:
    """The kernel route a session is made under: only what the process
    has already resolved (``ops.backend.kernel_route``, set when the gpu
    hasher resolves the card), so a session never forces a build or load
    of a library. "unresolved" before that, and always for ``--hasher
    cpu``."""
    from makisu_tpu_torch.ops import backend
    return backend.kernel_route() or "unresolved"


def _identity_dict(args, gzip_backend_id: str) -> dict:
    return {
        "context": os.path.abspath(args.context),
        "root": os.path.abspath(args.root),
        "dockerfile": os.path.abspath(
            args.file or os.path.join(args.context, "Dockerfile")),
        "hasher": args.hasher,
        "gzip_backend_id": gzip_backend_id,
        "modifyfs": bool(args.modifyfs),
        "commit": args.commit,
        "target": args.target,
        "build_args": sorted(args.build_arg),
        "blacklist": sorted(args.blacklist),
    }


def _digest_identity(ident: dict) -> str:
    blob = json.dumps(ident, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def identity_from_build_args(args, storage_dir: str,
                             gzip_backend_id: str) -> str:
    """Digest of the resolved flags that shape a build of one context.
    Anything here that moves mints a new session (flag_identity): mixing
    two hashers' warm state would be silently wrong."""
    ident = _identity_dict(args, gzip_backend_id)
    ident["storage"] = os.path.abspath(storage_dir)
    return _digest_identity(ident)


def portable_identity_from_build_args(args,
                                      gzip_backend_id: str) -> str:
    """The flag identity without the storage dir: session snapshots key
    and validate on it (everything that shapes the build's output is in
    it; where chunks live is not)."""
    return _digest_identity(_identity_dict(args, gzip_backend_id))


def snapshot_policy() -> str:
    """MAKISU_TPU_SESSION_SNAPSHOT: "1" checkpoints every successful
    build, "0" turns the snapshot plane off, "auto" (the default)
    checkpoints only sessions with a residency hint (``--watch``, repeat
    builds in one process): a one-shot build skips a serialization it
    could never redeem."""
    return os.environ.get("MAKISU_TPU_SESSION_SNAPSHOT", "auto")


# -- inotify watcher --------------------------------------------------------

_IN_MODIFY = 0x00000002
_IN_ATTRIB = 0x00000004
_IN_CLOSE_WRITE = 0x00000008
_IN_MOVED_FROM = 0x00000040
_IN_MOVED_TO = 0x00000080
_IN_CREATE = 0x00000100
_IN_DELETE = 0x00000200
_IN_DELETE_SELF = 0x00000400
_IN_MOVE_SELF = 0x00000800
_IN_ISDIR = 0x40000000
_IN_Q_OVERFLOW = 0x00004000
_IN_IGNORED = 0x00008000
_IN_NONBLOCK = 0x00000800  # O_NONBLOCK on linux
_IN_CLOEXEC = 0x00080000   # O_CLOEXEC on linux

_WATCH_MASK = (_IN_MODIFY | _IN_ATTRIB | _IN_CLOSE_WRITE
               | _IN_MOVED_FROM | _IN_MOVED_TO | _IN_CREATE
               | _IN_DELETE | _IN_DELETE_SELF | _IN_MOVE_SELF)

_EVENT_HDR = struct.Struct("iIII")  # wd, mask, cookie, len


def _libc():
    name = ctypes.util.find_library("c")
    if not name:
        return None
    libc = ctypes.CDLL(name, use_errno=True)
    if hasattr(libc, "inotify_init1"):
        c_int = ctypes.c_int
        for fn, args in ((libc.inotify_init1, [c_int]),
                         (libc.inotify_add_watch,
                          [c_int, ctypes.c_char_p, ctypes.c_uint32]),
                         (libc.inotify_rm_watch, [c_int, c_int])):
            fn.argtypes = args
            fn.restype = c_int
    return libc


class InotifyWatcher:
    """Recursive inotify watch over a context tree. Best effort by
    design: any failure (no inotify, the watch limit's ENOSPC, a queue
    overflow, structural events that stale the wd-to-path map) turns
    ``healthy`` off and the session falls back to the mtime-walk delta.
    ``collect()`` drains pending events into a dirty-path set;
    ``resync()`` (after a build) registers watches again, so directories
    made between builds are covered from then on."""

    def __init__(self, root: str, blacklist: list[str]) -> None:
        self.root = root
        self.blacklist = list(blacklist)
        self.healthy = False
        self._fd = -1
        self._wd_paths: dict[int, str] = {}
        self._needs_resync = False
        self._libc = _libc()
        if self._libc is None or not hasattr(self._libc,
                                             "inotify_init1"):
            return
        fd = self._libc.inotify_init1(_IN_NONBLOCK | _IN_CLOEXEC)
        if fd < 0:
            return
        self._fd = fd
        self.healthy = self._add_watches()
        if not self.healthy:
            self.close()

    def _dirs(self) -> list[str]:
        """The directories to watch, by a stat-free scandir descent
        (dirent type bits only)."""
        from makisu_tpu_torch.utils import pathutils
        dirs = [self.root]
        stack = [self.root]
        limit = max_watches()
        try:
            while stack:
                cur = stack.pop()
                with os.scandir(cur) as it:
                    for entry in it:
                        if not entry.is_dir(follow_symlinks=False):
                            continue
                        if pathutils.is_descendant_of_any(
                                entry.path, self.blacklist):
                            continue
                        dirs.append(entry.path)
                        if len(dirs) > limit:
                            return dirs  # the caller sees > cap and bails
                        stack.append(entry.path)
        except OSError:
            return []
        return dirs

    def _add_watches(self) -> bool:
        dirs = self._dirs()
        if not dirs or len(dirs) > max_watches():
            return False
        for path in dirs:
            wd = self._libc.inotify_add_watch(
                self._fd, os.fsencode(path), _WATCH_MASK)
            if wd < 0:
                return False  # ENOSPC or a vanished dir: fall back whole
            self._wd_paths[wd] = path
        return True

    def collect(self) -> set[str] | None:
        """Drain events into dirty paths. None means knowledge was lost
        (overflow, read error): the caller must fall back to a full
        scan."""
        if not self.healthy:
            return None
        dirty: set[str] = set()
        structural = False
        while True:
            try:
                buf = os.read(self._fd, 65536)
            except BlockingIOError:
                break
            except OSError:
                self.healthy = False
                return None
            if not buf:
                break
            off = 0
            while off + _EVENT_HDR.size <= len(buf):
                wd, mask, _cookie, nlen = _EVENT_HDR.unpack_from(buf, off)
                name = buf[off + _EVENT_HDR.size:
                           off + _EVENT_HDR.size + nlen].rstrip(b"\0")
                off += _EVENT_HDR.size + nlen
                if mask & _IN_Q_OVERFLOW:
                    self.healthy = False
                    return None
                base = self._wd_paths.get(wd)
                if mask & _IN_IGNORED:
                    self._wd_paths.pop(wd, None)
                    structural = True
                    continue
                if base is None:
                    continue
                path = (os.path.join(base, name.decode(
                    errors="surrogateescape")) if name else base)
                dirty.add(path)
                if mask & (_IN_ISDIR | _IN_DELETE_SELF | _IN_MOVE_SELF):
                    # A directory appeared, vanished or moved: events of
                    # its subtree are unreliable until the watches
                    # register again (resync after the build). The dir
                    # itself is dirty, which makes its source walk again.
                    structural = True
        if structural:
            self._needs_resync = True
        return dirty

    def resync(self) -> None:
        """Register the watches again after structural churn. A no-op on
        the steady path: without a structural event no new directory can
        exist, so a stable tree pays nothing per build."""
        if not self.healthy or not self._needs_resync:
            return
        for wd in list(self._wd_paths):
            self._libc.inotify_rm_watch(self._fd, wd)
        self._wd_paths.clear()
        self._needs_resync = False
        self.healthy = self._add_watches()

    def close(self) -> None:
        if self._fd >= 0:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = -1
        self.healthy = False


# -- the session ------------------------------------------------------------


class BuildSession:
    """One context's resident warm state. Single writer: the manager
    hands a session to one build at a time (a concurrent build of the
    same context bypasses it as "busy")."""

    def __init__(self, context_dir: str, identity: str) -> None:
        self.context_dir = context_dir
        self.identity = identity
        self.isa = _isa_identity()
        self.created_mono = time.monotonic()
        self.last_used_mono = self.created_mono
        self.builds = 0
        self.hits = 0
        self.busy = False
        # Resident state.
        self.content_ids = None  # adopted from the first BuildContext
        self.scan_memo: dict[tuple[str, int],
                             tuple[int, int, int]] = {}
        # Applied-layer op streams keyed by (applied chain, digest),
        # valid only at the chain position they were recorded at
        # (builder/node.py holds the argument).
        self.layer_replay: dict[tuple[str, str], list] = {}
        self._layer_entry_count = 0
        self.snapshot: walk_mod.TreeSnapshot | None = None
        self.watcher: InotifyWatcher | None = None
        self.pending_dirty: set[str] = set()
        # True iff the dirty set provably covers every change since the
        # last successful build; False forces a full scan.
        self.exact = False
        self._ignore_sig = None  # .dockerignore content hash
        self._walk_blacklist: list[str] = []
        # Whether expensive tracking (the full-walk baseline) pays off:
        # set per build from resident_process or repeat use.
        self._resident_hint = False
        # -- session-snapshot plane (worker/snapshots.py) --
        # The portable flag identity and the storage dir arrive with the
        # lease; without them the snapshot plane stays off.
        self.portable_identity: str | None = None
        self.storage_dir: str | None = None
        # True for the first build after a snapshot restore (warm mode
        # "restored"). The companion flag lives until the first
        # release(), where a byte-budget eviction the restore caused
        # counts as lru_restore.
        self.restored = False
        self._restore_fresh = False
        # Restored stat-cache entries, merged into the context's cache at
        # the next begin_build (the cache exists only once a build does).
        self._restored_stat_entries: dict | None = None
        # A restored walk baseline certifies a past point: the next poll
        # must delta against it once before the watcher is believed.
        self._gap_delta_pending = False
        # Incremental-write bookkeeping: the previous checkpoint's shard
        # chunks (carried forward), dirty flags per shard family, and the
        # watcher mode's persistence baseline.
        self._snap_shards: dict[str, dict] = {}
        self._snap_scan_dirty = True
        self._snap_stat_all = True
        self._snap_walk_dirty: set[str] = set()
        self._snap_walk_all = True
        self._snap_baseline: walk_mod.TreeSnapshot | None = None
        self._snap_gap_paths = 0

    # -- accounting --

    def resident_bytes(self) -> int:
        n = self._layer_entry_count * _BYTES_PER_LAYER_ENTRY
        n += len(self.scan_memo) * _BYTES_PER_MEMO
        if self.content_ids is not None:
            n += (len(getattr(self.content_ids, "_entries", None) or ())
                  * _BYTES_PER_CONTENT_ID)
        if self.snapshot is not None:
            n += self.snapshot.approx_bytes()
        return n

    def stats(self) -> dict:
        now = time.monotonic()
        return {
            "context": self.context_dir,
            "identity": self.identity,
            "isa": self.isa,
            "builds": self.builds,
            "hits": self.hits,
            "resident_bytes": self.resident_bytes(),
            "layers_cached": len(self.layer_replay),
            "scan_memo_entries": len(self.scan_memo),
            "dirty_pending": len(self.pending_dirty),
            "dirty_exact": self.exact,
            "watcher": self.watcher_kind(),
            "age_seconds": round(now - self.created_mono, 3),
            "idle_seconds": round(now - self.last_used_mono, 3),
            "busy": self.busy,
        }

    def watcher_kind(self) -> str:
        return ("inotify" if self.watcher is not None
                and self.watcher.healthy else "mtime-walk")

    # -- dirty tracking --

    def _ignore_signature(self):
        path = os.path.join(self.context_dir, ".dockerignore")
        try:
            with open(path, "rb") as f:
                return hashlib.sha256(f.read()).hexdigest()
        except OSError:
            return None

    def _lose_knowledge(self) -> set[str]:
        """A failed walk: the session turns inexact and flags the whole
        context dirty once."""
        self.snapshot = None
        self.exact = False
        self.pending_dirty.add(self.context_dir)
        self._snap_walk_all = True
        return {self.context_dir}

    def poll_changes(self) -> set[str]:
        """Gather the changes since the last poll or build into
        ``pending_dirty`` and return the signature-confirmed new dirt of
        this poll (what a watch loop rebuilds on): watcher events when
        healthy, one mtime-walk delta otherwise.

        Knowledge loss (the watcher's overflow or death, a failed delta
        walk, no baseline at all) never goes silent: the session turns
        inexact, the whole context is flagged dirty once (the next build
        scans everything and a watch loop rebuilds), and a fresh walk
        baseline is seeded so tracking resumes."""
        gap_dirty: set[str] = set()
        if self._gap_delta_pending and self.snapshot is not None:
            # Restored session: the persisted baseline certifies the
            # state at snapshot time; one delta against it surfaces what
            # moved in the snapshot-to-restore gap, at the trust level of
            # the mtime-walk fallback. Only after it may a (new,
            # gap-blind) watcher be believed.
            self._gap_delta_pending = False
            try:
                self.snapshot, delta = walk_mod.snapshot_delta(
                    self.snapshot, self._walk_blacklist)
            except OSError:
                return self._lose_knowledge()
            gap_dirty = delta.dirty
            self.pending_dirty |= gap_dirty
            self._snap_walk_dirty |= gap_dirty
        if self.watcher is not None and self.watcher.healthy:
            got = self.watcher.collect()
            if got is not None:
                self.pending_dirty |= got
                self._snap_gap_paths += len(got)
                # New dirs appeared? Register their watches before the
                # caller scans, so edits inside them during the build are
                # evented (a no-op without structural churn).
                self.watcher.resync()
                if self.watcher.healthy:
                    return got | gap_dirty
            # Overflow, read error or failed resync: the watcher is dead.
            # Release its fd and kernel watches, then re-seed the walk
            # baseline below.
            self.watcher.close()
        if self.snapshot is not None:
            try:
                self.snapshot, delta = walk_mod.snapshot_delta(
                    self.snapshot, self._walk_blacklist)
            except OSError:
                return self._lose_knowledge()
            self.pending_dirty |= delta.dirty
            self._snap_walk_dirty |= delta.dirty
            return delta.real_dirty | gap_dirty
        # No baseline: what changed since the last certified point is
        # unknowable. Flag everything once and take a baseline, but only
        # where residency can pay the full stat walk back (a resident
        # process, or an in-process repeat build).
        self.exact = False
        self.pending_dirty.add(self.context_dir)
        if self._resident_hint:
            try:
                self.snapshot = walk_mod.snapshot_tree(
                    self.context_dir, self._walk_blacklist)
            except OSError:
                self.snapshot = None
        return {self.context_dir}

    # -- build lifecycle --

    def begin_build(self, ctx, resident_process: bool = False) -> str:
        """Arm ``ctx`` with this session's resident state; returns the
        warm mode the build runs under ("resident", "rescan" or
        "restored"). ``resident_process`` (``--watch``) also moves the
        stat cache's save to a background thread: a one-shot process
        keeps the synchronous save or it may exit before the write
        lands."""
        self.builds += 1
        self.last_used_mono = time.monotonic()
        self._resident_hint = resident_process or self.builds >= 2
        self.storage_dir = ctx.image_store.root
        self._walk_blacklist = [
            p for p in (list(ctx.base_blacklist) + [ctx.image_store.root])
            if p != ctx.context_dir]
        # The tracker must exist before this build's scan reads a file:
        # an edit landing after the scan passed it must surface in the
        # next build's dirty set. Watcher events queue in the kernel; the
        # walk baseline below is taken before the scan, so the next delta
        # re-examines whatever moved after it.
        if self.watcher is None:
            self.watcher = InotifyWatcher(self.context_dir,
                                          self._walk_blacklist)
            if not self.watcher.healthy:
                self.watcher.close()
        self.poll_changes()
        # .dockerignore decides which paths enter cache identity but lies
        # outside the per-source subtrees, so the dirty containment check
        # cannot see it change: hash it every build and drop the memo on
        # any change.
        ignore_sig = self._ignore_signature()
        if ignore_sig != self._ignore_sig:
            if self._ignore_sig is not None or ignore_sig is not None:
                self.scan_memo.clear()
                self._snap_scan_dirty = True
            self._ignore_sig = ignore_sig
        # Adopt or install the resident stat cache.
        if self.content_ids is None:
            self.content_ids = ctx.content_ids
        else:
            ctx.content_ids = self.content_ids
        # Snapshot-restored stat entries merge on first use (local
        # knowledge wins), and each still faces the per-lookup stat
        # comparison and the racy window.
        cache = self.content_ids
        if cache is not None:
            if self._restored_stat_entries is not None:
                cache.merge_entries(self._restored_stat_entries)
            cache.begin_build()
            # Resident process: the stat cache's disk copy is durability
            # only; persist it off the build's critical path.
            if resident_process:
                cache.defer_save = True
        self._restored_stat_entries = None
        mode = "resident" if self.exact else "rescan"
        if self.restored:
            # First build after a restore: the residency of the mode it
            # shadows (dirty_exact still gates the scan memo), reported
            # apart so a hand-off is told from a resident hit.
            mode = "restored"
            self.restored = False
        ctx.session = self
        ctx.dirty_paths = frozenset(self.pending_dirty)
        ctx.dirty_exact = self.exact
        if self.exact:
            self.hits += 1
            metrics.counter_add(metrics.SESSION_HITS)
        log.info("build session %s: mode=%s dirty=%d builds=%d",
                 self.identity, mode, len(self.pending_dirty), self.builds,
                 mode=mode, dirty=len(self.pending_dirty),
                 builds=self.builds, watcher=self.watcher_kind())
        return mode

    def finish_build(self, ctx, ok: bool) -> None:
        self.last_used_mono = time.monotonic()
        if ok:
            # Everything dirty was consumed by this build's scan.
            self.pending_dirty.clear()
            if self.watcher is not None and self.watcher.healthy:
                # Edits made during the build are drained and kept
                # pending: the scan may have read a file before the
                # racing write landed (one extra re-hash, never a stale
                # identity). Collect runs before resync, so a raced
                # structural event rebuilds the watches.
                raced = self.watcher.collect()
                self.watcher.resync()
                if raced is None or not self.watcher.healthy:
                    # The watcher died at the finish line: the next
                    # begin's poll flags the context and re-seeds a walk
                    # baseline.
                    self.watcher.close()
                    self.snapshot = None
                    self.exact = False
                else:
                    self.pending_dirty |= raced
                    self._snap_gap_paths += len(raced)
                    self.exact = True
            else:
                # mtime-walk fallback: the baseline taken at begin_build,
                # before this build's scan, is the certification point.
                self.exact = self.snapshot is not None
        else:
            # A failed build may have consumed part of the dirty set
            # before it died; only a full scan certifies it again.
            self.exact = False
            self.snapshot = None
            self.pending_dirty.clear()
            self.scan_memo.clear()
            self._snap_scan_dirty = True
            self._snap_walk_all = True
        # The per-build context must not keep a dead session reference.
        ctx.session = None
        ctx.dirty_paths = frozenset()
        ctx.dirty_exact = False
        if ok:
            self.checkpoint()

    def checkpoint(self, force: bool = False) -> dict | None:
        """Write this session's snapshot through the chunk CAS
        (worker/snapshots.py): incremental (only dirty shards
        serialize again) and advisory (a failure costs durability, never
        the build). ``force`` checkpoints a session the auto policy would
        skip."""
        policy = snapshot_policy()
        if policy == "0" or not self.portable_identity \
                or not self.storage_dir:
            return None
        if not force and policy == "auto" and not self._resident_hint:
            return None
        from makisu_tpu_torch.worker import snapshots as snapshots_mod
        recipe = snapshots_mod.write_snapshot(self, self.storage_dir)
        manager().note_snapshot(
            "write" if recipe is not None else "write_error",
            context=self.context_dir)
        return recipe

    # -- memo surfaces (called through ctx by steps, memfs and node) --

    def scan_lookup(self, source: str, checksum_in: int):
        key = (source, checksum_in)
        hit = self.scan_memo.get(key)
        if hit is not None:
            # Recency bump (dict order is the LRU order): a hot key
            # replayed every build must outlive a burst of one-shot keys.
            self.scan_memo.pop(key)
            self.scan_memo[key] = hit
        return hit

    def scan_store(self, source: str, checksum_in: int,
                   checksum_out: int, files: int, nbytes: int) -> None:
        if len(self.scan_memo) >= _SCAN_MEMO_KEEP:
            # The front of the dict is the least recently stored or
            # replayed key (scan_lookup re-inserts on a hit).
            self.scan_memo.pop(next(iter(self.scan_memo)))
        self.scan_memo[(source, checksum_in)] = (
            checksum_out, files, nbytes)
        self._snap_scan_dirty = True

    def replay_lookup(self, key: tuple[str, str]):
        return self.layer_replay.get(key)

    def replay_store(self, key: tuple[str, str], entries: list) -> None:
        if key in self.layer_replay:
            return
        self.layer_replay[key] = entries
        self._layer_entry_count += len(entries)

    def evict_layers(self, keep_bytes: int) -> None:
        """Drop the oldest layer memos until the resident bytes fit."""
        while self.layer_replay and self.resident_bytes() > keep_bytes:
            key, entries = next(iter(self.layer_replay.items()))
            del self.layer_replay[key]
            self._layer_entry_count -= len(entries)

    def close(self) -> None:
        if self.watcher is not None:
            self.watcher.close()
            self.watcher = None


# -- the manager ------------------------------------------------------------


class SessionManager:
    """Process-wide session registry with TTL, LRU and byte-budget
    eviction. One session per context path; acquire never blocks: a
    second concurrent build of the same context bypasses residency."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._sessions: dict[str, BuildSession] = {}
        self.invalidations: dict[str, int] = {}
        # Snapshot-plane events (write / write_error / restore /
        # restore_refused / restore_error) and the last failed restore.
        self.snapshot_counts: dict[str, int] = {}
        self.last_restore_failure: dict = {}

    def note_snapshot(self, event: str, context: str = "",
                      reason: str = "") -> None:
        with self._mu:
            self.snapshot_counts[event] = \
                self.snapshot_counts.get(event, 0) + 1
            if event in ("restore_refused", "restore_error"):
                self.last_restore_failure = {
                    "context": context, "reason": reason,
                    "ts": time.time()}

    def _invalidate_locked(self, key: str, reason: str) -> None:
        session = self._sessions.pop(key, None)
        if session is None:
            return
        session.close()
        self.invalidations[reason] = self.invalidations.get(reason, 0) + 1
        metrics.counter_add(metrics.SESSION_INVALIDATIONS, reason=reason)
        ledger.record("session", session.context_dir, "invalidated",
                      reason=reason, builds=session.builds,
                      resident_bytes=session.resident_bytes())
        log.info("build session invalidated: %s (%s)",
                 session.context_dir, reason)

    def _publish_bytes_locked(self) -> None:
        total = sum(s.resident_bytes() for s in self._sessions.values())
        metrics.global_registry().gauge_set(metrics.SESSION_RESIDENT_BYTES,
                                            total)

    def _evict_lru_locked(self, keep: str, reason: str, over) -> None:
        """Evict the stalest idle sessions other than ``keep`` while
        ``over()`` holds."""
        while over():
            victims = sorted(
                (s.last_used_mono, k) for k, s in self._sessions.items()
                if k != keep and not s.busy)
            if not victims:
                break
            self._invalidate_locked(victims[0][1], reason)

    def acquire(self, context_dir: str, identity: str,
                restore_spec: "tuple[str, str] | None" = None,
                ) -> tuple["BuildSession | None", str]:
        """Lease the context's session for one build. Returns
        ``(session, verdict)``: ``hit`` (a live session reused),
        ``restored`` (none resident, but a snapshot passed every
        invalidation check and was rebuilt), ``miss`` (a new session) or
        ``busy`` (another build holds it; proceed without residency).
        ``restore_spec`` is ``(storage_dir, portable_identity)``; without
        it the snapshot plane is never consulted."""
        context_dir = os.path.abspath(context_dir)
        key = os.path.realpath(context_dir)
        now = time.monotonic()
        with self._mu:
            session = self._sessions.get(key)
            if session is not None:
                if session.busy:
                    return None, "busy"
                if session.identity != identity:
                    self._invalidate_locked(key, "flag_identity")
                    session = None
                elif session.isa != _isa_identity():
                    self._invalidate_locked(key, "isa_change")
                    session = None
                elif now - session.last_used_mono > session_ttl():
                    self._invalidate_locked(key, "ttl")
                    session = None
            if session is not None:
                if restore_spec is not None:
                    session.portable_identity = restore_spec[1]
                session.busy = True
                self._publish_bytes_locked()
                return session, "hit"
        # Cold miss: consult the snapshot plane outside the lock.
        restored = None
        if restore_spec is not None and snapshot_policy() != "0":
            restored = self._try_restore(context_dir, identity,
                                         restore_spec)
        with self._mu:
            resident = self._sessions.get(key)
            if resident is not None:
                # A concurrent acquire won the race while this one
                # restored: the resident session is the single writer.
                if restored is not None:
                    restored.close()
                if resident.busy:
                    return None, "busy"
                session, verdict = resident, "hit"
            else:
                session = restored if restored is not None \
                    else BuildSession(context_dir, identity)
                verdict = "restored" if restored is not None else "miss"
                if restore_spec is not None:
                    session.portable_identity = restore_spec[1]
                self._sessions[key] = session
                # Count-based LRU; a restore that pushed the count over
                # labels its victims lru_restore.
                self._evict_lru_locked(
                    key, "lru_restore" if verdict == "restored" else "lru",
                    lambda: len(self._sessions) > max(1, max_sessions()))
            session.busy = True
            self._publish_bytes_locked()
        return session, verdict

    def _try_restore(self, context_dir: str, identity: str,
                     restore_spec: tuple) -> "BuildSession | None":
        """A snapshot restore outside the manager lock. Counts every
        outcome; ``absent`` (no recipe) is a plain cold miss."""
        storage_dir, portable = restore_spec
        from makisu_tpu_torch.worker import snapshots as snapshots_mod
        try:
            session, reason = snapshots_mod.try_restore(
                context_dir, identity, storage_dir, portable)
        except Exception as exc:  # noqa: BLE001 - advisory plane
            log.warning("session snapshot restore errored for %s: %s",
                        context_dir, exc)
            session, reason = None, "error"
        if session is not None:
            self.note_snapshot("restore", context=context_dir)
            metrics.counter_add(metrics.SESSION_SNAPSHOT_RESTORES,
                                result="ok")
            ledger.record("session", context_dir, "restored",
                          reason="snapshot",
                          resident_bytes=session.resident_bytes())
            log.info("build session restored from snapshot: %s "
                     "(exact=%s layers=%d)", context_dir, session.exact,
                     len(session.layer_replay))
            return session
        if reason:
            event = ("restore_error" if reason == "error"
                     else "restore_refused")
            self.note_snapshot(event, context=context_dir, reason=reason)
            metrics.counter_add(
                metrics.SESSION_SNAPSHOT_RESTORES,
                result="refused" if event == "restore_refused"
                else "error", reason=reason)
            ledger.record("session", context_dir, "restore_refused",
                          reason=reason)
            log.info("session snapshot restore refused for %s (%s)",
                     context_dir, reason)
        return None

    def release(self, session: BuildSession) -> None:
        key = os.path.realpath(session.context_dir)
        budget = max_resident_bytes()

        def total() -> int:
            return sum(s.resident_bytes() for s in self._sessions.values())

        with self._mu:
            session.busy = False
            # Byte-budget evictions caused by a freshly restored session
            # count as lru_restore: a sizing signal, not plain churn.
            reason = "lru_restore" if session._restore_fresh else "lru"
            session._restore_fresh = False
            # Shrink the releasing session's layer memo first, then
            # evict whole idle sessions, oldest first.
            over = total()
            if over > budget:
                session.evict_layers(
                    max(0, budget - (over - session.resident_bytes())))
            self._evict_lru_locked(
                key, reason,
                lambda: total() > budget and len(self._sessions) > 1)
            self._publish_bytes_locked()

    def peek(self, context_dir: str) -> "BuildSession | None":
        """The context's live session, if any: no lease, no checks (the
        watch loop polls its changes between builds)."""
        key = os.path.realpath(os.path.abspath(context_dir))
        with self._mu:
            return self._sessions.get(key)

    def storage_dir_for(self, context_dir: str) -> str:
        """The storage dir the context's resident session is bound to
        ("" without a resident session, or before it built): the
        worker's snapshot endpoints look for its recipe there first."""
        key = os.path.realpath(os.path.abspath(context_dir))
        with self._mu:
            session = self._sessions.get(key)
            return session.storage_dir or "" if session else ""

    def invalidate(self, context_dir: str = "") -> int:
        """Explicit invalidation. An empty context drops every idle
        session; returns the count."""
        dropped = 0
        with self._mu:
            if context_dir:
                keys = [os.path.realpath(os.path.abspath(context_dir))]
            else:
                keys = list(self._sessions)
            for key in keys:
                session = self._sessions.get(key)
                if session is None or session.busy:
                    continue
                self._invalidate_locked(key, "explicit")
                dropped += 1
            self._publish_bytes_locked()
        return dropped

    def snapshot_all(self, context_dir: str = "") -> int:
        """Checkpoint every idle resident session (or the one of
        ``context_dir``) into the snapshot plane now (the worker's
        ``POST /sessions/snapshot``). The writes run outside the lock;
        returns the number of sessions checkpointed."""
        want = (os.path.realpath(os.path.abspath(context_dir))
                if context_dir else "")
        with self._mu:
            candidates = [s for k, s in self._sessions.items()
                          if not s.busy and (not want or k == want)]
        done = 0
        for session in candidates:
            if session.checkpoint(force=True) is not None:
                done += 1
        return done

    def close(self) -> None:
        """Drop every idle session and release its inotify watch (a
        closing worker's manager); a session a build still leases stays
        until that build ends."""
        with self._mu:
            for key in [k for k, s in self._sessions.items() if not s.busy]:
                self._sessions.pop(key).close()

    def stats(self) -> dict:
        with self._mu:
            sessions = [s.stats() for s in self._sessions.values()]
            invalidations = dict(self.invalidations)
            snapshot_counts = dict(self.snapshot_counts)
            last_failure = dict(self.last_restore_failure)
        sessions.sort(key=lambda s: s["context"])
        return {
            "count": len(sessions),
            "resident_bytes": sum(s["resident_bytes"] for s in sessions),
            "hits": sum(s["hits"] for s in sessions),
            "invalidations": dict(sorted(invalidations.items())),
            "max_sessions": max_sessions(),
            "max_resident_bytes": max_resident_bytes(),
            "ttl_seconds": session_ttl(),
            "snapshot": {
                **{k: snapshot_counts.get(k, 0)
                   for k in ("write", "write_error", "restore",
                             "restore_refused", "restore_error")},
                "last_restore_failure": last_failure,
            },
            "sessions": sessions,
        }

    def reset(self) -> None:
        """Drop everything (tests)."""
        with self._mu:
            for session in self._sessions.values():
                session.close()
            self._sessions.clear()
            self.invalidations.clear()
            self.snapshot_counts.clear()
            self.last_restore_failure = {}
            self._publish_bytes_locked()


_manager = SessionManager()

# Context-bound manager override: a caller binds its own SessionManager
# around the builds it runs (threads the build spawns inherit it through
# contextvars.copy_context), so builds that model separate processes see
# separate sessions. Standalone builds and --watch keep the process-wide
# manager.
_bound_manager: "contextvars.ContextVar[SessionManager | None]" = \
    contextvars.ContextVar("makisu_torch_session_manager", default=None)


def bind_manager(mgr: SessionManager):
    """Bind ``mgr`` as the current context's session manager; returns a
    token for ``reset_manager``."""
    return _bound_manager.set(mgr)


def reset_manager(token) -> None:
    _bound_manager.reset(token)


def manager() -> SessionManager:
    return _bound_manager.get() or _manager
