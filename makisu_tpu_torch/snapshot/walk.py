"""Filesystem walking, skip rules, and in-root symlink resolution.

Copy of ``makisu_tpu/snapshot/walk.py`` (reference capability:
lib/snapshot/utils.go — shouldSkip, walk, removeAllChildren,
evalSymlinks/walkLinks), with the dirty-set primitives of the resident
build sessions (``snapshot_tree`` / ``snapshot_delta``): a stat-signature
snapshot of a context tree and the walk-based delta between two
snapshots, the mtime-walk fallback of ``worker/session.py`` when inotify
is unavailable. One scandir pass, no content reads.
"""

from __future__ import annotations

import dataclasses
import os
import stat as statmod
import tarfile
import time

from makisu_tpu_torch.utils import mountinfo, pathutils, sysutils

WHITEOUT_PREFIX = ".wh."
WHITEOUT_META_PREFIX = ".wh..wh."


def should_skip(path: str, st: os.stat_result | None,
                blacklist: list[str]) -> bool:
    """Paths that never participate in snapshots: AUFS whiteout metadata,
    blacklisted trees, special files, and mount points."""
    if os.path.basename(path).startswith(WHITEOUT_META_PREFIX):
        return True
    if pathutils.is_descendant_of_any(path, blacklist):
        return True
    if st is not None and sysutils.is_special_file(st):
        return True
    return mountinfo.is_mountpoint(path)


def walk(src_root: str, blacklist: list[str] | None, fn) -> None:
    """Depth-first lexical walk calling ``fn(path, stat)``; prunes skipped
    directories. Includes ``src_root`` itself (like filepath.Walk).

    Uses os.scandir so each entry's type/stat comes from the dirent
    cache — on large trees (node_modules-style contexts, the reference's
    "avoid unnecessary disk scans" hot loop) this roughly halves the
    syscalls of a listdir+lstat walk."""
    blacklist = blacklist or []

    def sorted_entries(path):
        return iter(sorted(os.scandir(path), key=lambda e: e.name))

    st = os.lstat(src_root)
    if should_skip(src_root, st, blacklist):
        return
    fn(src_root, st)
    if not os.path.isdir(src_root) or os.path.islink(src_root):
        return
    # Explicit iterator stack (not recursion): trees deeper than
    # Python's ~1000-frame limit must not crash the layer scan. Visit
    # order is identical to the recursive form — each entry fires in
    # sorted order, descending into a directory before its siblings.
    stack = [sorted_entries(src_root)]
    while stack:
        entry = next(stack[-1], None)
        if entry is None:
            stack.pop()
            continue
        st = entry.stat(follow_symlinks=False)
        if should_skip(entry.path, st, blacklist):
            continue
        fn(entry.path, st)
        if entry.is_dir(follow_symlinks=False):
            stack.append(sorted_entries(entry.path))


# -- dirty-set primitives ---------------------------------------------------

# A path's stat signature for change detection. ctime_ns is the linchpin:
# size and mtime can be restored by tooling (utime), but a content write
# always moves ctime, the discipline of the stat cache
# (utils/statcache.py).
def stat_signature(st: os.stat_result) -> tuple:
    return (st.st_mode, st.st_size, st.st_mtime_ns, st.st_ctime_ns,
            st.st_ino)


@dataclasses.dataclass
class TreeSnapshot:
    """Stat signatures of every path under a root at capture time.
    ``fresh`` holds paths whose timestamps were within the racy window
    of the capture: a same-tick edit after the capture would alias their
    signature, so a delta against this snapshot marks them dirty once (a
    bounded re-hash, never a stale identity)."""

    root: str
    captured_ns: int
    sigs: dict[str, tuple]
    fresh: set[str]
    # Resident-byte estimate, computed once at capture (the session's
    # accounting polls it far too often for a re-sum per call).
    est_bytes: int = 0

    def approx_bytes(self) -> int:
        return self.est_bytes


@dataclasses.dataclass
class TreeDelta:
    """Paths that moved between two snapshots of one root. ``dirty`` is
    the union the skip decisions key on: changed, added, removed and the
    previous snapshot's racy-fresh survivors."""

    changed: set[str]
    added: set[str]
    removed: set[str]
    fresh: set[str]

    @property
    def dirty(self) -> set[str]:
        return self.changed | self.added | self.removed | self.fresh

    @property
    def real_dirty(self) -> set[str]:
        """Signature-confirmed changes only (no racy re-checks): what a
        watch loop rebuilds on; fresh-only dirt would rebuild once per
        racy window with no edit at all."""
        return self.changed | self.added | self.removed


def _racy_window_ns() -> int:
    from makisu_tpu_torch.utils import statcache
    return statcache.racy_window_ns()


def snapshot_tree(root: str,
                  blacklist: list[str] | None = None) -> TreeSnapshot:
    """One scandir+lstat pass capturing every path's stat signature (the
    root itself excluded: its mtime churns with its children and carries
    no content identity of its own)."""
    captured_ns = time.time_ns()
    window = _racy_window_ns()
    sigs: dict[str, tuple] = {}
    fresh: set[str] = set()

    def visit(path: str, st: os.stat_result) -> None:
        if path == root:
            return
        sigs[path] = stat_signature(st)
        if captured_ns - max(st.st_mtime_ns, st.st_ctime_ns) < window:
            fresh.add(path)

    walk(root, blacklist, visit)
    # Rough accounting: path string + signature tuple per entry.
    return TreeSnapshot(root, captured_ns, sigs, fresh,
                        sum(len(p) + 120 for p in sigs))


def snapshot_delta(prev: TreeSnapshot,
                   blacklist: list[str] | None = None
                   ) -> tuple[TreeSnapshot, TreeDelta]:
    """Re-walk ``prev.root`` and compute what moved since ``prev``.
    Returns the new snapshot (the next delta's baseline) and the delta.
    Costs one stat walk: no content reads, no hashing."""
    cur = snapshot_tree(prev.root, blacklist)
    changed = {p for p, sig in cur.sigs.items()
               if p in prev.sigs and prev.sigs[p] != sig}
    added = set(cur.sigs) - set(prev.sigs)
    removed = set(prev.sigs) - set(cur.sigs)
    # Racy survivors: paths the previous capture could not certify. If
    # their signature moved they are in `changed`; if not, they still
    # get one dirty round.
    fresh = {p for p in prev.fresh if p in cur.sigs} - changed
    return cur, TreeDelta(changed, added, removed, fresh)


def remove_all_children(src_root: str, blacklist: list[str]) -> None:
    """Delete everything under src_root except skipped paths, keeping any
    directory that still holds a surviving (blacklisted/mounted) child.

    Iterative (deep trees must not hit the recursion limit): collect
    candidates depth-first, then delete deepest-first — a directory with
    a surviving child simply fails its rmdir and is kept, which is
    exactly the recursive semantics."""
    stack = [os.path.join(src_root, name) for name in os.listdir(src_root)]
    order: list[str] = []
    while stack:
        path = stack.pop()
        try:
            st = os.lstat(path)
        except OSError:
            continue  # already gone
        if should_skip(path, st, blacklist):
            continue  # kept; its ancestors fail rmdir and survive too
        order.append(path)
        if os.path.isdir(path) and not os.path.islink(path):
            # An unreadable dir (EACCES) must fail the cleanup loudly —
            # silently keeping its contents would leak stage-1 files
            # into stage-2 layers. A dir deleted since lstat is a benign
            # race (the delete loop below tolerates it too).
            try:
                names = os.listdir(path)
            except (FileNotFoundError, NotADirectoryError):
                continue  # deleted/replaced since lstat: benign race
            stack.extend(os.path.join(path, name) for name in names)
    for path in reversed(order):
        try:
            if os.path.isdir(path) and not os.path.islink(path):
                os.rmdir(path)
            else:
                os.remove(path)
        except OSError:
            pass  # nonempty dir (surviving child) or racing delete


def eval_symlinks(path: str, root: str) -> str:
    """Resolve symlinks of a root-relative path *within* root, returning the
    absolute logical path. Links may not escape the root; loops error."""
    if not path:
        return path
    resolved: list[str] = []
    walked = 0
    pending = pathutils.split_path(path)
    while pending:
        part = pending.pop(0)
        cur_logical = "/" + "/".join(resolved + [part])
        cur_disk = pathutils.join_root(root, cur_logical)
        try:
            st = os.lstat(cur_disk)
        except FileNotFoundError:
            resolved.append(part)
            continue
        if not os.path.islink(cur_disk):
            resolved.append(part)
            continue
        walked += 1
        if walked > 255:
            raise OSError(f"eval symlinks: too many links at {path}")
        target = os.readlink(cur_disk)
        if os.path.isabs(target):
            if target.startswith(root.rstrip("/") + "/") or target == root:
                target = pathutils.trim_root(target, root)
            resolved = []
        pending = pathutils.split_path(target) + pending
    return "/" + "/".join(resolved)


def tarinfo_from_stat(src: str, name: str, root: str,
                      st: os.stat_result | None = None) -> tarfile.TarInfo:
    """Build a TarInfo from an on-disk path, from ``st`` (its lstat)
    where the caller has it, as a walk's visitor does: one lstat an
    entry, not two.

    Directory names get docker's trailing slash; absolute symlink targets
    are rebased to be root-relative (reference: memLayer.createHeader,
    mem_layer.go:~110-140).
    """
    if st is None:
        st = os.lstat(src)
    hdr = tarfile.TarInfo(name)
    hdr.mode = st.st_mode & 0o7777
    hdr.uid = st.st_uid
    hdr.gid = st.st_gid
    hdr.mtime = int(st.st_mtime)
    hdr.uname = ""
    hdr.gname = ""
    if statmod.S_ISDIR(st.st_mode):
        # (tarfile adds docker's trailing slash to dir names at write time)
        hdr.type = tarfile.DIRTYPE
    elif statmod.S_ISLNK(st.st_mode):
        hdr.type = tarfile.SYMTYPE
        target = os.readlink(src)
        if os.path.isabs(target):
            target = pathutils.trim_root(target, root)
        hdr.linkname = target
    else:
        hdr.type = tarfile.REGTYPE
        hdr.size = st.st_size
    return hdr
