"""Filesystem walking, skip rules, and in-root symlink resolution.

Copy of ``makisu_tpu/snapshot/walk.py`` without the dirty-set
primitives of the resident sessions (reference capability:
lib/snapshot/utils.go — shouldSkip, walk, removeAllChildren,
evalSymlinks/walkLinks).
"""

from __future__ import annotations

import os
import stat as statmod
import tarfile

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


def tarinfo_from_stat(src: str, name: str, root: str) -> tarfile.TarInfo:
    """Build a TarInfo from an on-disk path.

    Directory names get docker's trailing slash; absolute symlink targets
    are rebased to be root-relative (reference: memLayer.createHeader,
    mem_layer.go:~110-140).
    """
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
