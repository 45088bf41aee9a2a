"""Recursive file copying with ownership policies.

Copy of ``makisu_tpu/utils/fileio.py`` (reference capability:
lib/fileio/copy.go). Behavior: blacklist pruning,
symlinks copied as links (never chowned), special files skipped, existing
destinations overwritten, dst dirs created 0755 and root-owned by default, ownership
override policies for COPY --chown / context copies / --archive.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading

from makisu_tpu_torch.utils import pathutils, sysutils


def write_bytes_atomic(path: str, payload: bytes) -> None:
    """Crash-safe write: the bytes go to a uniquely named temp file in
    the destination directory, are fsynced, then renamed over ``path``.
    A reader (or the next build) sees either the old complete file or
    the new complete file, never a truncation, even across a SIGTERM
    mid-write or a power cut after the rename (the fsync orders the data
    before the metadata). The temp name carries pid and thread id:
    concurrent writers in one process must not clobber each other's
    in-flight writes."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # Unwinding through here includes a signal handler's
        # SystemExit: the orphan temp file must not accumulate.
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_json_atomic(path: str, payload, default=str) -> None:
    """``write_bytes_atomic`` of ``payload`` as compact JSON (the stat
    cache, the session snapshot recipes). A payload that fails to
    serialize raises before any file is opened."""
    write_bytes_atomic(path, json.dumps(
        payload, separators=(",", ":"), default=default).encode())


@dataclasses.dataclass(frozen=True)
class Owner:
    uid: int
    gid: int
    overwrite: bool  # force this owner instead of the source's


def _copy_times(src: str, dst: str) -> None:
    st = os.lstat(src)
    os.utime(dst, ns=(st.st_atime_ns, st.st_mtime_ns))


def _chown(path: str, uid: int, gid: int, follow_symlinks=True) -> None:
    try:
        os.chown(path, uid, gid, follow_symlinks=follow_symlinks)
    except PermissionError:
        pass  # unprivileged builds keep current ownership


class Copier:
    """Copies files/trees, applying destination ownership policies.

    ``dir_owner`` applies to the destination directory itself (and any
    directories created along the way when ``overwrite``); ``file_owner``
    applies to copied files and, when ``overwrite``, to every child.
    """

    def __init__(self, blacklist: list[str] | None = None,
                 dir_owner: Owner | None = None,
                 file_owner: Owner | None = None) -> None:
        self.blacklist = list(blacklist or [])
        self.dir_owner = dir_owner
        self.file_owner = file_owner
        # Ancestor dirs this copier synthesized (no source counterpart,
        # so no mtime to preserve). Callers producing layers timestamp
        # them deterministically afterwards (CopyOperation.execute) so
        # the disk state matches the epoch-mtime headers MemFS
        # synthesizes for the same paths — otherwise the next scan diff
        # re-emits every such dir with the wall clock in it.
        self.created_dirs: list[str] = []

    def _blacklisted(self, p: str) -> bool:
        return pathutils.is_descendant_of_any(p, self.blacklist)

    def copy_file(self, src: str, dst: str) -> None:
        self._mkdir_ancestors(os.path.dirname(dst))
        self._copy_file(src, dst)

    def copy_dir(self, src: str, dst: str) -> None:
        if self._blacklisted(src):
            return
        self._mkdir_ancestors(os.path.dirname(dst))
        self._ensure_dir(src, dst, top=True)
        self._copy_dir_contents(src, dst, dst)
        _copy_times(src, dst)

    # -- internals --------------------------------------------------------

    def _mkdir_ancestors(self, dst: str) -> None:
        """Create missing ancestor dirs with default mode 0755, root-owned."""
        dst = os.path.abspath(dst)
        parts = pathutils.split_path(dst)
        cur = "/"
        for part in parts:
            cur = os.path.join(cur, part)
            if not os.path.lexists(cur):
                os.mkdir(cur, 0o755)
                _chown(cur, 0, 0)
                self.created_dirs.append(cur)

    def _ensure_dir(self, src: str, dst: str, top: bool) -> None:
        """Create/update one destination directory from a source directory."""
        st = os.lstat(src)
        if not os.path.lexists(dst):
            os.mkdir(dst, st.st_mode & 0o7777)
        elif not os.path.isdir(dst):
            raise NotADirectoryError(f"dst {dst} is not a directory")
        uid, gid = st.st_uid, st.st_gid
        owner = self.dir_owner if top else None
        if owner is None and self.file_owner and self.file_owner.overwrite:
            owner = self.file_owner
        if owner is not None:
            uid, gid = owner.uid, owner.gid
        _chown(dst, uid, gid)
        os.chmod(dst, st.st_mode & 0o7777)

    def _copy_dir_contents(self, src: str, dst: str, orig_dst: str) -> None:
        for name in sorted(os.listdir(src)):
            cur_src = os.path.join(src, name)
            if self._blacklisted(cur_src) or cur_src == orig_dst:
                continue  # orig_dst check breaks dst-inside-src loops
            cur_dst = os.path.join(dst, name)
            if os.path.isdir(cur_src) and not os.path.islink(cur_src):
                self._ensure_dir(cur_src, cur_dst, top=False)
                self._copy_dir_contents(cur_src, cur_dst, orig_dst)
                # Post-order so child writes don't clobber the dir mtime.
                _copy_times(cur_src, cur_dst)
            else:
                self._copy_file(cur_src, cur_dst)

    def _copy_file(self, src: str, dst: str) -> None:
        if self._blacklisted(src):
            return
        st = os.lstat(src)
        if os.path.islink(src):
            if os.path.lexists(dst):
                os.remove(dst)
            os.symlink(os.readlink(src), dst)
            return  # symlinks are never chowned/chmodded
        if sysutils.is_special_file(st):
            return
        if os.path.lexists(dst) and not os.path.isdir(dst):
            os.chmod(dst, 0o777)
        with open(src, "rb") as r, open(dst, "wb") as w:
            shutil.copyfileobj(r, w)
        uid, gid = st.st_uid, st.st_gid
        if self.file_owner and self.file_owner.overwrite:
            uid, gid = self.file_owner.uid, self.file_owner.gid
        _chown(dst, uid, gid)
        os.chmod(dst, st.st_mode & 0o7777)
        # Preserve mtime: the snapshot layer records the source's header,
        # so the on-disk copy must look identical or the next scan-diff
        # re-adds every copied file.
        os.utime(dst, ns=(st.st_atime_ns, st.st_mtime_ns))
