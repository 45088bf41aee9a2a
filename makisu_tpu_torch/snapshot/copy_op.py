"""Copy operations: the validated form of one ADD/COPY directive.

Reference capability: lib/snapshot/copy_op.go (NewCopyOperation:29,
Execute:80, resolveDestination/checkCopyParams). A CopyOperation carries
resolved sources (relative to a source root — the build context or a
checkpointed stage dir), an absolute destination (workdir-resolved), and
the ownership policy derived from --chown/--archive.
"""

from __future__ import annotations

import os

from makisu_tpu_torch.utils import fileio, pathutils, sysutils
from makisu_tpu_torch.utils.fileio import Owner


def is_dir_format(dst: str) -> bool:
    return dst.endswith("/") or dst in (".", "..")


def resolve_destination(workdir: str, dst: str) -> str:
    if os.path.isabs(dst):
        return dst
    resolved = os.path.join(workdir, dst)
    if is_dir_format(dst) and not resolved.endswith("/"):
        resolved += "/"
    return resolved


class CopyOperation:
    def __init__(self, srcs: list[str], src_root: str, workdir: str,
                 dst: str, chown: str = "", blacklist: list[str] | None = None,
                 internal: bool = False, preserve_owner: bool = False) -> None:
        if not srcs:
            raise ValueError("copy sources cannot be empty")
        if len(srcs) > 1 and not is_dir_format(dst):
            raise ValueError(
                'copying multiple sources: destination must end with "/"')
        if not os.path.isabs(dst) and not os.path.isabs(workdir):
            raise ValueError(
                "relative dst requires an absolute working directory")
        if chown and preserve_owner:
            raise ValueError("--chown and --archive are mutually exclusive")
        self.src_root = src_root
        self.srcs = [pathutils.rel_path(s) for s in srcs]
        self.dst = resolve_destination(workdir, dst)
        self.uid, self.gid = sysutils.resolve_chown(chown)
        self.chown = bool(chown)
        self.preserve_owner = preserve_owner
        self.blacklist = list(blacklist or [])
        self.internal = internal  # cross-stage COPY --from (sandbox source)

    def _copier(self, src_stat: os.stat_result) -> fileio.Copier:
        # Ownership policy matrix (reference copy_op.go Execute):
        #   --chown:             everything owned uid:gid
        #   context copy:        everything owned root:root
        #   --from --archive:    dst dir takes the source owner
        #   --from:              owners pass through unchanged
        blacklist = [] if self.internal else self.blacklist
        if self.chown:
            return fileio.Copier(
                blacklist,
                dir_owner=Owner(self.uid, self.gid, False),
                file_owner=Owner(self.uid, self.gid, True))
        if not self.internal:
            return fileio.Copier(
                blacklist,
                dir_owner=Owner(0, 0, False),
                file_owner=Owner(0, 0, True))
        if self.preserve_owner:
            return fileio.Copier(
                blacklist,
                dir_owner=Owner(src_stat.st_uid, src_stat.st_gid, False))
        return fileio.Copier(blacklist)

    def execute(self, eval_symlinks, root: str = "/") -> None:
        """Perform the copy on disk (modifyfs builds). ``dst`` is logical;
        ``root`` maps it to the physical build root (identity in
        production where root is "/"). ``eval_symlinks`` is
        snapshot.walk.eval_symlinks."""
        dst = pathutils.join_root(root, self.dst)
        if is_dir_format(self.dst):
            dst += "/"
        synthesized: list[str] = []
        for src in self.srcs:
            src = eval_symlinks(src, self.src_root)
            src = pathutils.join_root(self.src_root, src)
            st = os.lstat(src)
            copier = self._copier(st)
            if os.path.isdir(src) and not os.path.islink(src):
                copier.copy_dir(src, dst)
            elif is_dir_format(self.dst):
                copier.copy_file(src, os.path.join(dst,
                                                   os.path.basename(src)))
            else:
                copier.copy_file(src, dst)
            synthesized.extend(copier.created_dirs)
        # Synthesized ancestors (e.g. /app for COPY . /app/) get epoch
        # mtime AFTER all writes (each child creation bumped the dir),
        # matching the epoch-mtime headers MemFS synthesizes for the
        # same paths — a live timestamp here would make the next scan
        # diff re-emit the dir into an unrelated layer with the wall
        # clock in it, breaking layer reproducibility.
        for d in synthesized:
            try:
                os.utime(d, (0, 0))
            except OSError:
                pass
