"""MemFS: the in-memory merged filesystem view driving layer generation.

The tree holds the header of every path as of the layers applied so far.
Committing a step diffs reality against the tree:

- ``add_layer_by_scan`` walks the disk (after RUN steps) and emits entries
  whose headers differ from the tree, plus whiteouts for tree children
  that vanished from disk.
- ``add_layer_by_copy_ops`` computes the layer purely from ADD/COPY
  operations without scanning.
- ``update_from_tar`` merges a pulled layer into the tree (optionally
  materializing it on disk), honoring whiteouts.

Copy of ``makisu_tpu/snapshot/memfs.py`` with the resident session's
applied-chain identity and layer replay, a commit's mtime wait bounded by
the layer's own newest mtime (the reference waits a flat second), without
the native route's log line (reference capability:
lib/snapshot/mem_fs.go — NewMemFS:69, UpdateFromTarReader:165,
AddLayerByScan:260, AddLayerByCopyOps:276, Checkpoint:91).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import tarfile
import time
from glob import glob

from makisu_tpu_torch import tario
from makisu_tpu_torch.snapshot.copy_op import CopyOperation
from makisu_tpu_torch.snapshot.layer import ContentEntry, Layer, WhiteoutEntry
from makisu_tpu_torch.snapshot.walk import (
    WHITEOUT_META_PREFIX,
    WHITEOUT_PREFIX,
    eval_symlinks,
    remove_all_children,
    tarinfo_from_stat,
    walk,
)
from makisu_tpu_torch.utils import fileio, metrics, mountinfo, pathutils
from makisu_tpu_torch.utils import logging as log
from makisu_tpu_torch.utils.fileio import Owner

_MAX_SYMLINK_DEPTH = 64


@dataclasses.dataclass
class FSDiff:
    """Result of comparing two MemFS trees (the diff command)."""

    missing_in_first: list[str]
    missing_in_second: list[str]
    different: list[tuple[str, tarfile.TarInfo, tarfile.TarInfo]]

    @property
    def empty(self) -> bool:
        return not (self.missing_in_first or self.missing_in_second
                    or self.different)


class Node:
    """One path in the merged view: header + disk source + children."""

    __slots__ = ("src", "dst", "hdr", "children")

    def __init__(self, src: str, dst: str, hdr: tarfile.TarInfo) -> None:
        self.src = src
        self.dst = dst
        self.hdr = hdr
        self.children: dict[str, Node] = {}


def _past_newest_mtime(layer: Layer) -> int | None:
    """One past the newest mtime second among ``layer``'s content headers
    (a whiteout carries none), or None for a layer without any."""
    newest = max((int(e.hdr.mtime) for e in layer.entries.values()
                  if isinstance(e, ContentEntry)), default=None)
    return None if newest is None else newest + 1


class MemFS:
    # The most a commit's os.sync and mtime wait take together: the
    # reference's flat wait, which a layer whose newest mtime second has
    # already passed no longer pays.
    SYNC_WAIT = 1.0
    # Seconds the wait runs past the second after the layer's newest
    # mtime: the kernel stamps files from its coarse clock, which can lag
    # CLOCK_REALTIME by up to one tick.
    MTIME_MARGIN = 0.02

    def __init__(self, root: str,
                 blacklist: list[str] | None = None) -> None:
        os.lstat(root)  # must exist
        self.root = root
        self.blacklist = list(blacklist or [])
        hdr = tarinfo_from_stat(root, "", root)
        hdr.name = ""  # "/" itself never appears in layers
        self.tree = Node(root, "/", hdr)
        self.layers: list[Layer] = []
        # Wall seconds of the last commit's sync + mtime wait and of its
        # diff against the tree (logged with each committed layer; the
        # diff is also the span ``commit.diff``).
        self.sync_seconds = 0.0
        self.diff_seconds = 0.0
        self.mtime_wait_seconds = 0.0  # the wait alone
        # Set by the commit routes before _sync: the epoch second the
        # clock must reach, one past the newest mtime second among the
        # layer's content headers; None when the layer holds none.
        self._wait_past: int | None = None
        # When set (a list), _apply_entry mirrors every applied entry into
        # it: the op stream replay_layer folds back verbatim.
        self._record_ops: list | None = None
        # Applied-layer chain identity: a rolling digest over the layers
        # folded into this tree, in order. A recorded op stream is valid
        # only at the chain position it was recorded at (the ops bake in
        # that tree state's diff outcome), so the session's replay memo
        # keys on (applied_chain, digest). A tar merge that cannot name
        # its layer, or a commit, taints the chain and turns the memo off
        # for this tree.
        self.applied_chain = ""
        self.chain_tainted = False

    def extend_chain(self, digest_hex: str) -> None:
        self.applied_chain = hashlib.sha256(
            (self.applied_chain + digest_hex).encode()).hexdigest()

    # ------------------------------------------------------------------
    # Tree bookkeeping
    # ------------------------------------------------------------------

    def remove(self) -> None:
        """Wipe the on-disk filesystem under root (between stages)."""
        remove_all_children(self.root, self.blacklist)

    def _apply_entry(self, entry: ContentEntry | WhiteoutEntry) -> None:
        """Fold a layer entry into the tree."""
        if self._record_ops is not None:
            self._record_ops.append(entry)
        if isinstance(entry, WhiteoutEntry):
            parts = pathutils.split_path(entry.deleted)
            node = self.tree
            for part in parts[:-1]:
                child = node.children.get(part)
                if child is None:
                    raise FileNotFoundError(
                        f"missing intermediate dir in {entry.deleted}")
                node = child
            if node.children.pop(parts[-1], None) is None:
                log.warning("whiteout of nonexistent path: %s", entry.deleted)
            return
        parts = pathutils.split_path(entry.dst)
        node = self.tree
        for part in parts[:-1]:
            child = node.children.get(part)
            if child is None:
                raise FileNotFoundError(
                    f"missing intermediate directory {part} in {entry.dst}")
            node = child
        new = Node(entry.src, entry.dst, entry.hdr)
        old = node.children.get(parts[-1]) if parts else None
        if old is not None and entry.hdr.isdir():
            new.children = old.children  # replacing a dir keeps its children
        if parts:
            node.children[parts[-1]] = new

    def _lookup(self, dst: str) -> Node | None:
        node = self.tree
        for part in pathutils.split_path(dst):
            node = node.children.get(part)
            if node is None:
                return None
        return node

    def _is_updated(self, dst: str,
                    hdr: tarfile.TarInfo) -> tuple[bool, Node | None]:
        node = self._lookup(dst)
        if node is None:
            return True, None
        return not tario.is_similar_header(node.hdr, hdr), node

    # ------------------------------------------------------------------
    # Layer creation
    # ------------------------------------------------------------------

    def _sync(self) -> None:
        """Flush pending writes, then wait until the clock's second is
        past the newest mtime second of the layer being committed
        (``_wait_past``, plus ``MTIME_MARGIN``): tar's mtimes have
        1-second granularity, so only then does any later write, of the
        same size too, look newer than the headers this commit folds into
        the tree (reference: mem_fs.go sync, :294-311, waits a flat
        second). The os.sync and the wait take at most ``SYNC_WAIT``
        together, so a future-dated file waits no longer than that. The
        wait alone is the span ``commit.mtime_wait``, open on every
        commit, and ``mtime_wait_seconds``; ``sync_seconds`` less it is
        the os.sync."""
        start = time.time()
        try:
            os.sync()
        except (OSError, AttributeError):
            pass
        remaining = 0.0
        with metrics.span("commit.mtime_wait") as span:
            if self._wait_past is not None:
                remaining = min(self._wait_past + self.MTIME_MARGIN,
                                start + self.SYNC_WAIT) - time.time()
            if remaining > 0:
                time.sleep(remaining)
        metrics.counter_add(metrics.COMMIT_MTIME_WAITS,
                            outcome="waited" if remaining > 0 else "skipped")
        self.mtime_wait_seconds = span.duration
        self.sync_seconds = time.time() - start

    def add_layer_by_scan(self, tw: tarfile.TarFile) -> Layer:
        t0 = time.time()
        with metrics.span("commit.diff"):
            layer = self._create_layer_by_scan()
        self.diff_seconds = time.time() - t0
        self._wait_past = _past_newest_mtime(layer)
        self._sync()
        self._commit_layer(layer, tw)
        log.info("created layer by scan: %d entries", len(layer))
        return layer

    def add_layer_by_copy_ops(self, ops: list[CopyOperation],
                              tw: tarfile.TarFile) -> Layer:
        t0 = time.time()
        layer = Layer()
        with metrics.span("commit.diff"):
            for op in ops:
                self._add_copy_to_layer(layer, op)
        self.diff_seconds = time.time() - t0
        self._wait_past = _past_newest_mtime(layer)
        self._sync()
        self._commit_layer(layer, tw)
        log.info("created copy layer: %d entries", len(layer))
        return layer

    def _commit_layer(self, layer: Layer, tw: tarfile.TarFile) -> None:
        t0 = time.monotonic()  # the clock of every other stage
        try:
            with metrics.span("commit.tar_write"):
                layer.commit(tw)
        finally:
            metrics.stage_busy_add("tar_write", time.monotonic() - t0)
        metrics.counter_add(metrics.COMMIT_ENTRIES, len(layer))
        # The commit folded entries into the tree without a chain key
        # (its digest exists only afterwards): later cached applications
        # on this tree must bypass the replay memo.
        self.chain_tainted = True
        self.layers.append(layer)

    def _create_layer_by_scan(self) -> Layer:
        layer = Layer()

        def visit(path: str, st: os.stat_result) -> None:
            dst = pathutils.trim_root(path, self.root)
            hdr = tarinfo_from_stat(path, pathutils.rel_path(dst), self.root,
                                    st)
            self._maybe_add(layer, path, dst, hdr, create_whiteouts=True)

        walk(self.root, self.blacklist, visit)
        return layer

    def _maybe_add(self, layer: Layer, src: str, dst: str,
                   hdr: tarfile.TarInfo, create_whiteouts: bool) -> None:
        """Add ``dst`` to the layer if its header differs from the tree;
        optionally emit whiteouts for tree children gone from disk."""
        updated, node = self._is_updated(dst, hdr)
        if updated and dst != "/":
            self._add_ancestors(layer, dst, inclusive=False)
            self._apply_entry(layer.add_header(src, dst, hdr))
        if create_whiteouts and hdr.isdir() and node is not None:
            for child in list(node.children.values()):
                # Existence is judged at the child's logical path under
                # the build root — not entry.src, which for copy-op
                # entries points at the (still-existing) context file.
                disk = pathutils.join_root(self.root, child.dst)
                if not os.path.lexists(disk):
                    self._add_ancestors(layer, child.dst, inclusive=False)
                    entry = layer.add_whiteout(child.dst)
                    self._apply_entry(entry)

    def _add_ancestors(self, layer: Layer, dst: str, inclusive: bool,
                       uid: int = 0, gid: int = 0, depth: int = 0) -> str:
        """Record every ancestor of ``dst`` into the layer (docker tars
        carry parent dirs of each entry), resolving in-tree symlinks, and
        synthesize missing intermediate directories. Returns the resolved
        destination path."""
        if depth >= _MAX_SYMLINK_DEPTH:
            raise OSError(f"symlink loop resolving {dst}")
        parts = pathutils.split_path(dst)
        end = len(parts) if inclusive else len(parts) - 1
        node = self.tree
        last_dir = self.tree
        i = 0
        while i < end:
            child = node.children.get(parts[i])
            if child is None:
                break
            # Skip the re-add when this exact ancestor entry is already
            # in the layer (every descendant repeats its whole chain;
            # on a cold scan that is O(depth) redundant header work).
            existing = layer.entries.get(child.dst)
            if not (isinstance(existing, ContentEntry)
                    and existing.hdr is child.hdr):
                self._apply_entry(
                    layer.add_header(child.src, child.dst, child.hdr))
            if child.hdr.isdir():
                node = child
                last_dir = child
                i += 1
            elif child.hdr.issym():
                target = child.hdr.linkname
                if not os.path.isabs(target):
                    target = os.path.join(
                        os.path.dirname(child.dst), target)
                target = pathutils.abs_path(
                    os.path.join(target, *parts[i + 1:]))
                return self._add_ancestors(
                    layer, target, inclusive, uid, gid, depth + 1)
            else:
                break  # plain file mid-path; nothing to descend into
        for j in range(i, end):
            cur = "/" + "/".join(parts[:j + 1])
            hdr = tarfile.TarInfo(pathutils.rel_path(cur))
            hdr.type = tarfile.DIRTYPE
            hdr.mode = last_dir.hdr.mode
            # Epoch mtime, not the wall clock: a synthesized ancestor
            # (e.g. /app for COPY . /app/) exists in no source tree, so
            # any live timestamp would make two builds of identical
            # inputs differ whenever they straddle a second boundary —
            # silently breaking the byte-reproducibility COPY layers
            # promise (and cache/dedup identity with it). Same policy
            # as heredoc-generated files (steps/add_copy.py).
            hdr.mtime = 0
            hdr.uid = uid
            hdr.gid = gid
            self._apply_entry(layer.add_header("", cur, hdr))
        return dst

    def _add_copy_to_layer(self, layer: Layer, op: CopyOperation) -> None:
        create_dst = True
        if len(op.srcs) == 1:
            only = pathutils.join_root(op.src_root, op.srcs[0])
            if not os.path.isdir(only):  # follows symlinks
                create_dst = False
        dst = op.dst
        if create_dst:
            resolved = self._add_ancestors(
                layer, pathutils.abs_path(dst), inclusive=True,
                uid=op.uid, gid=op.gid)
            dst = resolved if resolved.endswith("/") else resolved + "/"
        for rel_src in op.srcs:
            rel_src = eval_symlinks(rel_src, op.src_root)
            src = pathutils.join_root(op.src_root, rel_src)

            def visit(cur: str, st: os.stat_result,
                      src=src, dst=dst) -> None:
                if cur == src:
                    if os.path.isdir(cur) and not os.path.islink(cur):
                        return  # dir contents copy into dst, not dir itself
                    if not dst.endswith("/"):
                        cur_dst = dst
                    else:
                        cur_dst = os.path.join(dst, os.path.basename(src))
                else:
                    cur_dst = os.path.join(dst, cur[len(src):].lstrip("/"))
                hdr = tarinfo_from_stat(
                    cur, pathutils.rel_path(cur_dst), self.root, st)
                if op.preserve_owner:
                    pass  # keep source owners (--archive)
                else:
                    hdr.uid = op.uid
                    hdr.gid = op.gid
                self._maybe_add(layer, cur, pathutils.abs_path(cur_dst), hdr,
                                create_whiteouts=False)

            # Same blacklist policy as the on-disk Copier (copy_op.py
            # _copier): external copies prune blacklisted sources —
            # incl. .dockerignore exclusions — internal (--from) copies
            # see everything in their sandbox.
            walk(src, None if op.internal else op.blacklist, visit)

    # ------------------------------------------------------------------
    # Tar merging / untarring
    # ------------------------------------------------------------------

    def update_from_tar_path(self, source: str, untar: bool) -> Layer:
        """Merge a layer blob (gzip or zstd) from a file."""
        with open(source, "rb") as f:
            with tario.gzip_reader(f) as gz:
                with tarfile.open(fileobj=gz, mode="r|") as tf:
                    return self.update_from_tar(tf, untar)

    def update_from_tar(self, tf: tarfile.TarFile, untar: bool,
                        record: list | None = None,
                        chain_key: str | None = None) -> Layer:
        """Merge one layer tar into the tree; ``untar`` also materializes
        it on disk. Hardlinks apply in a second pass (their targets may
        appear later in the tar); parent-directory mtimes are restored
        after extraction.

        ``record`` (a list to fill) captures the entry stream this
        application folded into the tree, the input ``replay_layer``
        takes, so a resident session can apply the layer again without
        inflating the blob. ``chain_key`` names the layer (its blob
        digest) for the applied-chain identity; a merge that names none
        taints the chain (the diff and extract flows, which never consult
        the memo)."""
        layer = Layer()
        hardlinks: list[tuple[str, tarfile.TarInfo]] = []
        parent_mtimes: dict[str, float] = {}
        if record is not None:
            self._record_ops = record
        try:
            for hdr in tf:
                hdr.name = pathutils.rel_path(hdr.name)
                disk_path = pathutils.join_root(self.root, hdr.name)
                if self._skip_tar_member(disk_path, hdr):
                    continue
                if untar:
                    parent = os.path.dirname(disk_path)
                    if parent not in parent_mtimes:
                        parent_mtimes[parent] = os.lstat(parent).st_mtime
                if hdr.islnk():
                    hdr.linkname = pathutils.abs_path(hdr.linkname)
                    hardlinks.append((disk_path, hdr))
                    continue
                if untar:
                    self._untar_one(disk_path, hdr, tf)
                self._maybe_add(layer, disk_path,
                                pathutils.abs_path(hdr.name),
                                hdr, create_whiteouts=False)
            for disk_path, hdr in hardlinks:
                if untar:
                    self._untar_one(disk_path, hdr, None)
                self._maybe_add(layer, disk_path,
                                pathutils.abs_path(hdr.name),
                                hdr, create_whiteouts=False)
        finally:
            self._record_ops = None
        for parent, mtime in parent_mtimes.items():
            os.utime(parent, (mtime, mtime))
        if chain_key is not None:
            self.extend_chain(chain_key)
        else:
            self.chain_tainted = True
        self.layers.append(layer)
        return layer

    def replay_layer(self, ops: list, chain_key: str = "") -> Layer:
        """Fold a recorded applied-entry stream into the tree: the tree
        mutations ``update_from_tar(..., untar=False)`` made from the
        blob, with no inflate, no tar parse and no per-entry diff (the
        record is the diff outcome, valid because the replay happens at
        the same chain position over the same prior tree, which the
        session's (applied_chain, digest) key guarantees)."""
        layer = Layer()
        for entry in ops:
            self._apply_entry(entry)
        if chain_key:
            self.extend_chain(chain_key)
        self.layers.append(layer)
        return layer

    def _skip_tar_member(self, disk_path: str, hdr: tarfile.TarInfo) -> bool:
        base = os.path.basename(disk_path)
        if base.startswith(WHITEOUT_META_PREFIX):
            return True
        if pathutils.is_descendant_of_any(disk_path, self.blacklist):
            return True
        if hdr.ischr() or hdr.isblk() or hdr.isfifo():
            return True
        return mountinfo.is_mounted(disk_path)

    def _untar_one(self, path: str, hdr: tarfile.TarInfo,
                   tf: tarfile.TarFile | None) -> None:
        base = os.path.basename(path)
        if base.startswith(WHITEOUT_PREFIX):
            victim = os.path.join(
                os.path.dirname(path), base[len(WHITEOUT_PREFIX):])
            if os.path.lexists(victim):
                if os.path.isdir(victim) and not os.path.islink(victim):
                    shutil.rmtree(victim, ignore_errors=True)
                else:
                    os.remove(victim)
            return
        if os.path.lexists(path):
            local = tarinfo_from_stat(path, hdr.name, self.root)
            if tario.is_similar_header(local, hdr):
                return
            if hdr.isdir() and local.isdir():
                # Never delete an existing dir (it may shelter mounts);
                # just update its metadata.
                tario.apply_header(path, hdr)
                return
            if os.path.isdir(path) and not os.path.islink(path):
                shutil.rmtree(path)
            else:
                os.remove(path)
        if hdr.isdir():
            os.makedirs(path, exist_ok=True)
            tario.apply_header(path, hdr)
        elif hdr.issym():
            target = hdr.linkname
            if os.path.isabs(target):
                target = pathutils.join_root(self.root, target)
            os.symlink(target, path)
            try:
                os.lchown(path, hdr.uid, hdr.gid)
            except PermissionError:
                pass
        elif hdr.islnk():
            os.link(pathutils.join_root(self.root, hdr.linkname), path)
        else:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as out:
                if tf is not None and hdr.size > 0:
                    reader = tf.extractfile(hdr)
                    if reader is not None:
                        shutil.copyfileobj(reader, out)
            tario.apply_header(path, hdr)

    # ------------------------------------------------------------------
    # Cross-stage checkpoint / diff
    # ------------------------------------------------------------------

    def checkpoint(self, new_root: str, sources: list[str]) -> None:
        """Copy ``sources`` (globs, stage-root-relative) into ``new_root``
        preserving their paths — the sandbox the next stage's COPY --from
        reads (reference: mem_fs.go Checkpoint:91)."""
        if not sources:
            return
        resolved: list[str] = []
        for src in sources:
            # Sources are logical stage paths; map them under the build
            # root (identity in production where root is "/").
            pattern = pathutils.join_root(self.root, src)
            matches = glob(pattern)
            resolved.extend(matches or [pattern])
        for src in resolved:
            trimmed = pathutils.trim_root(src, self.root)
            dst = pathutils.join_root(new_root, trimmed)
            st = os.lstat(src)
            copier = fileio.Copier(
                self.blacklist,
                dir_owner=Owner(st.st_uid, st.st_gid, False))
            if os.path.isdir(src) and not os.path.islink(src):
                copier.copy_dir(src, dst)
            else:
                copier.copy_file(src, dst)

    def compare(self, other: "MemFS", ignore_mtime: bool = True) -> FSDiff:
        """Paths only in one tree, and paths whose headers differ."""
        diff = FSDiff([], [], [])

        def rec(a: Node | None, b: Node | None, path: str) -> None:
            if a is None:
                diff.missing_in_first.append(path)
                return
            if b is None:
                diff.missing_in_second.append(path)
                return
            if path != "/" and not tario.is_similar_header(
                    a.hdr, b.hdr, ignore_time=ignore_mtime):
                diff.different.append((path, a.hdr, b.hdr))
            for name in sorted(set(a.children) | set(b.children)):
                rec(a.children.get(name), b.children.get(name),
                    os.path.join(path, name))

        rec(self.tree, other.tree, "/")
        return diff
