"""ADD/COPY steps: content-addressed cache IDs and copy operations.

Copy of ``makisu_tpu/steps/add_copy.py`` with the stat-keyed content-ID
cache (``utils/statcache.py``: a file whose stat is unchanged is not
read again) and the resident session's scan memo. Each step's walk
logs one tally of its stat-cache hits, misses, bytes re-read and
sources replayed from the scan memo, and records it once as the
reference does: the ``makisu_statcache_total`` counters and a
``statcache`` decision on the ledger, with the changed files as blame.
Reference:
lib/builder/step/add_copy_step.go (cache ID over walked file contents
SetCacheID:102, glob resolution resolveFromPaths:171, Execute :126-150
building snapshot.CopyOperation) and add_step.go (ADD is COPY
without --from; the reference implements no URL/auto-extract support).
"""

from __future__ import annotations

import os
import stat as statmod
import zlib
from glob import glob

from makisu_tpu_torch.context import BuildContext
from makisu_tpu_torch.snapshot import CopyOperation, eval_symlinks
from makisu_tpu_torch.steps.base import BuildStep
from makisu_tpu_torch.utils import ledger, metrics, pathutils, sysutils
from makisu_tpu_torch.utils import logging as log

# Changed-file paths carried per statcache ledger decision (the blame
# list ``explain`` prints); beyond it only the count grows.
_BLAME_KEEP = 20


class AddCopyStep(BuildStep):
    def __init__(self, directive: str, args: str, chown: str,
                 from_stage: str, srcs: list[str], dst: str,
                 commit: bool, preserve_owner: bool,
                 inline_files: list[tuple[str, str]] | None = None,
                 ordered_sources: list[tuple[str, str]] | None = None,
                 ) -> None:
        super().__init__(args, commit)
        self.directive = directive
        self.chown = chown
        self.from_stage = from_stage
        self.srcs = [s.strip("\"'") for s in srcs]
        self.dst = dst.strip("\"'")
        self.preserve_owner = preserve_owner
        # Heredoc file sources (BuildKit syntax 1.4): (name, content)
        # staged as real files at execute time, then copied with normal
        # docker semantics (a single inline file renames onto a file
        # dst; multiple require a directory dst like any other source).
        self.inline_files = list(inline_files or [])
        # Left-to-right source order (("src", path) | ("inline", name)):
        # docker applies sources in order, so later ones overwrite
        # earlier on name collisions. Default (direct construction in
        # tests): real sources then inline.
        self.ordered_sources = (list(ordered_sources)
                                if ordered_sources is not None else
                                [("src", s) for s in self.srcs]
                                + [("inline", n)
                                   for n, _ in self.inline_files])
        if len(self.srcs) + len(self.inline_files) > 1 and not (
                self.dst.endswith("/") or self.dst in (".", "..")):
            raise ValueError(
                'copying multiple sources: destination must end with "/"')

    def require_on_disk(self) -> bool:
        return bool(self.chown)

    def context_dirs(self) -> tuple[str, list[str]]:
        if not self.from_stage:
            return "", []
        return self.from_stage, list(self.srcs)

    def _source_root(self, ctx: BuildContext) -> str:
        if self.from_stage:
            return ctx.copy_from_root(self.from_stage)
        return ctx.context_dir

    def _resolve_sources(self, ctx: BuildContext,
                         srcs: list[str] | None = None) -> list[str]:
        """Glob-expand sources against the source root (absolute paths).
        Context sources matching .dockerignore are invisible — the same
        "never entered the context" semantics docker gives them."""
        root = self._source_root(ctx)
        check_ignore = not self.from_stage
        out: list[str] = []
        for src in (self.srcs if srcs is None else srcs):
            pattern = os.path.join(root, pathutils.rel_path(src))
            matches = glob(pattern)
            if check_ignore:
                visible = [m for m in matches
                           if not ctx.context_path_ignored(m)]
                if matches and not visible:
                    # Everything the pattern named is dockerignored:
                    # fail like docker does, not with an empty copy or
                    # an unexpanded-pattern stat error downstream.
                    raise ValueError(
                        f"COPY/ADD source {src!r}: all matches are "
                        "excluded by .dockerignore")
                matches = visible
            out.extend(sorted(matches) if matches else [pattern])
        return out

    def set_cache_id(self, ctx: BuildContext, seed: str) -> None:
        """Content-addressed: the cache ID covers the bytes being copied,
        so a context change invalidates exactly the right steps."""
        checksum = zlib.crc32(
            (seed + self.directive + self.args).encode())
        # Stat-cache tally of this step's context walk: files whose
        # content ID came from the cache, and why the others were read.
        # A source replayed from the session's scan memo counts its
        # files as hits and itself in memo_sources.
        tally = {"files": 0, "hits": 0, "bytes_rehashed": 0,
                 "misses_by_reason": {}, "memo_sources": 0,
                 "changed": []}
        if not self.from_stage:
            # Cross-stage copies rely on chained stage cache IDs instead.
            for source in self._resolve_sources(ctx):
                checksum = self._checksum_source(ctx, source, checksum,
                                                 tally)
        for name, content in self.inline_files:
            # Inline heredoc files are content too (their bodies carry
            # substituted build args, so identity must track them).
            # Length-framed: bare concatenation would let different
            # (name, content) partitions with equal concatenations
            # collide into one cache ID.
            frame = f"{len(name)}:{len(content)}:".encode()
            checksum = zlib.crc32(frame, checksum)
            checksum = zlib.crc32(name.encode(), checksum)
            checksum = zlib.crc32(content.encode(), checksum)
        self.cache_id = format(checksum & 0xFFFFFFFF, "x")
        if tally["files"]:
            log.info("stat cache for %s %s: %d of %d context files hit",
                     self.directive, self.cache_id, tally["hits"],
                     tally["files"], directive=self.directive,
                     files=tally["files"], hits=tally["hits"],
                     misses=tally["files"] - tally["hits"],
                     misses_by_reason=tally["misses_by_reason"],
                     bytes_rehashed=tally["bytes_rehashed"],
                     memo_sources=tally["memo_sources"])
            self._record_stat_tally(tally)

    def _record_stat_tally(self, tally: dict) -> None:
        """Flush the walk's tally once per step, never per file: the
        counters and the step's statcache decision against its cache
        ID."""
        misses = tally["files"] - tally["hits"]
        if tally["hits"]:
            metrics.counter_add("makisu_statcache_total", tally["hits"],
                                result="hit")
        if misses:
            metrics.counter_add("makisu_statcache_total", misses,
                                result="miss")
        ledger.record(
            "statcache", self.cache_id, "hit" if not misses else "miss",
            directive=self.directive, files=tally["files"],
            hits=tally["hits"], misses=misses,
            bytes_rehashed=tally["bytes_rehashed"],
            changed_files=list(tally["changed"]))

    def _checksum_source(self, ctx: BuildContext, source: str,
                         checksum: int, tally: dict) -> int:
        """One resolved source subtree's checksum contribution, with the
        resident session's scan memo in front: when the dirty set proves
        nothing under ``source`` changed, the memoized ``(source,
        checksum_in) -> checksum_out`` transition replays with no stat,
        no listdir and no crc framing. A dirty (or unproven) source walks
        and refreshes the memo, so the cache ID is the same either way."""
        session = ctx.session
        if session is not None and ctx.source_unchanged(source):
            memo = session.scan_lookup(source, checksum)
            if memo is not None:
                checksum_out, files, _nbytes = memo
                tally["files"] += files
                tally["hits"] += files
                tally["memo_sources"] += 1
                return checksum_out
        files_before = tally["files"]
        out = self._checksum_tree(ctx, source, checksum, tally)
        if session is not None:
            session.scan_store(source, checksum, out,
                               tally["files"] - files_before, 0)
        return out

    def _checksum_tree(self, ctx: BuildContext, path: str,
                       checksum: int, tally: dict) -> int:
        try:
            st = os.lstat(path)
        except OSError:
            return checksum  # vanished/unstatable: same as lexists=False
        if ctx.context_path_ignored(path):
            # Ignored files must not influence cache identity either —
            # editing them cannot change the build's output.
            return checksum
        if sysutils.is_special_file(st):
            return checksum
        rel = os.path.relpath(path, ctx.context_dir)
        checksum = zlib.crc32(rel.encode(), checksum)
        mode = st.st_mode
        if statmod.S_ISLNK(mode):
            return zlib.crc32(os.readlink(path).encode(), checksum)
        if statmod.S_ISDIR(mode):
            for name in sorted(os.listdir(path)):
                checksum = self._checksum_tree(
                    ctx, os.path.join(path, name), checksum, tally)
            return checksum
        # Per-file content summary (size and content crc32), framed into
        # the rolling checksum exactly as makisu_tpu frames it. The
        # summary, not the byte stream, chains, so the crc can come from
        # the stat cache: the same cache IDs either way.
        file_crc, why = ctx.content_ids.lookup(rel, st)
        tally["files"] += 1
        if why == "hit":
            tally["hits"] += 1
        else:
            reasons = tally["misses_by_reason"]
            reasons[why] = reasons.get(why, 0) + 1
            tally["bytes_rehashed"] += st.st_size
            # Blame only real changes: a racy or disabled re-read costs
            # time but changed nothing, and must not name a file.
            if (why in ("absent", "stat_changed")
                    and len(tally["changed"]) < _BLAME_KEEP):
                tally["changed"].append(rel)
            file_crc = 0
            with open(path, "rb") as f:
                while chunk := f.read(1 << 20):
                    file_crc = zlib.crc32(chunk, file_crc)
            ctx.content_ids.put(rel, st, file_crc)
        frame = f"{st.st_size}:{file_crc & 0xFFFFFFFF:08x};".encode()
        return zlib.crc32(frame, checksum)

    def _stage_inline_files(self, ctx: BuildContext) -> str:
        """Write heredoc bodies as real files in the build sandbox (they
        must outlive execute: the MemFS copy-op diff reads file bytes at
        commit time). The staging dir is keyed by cache_id so steps
        never collide. UTF-8 explicitly — cache identity hashed
        content.encode(), the bytes on disk must match regardless of
        host locale."""
        stage_dir = os.path.join(ctx.image_store.sandbox_dir,
                                 "heredocs", self.cache_id or "x")
        os.makedirs(stage_dir, exist_ok=True)
        for name, content in self.inline_files:
            path = os.path.join(stage_dir, name)
            with open(path, "w", encoding="utf-8") as f:
                f.write(content)
            os.chmod(path, 0o644)
            # Epoch mtime: generated files carry no meaningful
            # timestamp, and a deterministic one makes heredoc layers
            # byte-reproducible across rebuilds (a live mtime would
            # change the layer tar's bytes every build) AND keeps the
            # header-similarity diff from ever confusing a staged file
            # with a same-sized real source written the same second.
            os.utime(path, (0, 0))
        return stage_dir

    def execute(self, ctx: BuildContext, modify_fs: bool) -> None:
        blacklist = list(ctx.base_blacklist) + [ctx.image_store.root]
        stage_dir = (self._stage_inline_files(ctx)
                     if self.inline_files else "")
        # One CopyOperation per consecutive run of same-kind sources,
        # in the line's left-to-right order: docker applies sources in
        # order, so a later source overwrites an earlier one on a name
        # collision — real files and inline heredocs interleave.
        runs: list[tuple[str, list[str]]] = []
        for kind, val in self.ordered_sources:
            if runs and runs[-1][0] == kind:
                runs[-1][1].append(val)
            else:
                runs.append((kind, [val]))
        if not runs:
            runs = [("src", [])]  # preserve empty-sources error path
        inline_contents = dict(self.inline_files)
        for kind, vals in runs:
            if kind == "src":
                source_root = self._source_root(ctx)
                rel_paths = [
                    pathutils.trim_root(s, source_root)
                    for s in self._resolve_sources(ctx, srcs=vals)]
                ctx_blacklist = list(blacklist)
                if not self.from_stage:
                    # .dockerignore exclusions ride the blacklist, which
                    # both the on-disk Copier and the MemFS copy-op diff
                    # honor.
                    ctx_blacklist += ctx.context_excluded_paths()
                op = CopyOperation(
                    rel_paths, source_root, self.logical_working_dir,
                    self.dst, chown=self.chown, blacklist=ctx_blacklist,
                    internal=bool(self.from_stage),
                    preserve_owner=self.preserve_owner)
            else:
                assert all(v in inline_contents for v in vals)
                op = CopyOperation(
                    vals, stage_dir, self.logical_working_dir, self.dst,
                    chown=self.chown, blacklist=blacklist,
                    internal=True, preserve_owner=self.preserve_owner)
            ctx.copy_ops.append(op)
            if modify_fs:
                op.execute(eval_symlinks, ctx.root_dir)


class AddStep(AddCopyStep):
    def __init__(self, args: str, chown: str, srcs: list[str], dst: str,
                 commit: bool, preserve_owner: bool,
                 inline_files: list[tuple[str, str]] | None = None,
                 ordered_sources: list[tuple[str, str]] | None = None,
                 ) -> None:
        super().__init__("ADD", args, chown, "", srcs, dst, commit,
                         preserve_owner, inline_files, ordered_sources)


class CopyStep(AddCopyStep):
    def __init__(self, args: str, chown: str, from_stage: str,
                 srcs: list[str], dst: str, commit: bool,
                 preserve_owner: bool,
                 inline_files: list[tuple[str, str]] | None = None,
                 ordered_sources: list[tuple[str, str]] | None = None,
                 ) -> None:
        super().__init__("COPY", args, chown, from_stage, srcs, dst, commit,
                         preserve_owner, inline_files, ordered_sources)
