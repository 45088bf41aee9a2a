"""BuildContext: shared state threaded through steps of one stage.

Copy of ``makisu_tpu/context.py`` (reference:
lib/context/build_context.go:35-88) with the ``hasher`` seam every
committed layer streams through, and the stat-keyed content-ID cache
(``utils/statcache.py``) that lets a warm build skip re-reading
unchanged context files. A resident build session
(``worker/session.py``) arms a context with the dirty set of the paths
that changed since the last build of the same context.
"""

from __future__ import annotations

import base64
import os

from makisu_tpu_torch.chunker import CPUHasher, Hasher
from makisu_tpu_torch.snapshot import MemFS
from makisu_tpu_torch.storage import ImageStore
from makisu_tpu_torch.utils import pathutils
from makisu_tpu_torch.utils.statcache import ContentIDCache

_STAGES_DIR = "stages"


class BuildContext:
    def __init__(self, root_dir: str, context_dir: str,
                 image_store: ImageStore,
                 hasher: Hasher | None = None,
                 blacklist: list[str] | None = None,
                 gzip_backend_id: str | None = None) -> None:
        self.root_dir = root_dir
        self.context_dir = context_dir
        self.image_store = image_store
        self.stage_vars: dict[str, str] = {}
        self.copy_ops = []
        self.must_scan = False
        # Per-build process environment for RUN steps. ARG/ENV exports
        # land here, never in os.environ. Each stage starts from the
        # snapshot taken at build start.
        self._base_env: dict[str, str] = dict(os.environ)
        self.exec_env: dict[str, str] = dict(self._base_env)
        # Per-build compression identity (tario.make_backend_id); None
        # is the process default.
        self.gzip_backend_id = gzip_backend_id
        self.hasher = hasher or CPUHasher()
        self.stages_dir = os.path.join(image_store.sandbox_dir, _STAGES_DIR)
        os.makedirs(self.stages_dir, exist_ok=True)
        if blacklist is None:
            blacklist = list(pathutils.DEFAULT_BLACKLIST)
        # Without the build-internal dirs: copy-op sources legitimately
        # live in the context dir, so steps extend this base themselves.
        self.base_blacklist = list(blacklist)
        self.blacklist = blacklist + [context_dir, image_store.root]
        self.memfs = MemFS(root_dir, self.blacklist)
        # .dockerignore: the excluded path set is computed lazily on the
        # first context COPY/ADD and cached for the build.
        self._ignore_excluded: list[str] | None = None
        self._ignore_prefixes = None  # PrefixSet over _ignore_excluded
        # Stat-keyed content-ID cache: warm builds skip re-reading
        # context files whose stat is unchanged. Lives in the storage dir
        # beside the KV cache, in makisu_tpu's format; BuildPlan.execute
        # saves it.
        self.content_ids = ContentIDCache(
            os.path.join(image_store.root, "content_id_cache.json"),
            namespace=os.path.abspath(context_dir))
        # Resident build session, armed by session.begin_build:
        # dirty_paths holds the context paths that changed since the last
        # build of this context, dirty_exact says whether that set
        # provably covers every change (only then may a scan be skipped).
        self.session = None
        self.dirty_paths: frozenset[str] = frozenset()
        self.dirty_exact = False

    def source_unchanged(self, path: str) -> bool:
        """True when the resident session proves nothing under ``path``
        changed since the last build: the dirty set is exact and no dirty
        path is ``path``, below it, or an ancestor of it (a renamed parent
        dirties every source inside it even when the watcher evented only
        the parent). The gate of every scan-memo shortcut: when it is
        False, the full walk runs."""
        if not self.dirty_exact:
            return False
        prefix = path.rstrip("/") + "/"
        for dirty in self.dirty_paths:
            if (dirty == path or dirty.startswith(prefix)
                    or prefix.startswith(dirty.rstrip("/") + "/")):
                return False
        return True

    def context_excluded_paths(self) -> list[str]:
        """Absolute context paths excluded by .dockerignore (empty when
        the file is absent)."""
        if self._ignore_excluded is None:
            from makisu_tpu_torch.utils.dockerignore import (
                DockerIgnore,
                PrefixSet,
            )
            ignore = DockerIgnore.load(self.context_dir)
            self._ignore_excluded = (
                ignore.excluded_paths(self.context_dir) if ignore else [])
            self._ignore_prefixes = PrefixSet(self._ignore_excluded)
            if self._ignore_excluded:
                from makisu_tpu_torch.utils import logging as log
                log.info(".dockerignore excludes %d context paths",
                         len(self._ignore_excluded))
        return self._ignore_excluded

    def context_path_ignored(self, path: str) -> bool:
        """O(log n) .dockerignore probe (the checksum/copy walks call
        this once per context path)."""
        self.context_excluded_paths()
        return self._ignore_prefixes.covers(path)

    def copy_from_root(self, alias: str) -> str:
        """Sandbox dir holding stage ``alias``'s checkpointed files for
        COPY --from (reference: CopyFromRoot build_context.go:83)."""
        dirname = base64.urlsafe_b64encode(alias.encode()).decode()
        return os.path.join(self.stages_dir, dirname)

    def new_stage_context(self) -> "BuildContext":
        """Fresh per-stage context sharing the store and root (the MemFS
        restarts empty each stage)."""
        ctx = BuildContext.__new__(BuildContext)
        ctx.root_dir = self.root_dir
        ctx.context_dir = self.context_dir
        ctx.image_store = self.image_store
        ctx.stage_vars = {}
        ctx.copy_ops = []
        ctx.must_scan = False
        ctx._base_env = self._base_env
        ctx.exec_env = dict(self._base_env)
        ctx.gzip_backend_id = self.gzip_backend_id
        ctx.hasher = self.hasher
        ctx.stages_dir = self.stages_dir
        ctx.base_blacklist = self.base_blacklist
        ctx.blacklist = self.blacklist
        ctx.memfs = MemFS(self.root_dir, self.blacklist)
        ctx._ignore_excluded = self._ignore_excluded
        ctx._ignore_prefixes = self._ignore_prefixes
        # Shared, not fresh: stages hash the same context files, and the
        # plan saves the base context's cache once at the end.
        ctx.content_ids = self.content_ids
        # So is the session: every stage scans the same context tree
        # under the same dirty set.
        ctx.session = self.session
        ctx.dirty_paths = self.dirty_paths
        ctx.dirty_exact = self.dirty_exact
        return ctx
