"""buildNode: per-step build lifecycle.

Copy of ``makisu_tpu/builder/node.py``: a cached layer is replayed from
the resident session's memo, or applied from the uncompressed tar
stream that the cache manager hands out, blob or chunks (reference:
lib/builder/build_node.go —
Build:62-100, doCommit:102, applyLayer:133, push/pullCacheLayer:151-181).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import tarfile

from makisu_tpu_torch.cache.manager import CacheMiss
from makisu_tpu_torch.context import BuildContext
from makisu_tpu_torch.docker.image import DigestPair, ImageConfig
from makisu_tpu_torch.steps import BuildStep
from makisu_tpu_torch.utils import logging as log
from makisu_tpu_torch.utils import metrics


@dataclasses.dataclass
class NodeOptions:
    skip_build: bool = False
    force_commit: bool = False
    modify_fs: bool = False

    def __str__(self) -> str:
        parts = [name for name, on in (
            ("skip", self.skip_build), ("commit", self.force_commit),
            ("modifyfs", self.modify_fs)) if on]
        return ",".join(parts)


class BuildNode:
    def __init__(self, ctx: BuildContext, step: BuildStep) -> None:
        self.ctx = ctx
        self.step = step
        self.digest_pairs: list[DigestPair] | None = None  # None = uncached

    def __str__(self) -> str:
        return str(self.step)

    @property
    def cache_id(self) -> str:
        return self.step.cache_id

    def has_commit(self) -> bool:
        return self.step.has_commit()

    def build(self, cache_mgr, prev_config: ImageConfig | None,
              opts: NodeOptions) -> ImageConfig:
        self.step.apply_ctx_and_config(self.ctx, prev_config)
        cached = self.digest_pairs is not None
        if cached:
            for pair in self.digest_pairs:
                self._apply_layer(cache_mgr, pair, opts.modify_fs)
        if opts.skip_build:
            log.info("skipping execution; a later step was cached")
        elif cached:
            log.info("skipping execution; cache was applied")
        else:
            self.step.execute(self.ctx, opts.modify_fs)
            if self.step.has_commit() or opts.force_commit:
                self._do_commit(cache_mgr)
            else:
                log.info("not committing step %s", self.step)
        return self.step.update_ctx_and_config(self.ctx, prev_config)

    def _do_commit(self, cache_mgr) -> None:
        self.digest_pairs = self.step.commit(self.ctx)
        # Multi-layer commits (FROM of a copied-from stage) cannot map to
        # one cache entry; skip the cache for those.
        if len(self.digest_pairs) > 1:
            return
        pair = self.digest_pairs[0] if self.digest_pairs else None
        commit = self.step.layer_commits[-1] if self.step.layer_commits else None
        log.info("pushing cache id %s", self.cache_id)
        cache_mgr.push_cache(self.cache_id, pair, commit)

    def _apply_layer(self, cache_mgr, pair: DigestPair,
                     modify_fs: bool) -> None:
        hex_digest = pair.gzip_descriptor.digest.hex()
        # Resident-session fast path: a layer this session already folded
        # into a tree at this exact chain position replays from its
        # recorded entry stream: no blob or chunk open, no inflate, no tar
        # parse, no per-entry diff. The memo keys on (applied chain,
        # digest): the ops bake in the prior tree's diff outcome, so the
        # same blob at another position (a reordered Dockerfile) records
        # afresh. Only for in-memory application (modify_fs must reach
        # the disk), and only on an untainted chain (every prior layer
        # named itself).
        memfs = self.ctx.memfs
        session = self.ctx.session
        memo_ok = (session is not None and not modify_fs
                   and not memfs.chain_tainted)
        if memo_ok:
            memo_key = (memfs.applied_chain, hex_digest)
            ops = session.replay_lookup(memo_key)
            if ops is not None:
                log.info("replaying resident layer %s (%d entries)",
                         hex_digest[:12], len(ops))
                with metrics.span("apply_layer",
                                  digest=hex_digest[:12], replay=True):
                    memfs.replay_layer(ops, chain_key=hex_digest)
                metrics.counter_add(metrics.CACHED_LAYERS_APPLIED_TOTAL)
                return
        log.info("applying cached layer %s (unpack=%s)", hex_digest,
                 modify_fs)
        record = [] if memo_ok else None
        # With chunk dedup attached, a layer whose blob is not local
        # streams straight from its chunks (no blob, no inflate).
        with metrics.span("apply_layer", digest=hex_digest[:12]):
            open_tar = getattr(cache_mgr, "open_layer_tar", None)
            if open_tar is not None:
                stream = open_tar(pair)
            else:
                stream = self._open_local_blob(hex_digest)
            with stream as tar_stream:
                with tarfile.open(fileobj=tar_stream, mode="r|") as tf:
                    memfs.update_from_tar(tf, untar=modify_fs,
                                          record=record,
                                          chain_key=hex_digest)
        # After the span: a failed application does not count.
        metrics.counter_add(metrics.CACHED_LAYERS_APPLIED_TOTAL)
        if record is not None:
            session.replay_store(memo_key, record)

    @contextlib.contextmanager
    def _open_local_blob(self, hex_digest: str):
        with self.ctx.image_store.layers.open(hex_digest) as f:
            with gzip.GzipFile(fileobj=f, mode="rb") as gz:
                yield gz

    def pull_cache_layer(self, cache_mgr) -> bool:
        """Try to prefetch this node's layer. A miss or failure returns
        False and breaks the stage's prefetch chain; the EMPTY sentinel
        (None) continues it (reference :166-181)."""
        try:
            pair = cache_mgr.pull_cache(self.cache_id)
        except CacheMiss:
            return False
        except Exception as e:  # noqa: BLE001 - a failed lookup is a miss
            log.error("failed to fetch cache layer %s: %s", self.cache_id, e)
            return False
        if pair is None:
            self.digest_pairs = []  # sentinel: counts as fetched, no layer
            return True
        self.digest_pairs = [pair]
        return True
