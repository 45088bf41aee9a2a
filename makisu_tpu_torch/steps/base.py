"""BuildStep base: cache-ID chaining and the layer-commit path.

Copy of ``makisu_tpu/steps/base.py`` (reference:
lib/builder/step/base_step.go — crc32 chaining :62-67, workdir/env setup
:71-117 — and common.go commitLayer:67). The commit path streams the
layer tar through the context's chunker.Hasher seam: with the gpu hasher
that is where the card's kernels chunk and fingerprint the layer.
"""

from __future__ import annotations

import os
import tempfile
import time
import zlib

from makisu_tpu_torch.chunker.hasher import LayerCommit
from makisu_tpu_torch.context import BuildContext
from makisu_tpu_torch.docker.image import DigestPair, ImageConfig
from makisu_tpu_torch.utils import envutils, metrics, pathutils
from makisu_tpu_torch.utils import logging as log


def chain_cache_id(seed: str, *parts: str) -> str:
    """crc32 over seed+parts, hex — the chained per-step cache identity
    (reference: base_step.go SetCacheID)."""
    payload = (seed + "".join(parts)).encode()
    return format(zlib.crc32(payload) & 0xFFFFFFFF, "x")


class BuildStep:
    """One executable Dockerfile directive.

    Lifecycle per node: apply_ctx_and_config → (apply cached layers) →
    execute → commit → update_ctx_and_config. Metadata-only steps override
    just ``update_config``.
    """

    directive = "STEP"

    def __init__(self, args: str, commit: bool) -> None:
        self.args = args
        self.commit_annotation = commit
        self.cache_id = ""
        self.working_dir = "/"
        self.logical_working_dir = "/"
        # Layers committed by this step, with their chunk fingerprints
        # (gpu hasher); recorded into the cache entries.
        self.layer_commits: list[LayerCommit] = []

    # -- identity ---------------------------------------------------------

    def __str__(self) -> str:
        suffix = " #!COMMIT" if self.commit_annotation else ""
        return f"{self.directive} {self.args}{suffix} ({self.cache_id})"

    def has_commit(self) -> bool:
        return self.commit_annotation

    def set_cache_id(self, ctx: BuildContext, seed: str) -> None:
        self.cache_id = chain_cache_id(
            seed, self.directive, self.args, str(self.commit_annotation))

    # -- capabilities -----------------------------------------------------

    def require_on_disk(self) -> bool:
        return False

    def context_dirs(self) -> tuple[str, list[str]]:
        """(stage alias, dirs) this step needs from another stage."""
        return "", []

    # -- lifecycle --------------------------------------------------------

    def apply_ctx_and_config(self, ctx: BuildContext,
                             config: ImageConfig | None) -> None:
        self._set_working_dir(ctx, config)
        self._export_stage_vars(ctx)

    def execute(self, ctx: BuildContext, modify_fs: bool) -> None:
        pass

    def commit(self, ctx: BuildContext) -> list[DigestPair]:
        return commit_layer(ctx, self)

    def update_ctx_and_config(self, ctx: BuildContext,
                              config: ImageConfig | None) -> ImageConfig:
        base = config.clone() if config is not None else ImageConfig()
        return self.update_config(ctx, base)

    def update_config(self, ctx: BuildContext,
                      config: ImageConfig) -> ImageConfig:
        return config

    # -- helpers ----------------------------------------------------------

    def _set_working_dir(self, ctx: BuildContext,
                         config: ImageConfig | None) -> None:
        # Logical working dir (image-config space) for copy destinations;
        # physical working dir (under the build root) for exec'd commands.
        # Identical in production where root is "/".
        self.logical_working_dir = "/"
        self.working_dir = ctx.root_dir
        if config is not None and config.config.working_dir:
            self.logical_working_dir = envutils.expand(
                config.config.working_dir, ctx.exec_env)
            self.working_dir = pathutils.join_root(ctx.root_dir,
                                                   self.logical_working_dir)
        if not os.path.lexists(self.working_dir):
            os.makedirs(self.working_dir, exist_ok=True)

    def _export_stage_vars(self, ctx: BuildContext) -> None:
        """ARG/ENV values become the RUN-step env — the build-local
        exec_env, never os.environ (concurrent builds share a process)."""
        for key, value in ctx.stage_vars.items():
            if len(value) >= 2 and value[0] == value[-1] == '"':
                value = value[1:-1]
            ctx.exec_env[key] = envutils.expand(value, ctx.exec_env)


def commit_layer(ctx: BuildContext, step: BuildStep) -> list[DigestPair]:
    """Generate one layer from the context's pending changes.

    Scan-diff after RUN (must_scan), copy-op diff after ADD/COPY, or
    nothing. The tar stream flows through ctx.hasher and the gzipped blob
    lands in the layer CAS store.
    """
    if ctx.must_scan:
        write_diffs = ctx.memfs.add_layer_by_scan
    elif ctx.copy_ops:
        ops = ctx.copy_ops

        def write_diffs(tw):
            return ctx.memfs.add_layer_by_copy_ops(ops, tw)
    else:
        return []

    fd, tmp = tempfile.mkstemp(dir=ctx.image_store.sandbox_dir,
                               prefix="layertar-")
    t0 = time.perf_counter()
    try:
        with metrics.span("commit_layer", directive=step.directive):
            with os.fdopen(fd, "wb") as out:
                sink = ctx.hasher.open_layer(out,
                                             backend_id=ctx.gzip_backend_id)
                with sink.open_tar() as tw:
                    write_diffs(tw)
                with metrics.span("commit.sink_finish"):
                    layer_commit = sink.finish()
            pair = layer_commit.digest_pair
            ctx.image_store.layers.link_file(
                pair.gzip_descriptor.digest.hex(), tmp)
            step.layer_commits.append(layer_commit)
    finally:
        os.unlink(tmp)
    ctx.must_scan = False
    ctx.copy_ops = []
    metrics.counter_add("makisu_layer_commits_total")
    metrics.counter_add("makisu_layer_bytes_total",
                        pair.gzip_descriptor.size)
    metrics.counter_add("makisu_layer_chunks_total",
                        len(layer_commit.chunks))
    fields = {"sink": sink.route,  # "native" (C++) or "python"
              "commit_s": time.perf_counter() - t0,
              "sync_s": ctx.memfs.sync_seconds,
              "mtime_wait_s": ctx.memfs.mtime_wait_seconds,
              "diff_s": ctx.memfs.diff_seconds,
              "compress_s": sink.compress_seconds}
    if sink.compress_workers is not None:
        fields["compress_workers"] = sink.compress_workers  # pgzip lanes
    session = getattr(sink, "session", None)
    if session is not None:
        # The chunk session's host time and kernel work for this layer.
        fields.update(session_s=session.host_seconds,
                      session_wait_s=session.wait_seconds,
                      device_s=session.device_seconds,
                      gear_blocks=session.blocks,
                      span_launches=session.span_launches,
                      h2d_bytes=session.h2d_bytes)
        if session.service is not None:
            fields["service_passes"] = session.service_passes
    log.info("committed layer %s (%d bytes, %d chunks)",
             pair.gzip_descriptor.digest, pair.gzip_descriptor.size,
             len(layer_commit.chunks), **fields)
    return [pair]
