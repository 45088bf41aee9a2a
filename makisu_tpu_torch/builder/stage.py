"""buildStage: one FROM + its steps, cache prefetching, manifest assembly.

Copy of ``makisu_tpu/builder/stage.py`` (reference:
lib/builder/build_stage.go — newBuildStage:57, createDockerfileSteps:152,
build:171-211, GetDistributionManifest:215-262, pullCacheLayers:299,
latestFetched:315, checkpoint:342, cleanup:347).
"""

from __future__ import annotations

import dataclasses
import datetime
import time

from makisu_tpu_torch import dockerfile as df
from makisu_tpu_torch.builder.node import BuildNode, NodeOptions
from makisu_tpu_torch.context import BuildContext
from makisu_tpu_torch.docker.image import (
    MEDIA_TYPE_CONFIG,
    Descriptor,
    Digest,
    DistributionManifest,
    History,
    ImageConfig,
    ImageName,
)
from makisu_tpu_torch.steps import FromStep, new_step
from makisu_tpu_torch.utils import events, ledger, metrics
from makisu_tpu_torch.utils import logging as log


@dataclasses.dataclass
class StageOptions:
    allow_modify_fs: bool = False
    force_commit: bool = False
    require_on_disk: bool = False


def _now_iso() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.%fZ")


class BuildStage:
    def __init__(self, base_ctx: BuildContext, alias: str, seed: str,
                 parsed_stage: df.Stage | None,
                 allow_modify_fs: bool, force_commit: bool,
                 registry_client=None,
                 remote_image: str | None = None) -> None:
        self.ctx = base_ctx.new_stage_context()
        self.alias = alias
        self.last_image_config: ImageConfig | None = None
        if remote_image is not None:
            # Shadow stage for COPY --from=<image>: a single FROM step
            # (reference: newRemoteImageStage build_stage.go:78).
            from_step = FromStep(remote_image, remote_image, alias)
            from_step.set_cache_id(self.ctx, seed)
            steps = [from_step]
            force_commit = False
        else:
            directives = [parsed_stage.from_directive,
                          *parsed_stage.directives]
            steps = []
            for d in directives:
                step = new_step(self.ctx, d, seed)
                steps.append(step)
                seed = step.cache_id
        self.copy_from_dirs: dict[str, list[str]] = {}
        require_on_disk = False
        self.nodes: list[BuildNode] = []
        for step in steps:
            if isinstance(step, FromStep):
                step.registry_client = registry_client
            self.nodes.append(BuildNode(self.ctx, step))
            dep_alias, dirs = step.context_dirs()
            if dirs:
                self.copy_from_dirs.setdefault(dep_alias, []).extend(dirs)
            require_on_disk = require_on_disk or step.require_on_disk()
        self.opts = StageOptions(allow_modify_fs, force_commit,
                                 require_on_disk)

    @property
    def seed_out(self) -> str:
        return self.nodes[-1].cache_id

    def __str__(self) -> str:
        return f"(alias={self.alias},latestfetched={self.latest_fetched()})"

    # -- cache prefetch ---------------------------------------------------

    def pull_cache_layers(self, cache_mgr) -> None:
        """Prefetch commit-node layers in order; stop at the first break
        in the chain (reference :299-313)."""
        for i, node in enumerate(self.nodes[1:], start=1):
            if node.has_commit() or self.opts.force_commit:
                # The consult, and all it sets off, is attributed to
                # this node: the ledger names the step that broke the
                # cache chain.
                with ledger.node_scope(stage=self.alias, step=i,
                                       directive=node.step.directive):
                    if not node.pull_cache_layer(cache_mgr):
                        return

    def latest_fetched(self) -> int:
        latest = -1
        for i, node in enumerate(self.nodes[1:], start=1):
            if node.has_commit() or self.opts.force_commit:
                if node.digest_pairs is not None:
                    latest = i
                else:
                    return latest
        return latest

    # -- build ------------------------------------------------------------

    def build(self, cache_mgr, last_stage: bool, copied_from: bool) -> None:
        diff_ids: list[str] = []
        histories: list[History] = []
        config = self.last_image_config
        latest_fetched = self.latest_fetched()
        for i, node in enumerate(self.nodes):
            modify_fs = self.opts.require_on_disk or copied_from
            if modify_fs and not self.opts.allow_modify_fs:
                raise RuntimeError(
                    "this build needs --modifyfs (RUN/--chown/multi-stage)")
            opts = NodeOptions(
                skip_build=0 < i < latest_fetched,
                force_commit=(i == 0 or (last_stage and
                                         i == len(self.nodes) - 1)
                              or self.opts.force_commit),
                modify_fs=modify_fs)
            log.info("step %d/%d (%s): %s", i + 1, len(self.nodes), opts,
                     node)
            start = time.time()
            events.emit("step", phase="start", stage=self.alias, index=i,
                        directive=node.step.directive,
                        cached=node.digest_pairs is not None,
                        skip=bool(opts.skip_build))
            with metrics.span("step", directive=node.step.directive,
                              index=i, cached=node.digest_pairs is not None,
                              skip=opts.skip_build), \
                    ledger.node_scope(stage=self.alias, step=i,
                                      directive=node.step.directive):
                # The node scope rides into every thread the step spawns
                # (copy_context), so commit-side decisions (chunk
                # indexing) stay attributed.
                config = node.build(cache_mgr, config, opts)
            events.emit("step", phase="done", stage=self.alias, index=i,
                        directive=node.step.directive,
                        duration=round(time.time() - start, 6))
            log.info("step %d done", i + 1, duration=time.time() - start)
            if node.digest_pairs:
                for pair in node.digest_pairs:
                    diff_ids.append(str(pair.tar_digest))
                    histories.append(History(
                        created=_now_iso(),
                        created_by=f"makisu-tpu: {node.step.directive} "
                                   f"{node.step.args}",
                        author="makisu-tpu"))
            else:
                # Docker-spec fidelity: layer-less steps still appear in
                # the config history, flagged empty_layer.
                histories.append(History(
                    created=_now_iso(),
                    created_by=f"makisu-tpu: {node.step.directive} "
                               f"{node.step.args}",
                    author="makisu-tpu",
                    empty_layer=True))
        assert config is not None
        config.created = _now_iso()
        config.history = histories
        config.rootfs.diff_ids = diff_ids
        config.container_config = None
        self.last_image_config = config

    # -- outputs ----------------------------------------------------------

    def get_distribution_manifest(self) -> DistributionManifest:
        assert self.last_image_config is not None
        blob = self.last_image_config.to_bytes()
        digest = Digest.of_bytes(blob)
        self.ctx.image_store.layers.write_bytes(digest.hex(), blob)
        layers = []
        for node in self.nodes:
            for pair in node.digest_pairs or []:
                layers.append(pair.gzip_descriptor)
        return DistributionManifest(
            config=Descriptor(MEDIA_TYPE_CONFIG, len(blob), digest),
            layers=layers)

    def save_manifest(self, name: ImageName) -> DistributionManifest:
        manifest = self.get_distribution_manifest()
        self.ctx.image_store.manifests.save(name, manifest)
        return manifest

    # -- stage transitions ------------------------------------------------

    def checkpoint(self, copy_from_dirs: list[str]) -> None:
        self.ctx.memfs.checkpoint(
            self.ctx.copy_from_root(self.alias), copy_from_dirs)

    def cleanup(self) -> None:
        self.ctx.memfs.remove()
