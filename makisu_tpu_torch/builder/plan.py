"""BuildPlan: order stages, chain cache IDs, drive the build.

Copy of ``makisu_tpu/builder/plan.py`` (reference:
lib/builder/build_plan.go — NewBuildPlan:66, processStagesAndAliases:93:
crc32 seed, shadow stages for COPY --from=<image>; Execute:174-234:
per-stage pull-cache/build/--target early exit, WaitForPush join,
manifest + replicas). The stage seed hashes the same ``BUILD_HASH`` as
makisu_tpu's, so both builders chain the same cache IDs. ``execute``
saves the context's stat cache at the end, failed builds included.
"""

from __future__ import annotations

import zlib

import makisu_tpu_torch
from makisu_tpu_torch import dockerfile as df
from makisu_tpu_torch.builder.stage import BuildStage
from makisu_tpu_torch.context import BuildContext
from makisu_tpu_torch.docker.image import DistributionManifest, ImageName
from makisu_tpu_torch.utils import logging as log
from makisu_tpu_torch.utils import metrics


class BuildPlan:
    def __init__(self, ctx: BuildContext, target: ImageName,
                 replicas: list[ImageName], cache_mgr,
                 parsed_stages: list[df.Stage], allow_modify_fs: bool,
                 force_commit: bool, stage_target: str = "",
                 registry_client=None) -> None:
        self.base_ctx = ctx
        self.target = target
        self.replicas = replicas
        self.cache_mgr = cache_mgr
        self.stage_target = stage_target
        self.allow_modify_fs = allow_modify_fs
        self.force_commit = force_commit
        self.registry_client = registry_client
        self.stages: list[BuildStage] = []
        self.copy_from_dirs: dict[str, list[str]] = {}
        self._process_stages(parsed_stages)

    def _process_stages(self, parsed_stages: list[df.Stage]) -> None:
        # Stage construction walks the whole context for cache IDs: a
        # phase of its own, one of the warm-rebuild floor's terms.
        with metrics.span("context_scan", stages=len(parsed_stages)):
            self._process_stages_inner(parsed_stages)

    def _process_stages_inner(self,
                              parsed_stages: list[df.Stage]) -> None:
        opts_repr = f"forceCommit={self.force_commit}," \
                    f"modifyFS={self.allow_modify_fs}"
        seed = format(zlib.crc32(
            (makisu_tpu_torch.BUILD_HASH + opts_repr).encode())
            & 0xFFFFFFFF, "x")
        aliases: set[str] = set()
        for i, parsed in enumerate(parsed_stages):
            alias = parsed.from_directive.alias
            if alias:
                if alias in aliases:
                    raise ValueError(f"duplicate stage alias: {alias}")
                if alias.isdigit():
                    raise ValueError(
                        f"stage alias cannot be a number: {alias}")
            else:
                alias = str(i)
                parsed.from_directive.alias = alias
            aliases.add(alias)
            stage = BuildStage(self.base_ctx, alias, seed, parsed,
                               self.allow_modify_fs, self.force_commit,
                               self.registry_client)
            if stage.copy_from_dirs and not self.allow_modify_fs:
                raise ValueError(
                    "COPY --from multi-stage builds require --modifyfs")
            for dep_alias, dirs in stage.copy_from_dirs.items():
                merged = set(self.copy_from_dirs.get(dep_alias, []))
                merged.update(dirs)
                self.copy_from_dirs[dep_alias] = sorted(merged)
                if dep_alias not in aliases:
                    # COPY --from=<image>: prepend a shadow stage that
                    # pulls that image (reference :136-153).
                    name = ImageName.parse_for_pull(dep_alias)
                    if not name.repository:
                        raise ValueError(
                            f"copy from nonexistent stage {dep_alias}")
                    shadow = BuildStage(
                        self.base_ctx, dep_alias, seed, None,
                        self.allow_modify_fs, False, self.registry_client,
                        remote_image=dep_alias)
                    self.stages.append(shadow)
                    seed = shadow.seed_out
                    # One shadow per image, even when several stages copy
                    # from it.
                    aliases.add(dep_alias)
            self.stages.append(stage)
            seed = stage.seed_out
        if self.stage_target and self.stage_target not in aliases:
            raise ValueError(
                f"target stage not found in dockerfile: {self.stage_target}")

    def execute(self) -> DistributionManifest:
        try:
            return self._execute()
        finally:
            # Persist the stat-keyed content-ID cache even on failure:
            # whatever hashing this build did, the next one inherits
            # (the write is atomic and advisory).
            self.base_ctx.content_ids.save()

    def _execute(self) -> DistributionManifest:
        curr = None
        for k, stage in enumerate(self.stages):
            curr = stage
            log.info("stage %d/%d: %s", k + 1, len(self.stages), stage)
            with metrics.span("stage", alias=stage.alias, index=k):
                metrics.counter_add(metrics.STAGES_TOTAL)
                with metrics.span("pull_cache_layers"):
                    stage.pull_cache_layers(self.cache_mgr)
                last_stage = k == len(self.stages) - 1
                copied_from = stage.alias in self.copy_from_dirs
                stage.last_image_config = None
                stage.build(self.cache_mgr, last_stage, copied_from)
                if self.allow_modify_fs:
                    stage.checkpoint(
                        self.copy_from_dirs.get(stage.alias, []))
                    stage.cleanup()
            # ARG/ENV exports live in each stage context's exec_env
            # (reset per stage), so no process-env restore is needed.
            if self.stage_target and stage.alias == self.stage_target:
                log.info("finished building target stage")
                break
        with metrics.span("wait_for_push"):
            self.cache_mgr.wait_for_push()
        assert curr is not None
        manifest = curr.save_manifest(self.target)
        for replica in self.replicas:
            curr.save_manifest(replica)
        total = sum(l.size for l in manifest.layers)
        log.info("computed total image size %d", total,
                 total_image_size=total)
        return manifest
