"""FROM step: establish the base image.

Copy of ``makisu_tpu/steps/from_step.py`` for ``scratch`` and images
already in the local store (a build's own output, saved under its tag).
Pulling a base image from a registry is not ported yet and raises.
Reference: lib/builder/step/from_step.go (Execute:94-137 applies base
layers to MemFS; Commit:139 returns the base DigestPairs when the stage is
copied-from; UpdateCtxAndConfig seeds config + stage vars from the base).
"""

from __future__ import annotations

import gzip
import os
import tarfile

from makisu_tpu_torch.context import BuildContext
from makisu_tpu_torch.docker.image import (
    Digest,
    DigestPair,
    DistributionManifest,
    ImageConfig,
    ImageName,
)
from makisu_tpu_torch.steps.base import BuildStep, chain_cache_id
from makisu_tpu_torch.utils import logging as log


class FromStep(BuildStep):
    directive = "FROM"

    def __init__(self, args: str, image: str, alias: str) -> None:
        super().__init__(args, commit=False)
        if image.lower() != "scratch":
            image = str(ImageName.parse_for_pull(image))
        self.image = image
        self.alias = alias
        self._manifest: DistributionManifest | None = None
        self._config: ImageConfig | None = None

    @property
    def is_scratch(self) -> bool:
        return self.image.lower() == "scratch"

    def set_cache_id(self, ctx: BuildContext, seed: str) -> None:
        # An explicit platform pin is part of the cache identity, as in
        # makisu_tpu (only chained when set).
        platform = os.environ.get("MAKISU_TPU_PLATFORM", "")
        parts = [self.directive, self.image]
        if platform:
            parts.append(platform)
        self.cache_id = chain_cache_id(seed, *parts)

    def _load(self, ctx: BuildContext) -> None:
        if self._manifest is not None:
            return
        name = ImageName.parse(self.image)
        store = ctx.image_store
        if not store.manifests.exists(name):
            raise RuntimeError(
                f"base image {self.image} is not in the local store; "
                "pulling from a registry is not ported yet")
        manifest = store.manifests.load(name)
        with store.layers.open(manifest.config.digest.hex()) as f:
            config = ImageConfig.from_bytes(f.read())
        want_platform = os.environ.get("MAKISU_TPU_PLATFORM", "")
        if want_platform:
            parts = want_platform.split("/") + [""]
            if (config.os, config.architecture) != (parts[0], parts[1]):
                raise ValueError(
                    f"base image {self.image} is "
                    f"{config.os}/{config.architecture}, but "
                    f"MAKISU_TPU_PLATFORM wants {want_platform}")
        if len(config.rootfs.diff_ids) != len(manifest.layers):
            raise ValueError(
                "base image layer count mismatch between config and "
                "manifest")
        self._manifest = manifest
        self._config = config

    def execute(self, ctx: BuildContext, modify_fs: bool) -> None:
        if self.is_scratch:
            log.info("scratch base image; nothing to apply")
            return
        self._load(ctx)
        for descriptor in self._manifest.layers:
            log.info("applying FROM layer %s", descriptor.digest.hex())
            with ctx.image_store.layers.open(descriptor.digest.hex()) as f:
                with gzip.GzipFile(fileobj=f, mode="rb") as gz:
                    with tarfile.open(fileobj=gz, mode="r|") as tf:
                        ctx.memfs.update_from_tar(tf, untar=modify_fs)

    def commit(self, ctx: BuildContext) -> list[DigestPair]:
        if self.is_scratch:
            return []
        self._load(ctx)
        return [
            DigestPair(Digest(diff_id), desc)
            for diff_id, desc in zip(self._config.rootfs.diff_ids,
                                     self._manifest.layers)
        ]

    def update_ctx_and_config(self, ctx: BuildContext,
                              config: ImageConfig | None) -> ImageConfig:
        if self.is_scratch:
            return ImageConfig()
        self._load(ctx)
        for kv in self._config.config.env:
            key, _, val = kv.partition("=")
            ctx.stage_vars[key] = val
        return self._config.clone()
