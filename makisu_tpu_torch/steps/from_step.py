"""FROM step: establish the base image.

Copy of ``makisu_tpu/steps/from_step.py``: ``scratch``, an image already
in the local store, or one pulled from its registry (pipelined: layer
downloads run ahead on the transfer engine while the layers apply in
manifest order). Reference: lib/builder/step/from_step.go
(Execute:94-137 applies base layers to MemFS; Commit:139 returns the
base DigestPairs when the stage is copied-from; UpdateCtxAndConfig seeds
config + stage vars from the base).
"""

from __future__ import annotations

import os
import tarfile

from makisu_tpu_torch import tario
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
        self.registry_client = None  # injected by the plan
        self._manifest: DistributionManifest | None = None
        self._config: ImageConfig | None = None
        # Pipelined pull in flight (clients exposing start_pull).
        self._pull_handle = None

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

    @staticmethod
    def _platform_matches(config: ImageConfig, want: str) -> bool:
        parts = want.split("/")
        want_os, want_arch = parts[0], parts[1] if len(parts) > 1 else ""
        return config.os == want_os and config.architecture == want_arch

    def _load(self, ctx: BuildContext) -> None:
        if self._manifest is not None:
            return
        name = ImageName.parse(self.image)
        store = ctx.image_store
        want_platform = os.environ.get("MAKISU_TPU_PLATFORM", "")

        def read_config(manifest) -> ImageConfig:
            with store.layers.open(manifest.config.digest.hex()) as f:
                return ImageConfig.from_bytes(f.read())

        manifest = config = None
        if store.manifests.exists(name):
            manifest = store.manifests.load(name)
            config = read_config(manifest)
            if want_platform and not self._platform_matches(
                    config, want_platform):
                # Resolved for another platform before the pin changed:
                # never reused silently.
                log.info("cached %s is %s/%s; re-pulling for %s",
                         self.image, config.os, config.architecture,
                         want_platform)
                manifest = config = None
        try:
            if manifest is None:
                if self.registry_client is None:
                    raise RuntimeError(
                        f"no registry client to pull base image "
                        f"{self.image}")
                start_pull = getattr(self.registry_client, "start_pull",
                                     None)
                if start_pull is not None:
                    # Manifest and config now; layer blobs keep
                    # downloading while execute() applies them in order.
                    self._pull_handle = start_pull(name)
                    manifest = self._pull_handle.manifest
                else:
                    manifest = self.registry_client.pull(name)
                config = read_config(manifest)
                if want_platform and not self._platform_matches(
                        config, want_platform):
                    raise ValueError(
                        f"base image {self.image} is "
                        f"{config.os}/{config.architecture}, but "
                        f"MAKISU_TPU_PLATFORM wants {want_platform}")
            self._manifest = manifest
            self._config = config
            if len(self._config.rootfs.diff_ids) != len(manifest.layers):
                raise ValueError(
                    "base image layer count mismatch between config and "
                    "manifest")
        except BaseException:
            # A failed validation settles the in-flight pull: a failed
            # build must not keep downloading on the shared engine.
            self._abandon_pull()
            raise

    def execute(self, ctx: BuildContext, modify_fs: bool) -> None:
        if self.is_scratch:
            log.info("scratch base image; nothing to apply")
            return
        self._load(ctx)
        try:
            for descriptor in self._manifest.layers:
                if self._pull_handle is not None:
                    # Gate on this layer only: applying layer k overlaps
                    # the wire time of layers k+1.. (application stays
                    # in manifest order for the whiteouts).
                    self._pull_handle.wait_layer(descriptor.digest)
                log.info("applying FROM layer %s", descriptor.digest.hex())
                with ctx.image_store.layers.open(
                        descriptor.digest.hex()) as f:
                    with tario.gzip_reader(f) as gz:
                        with tarfile.open(fileobj=gz, mode="r|") as tf:
                            ctx.memfs.update_from_tar(tf, untar=modify_fs)
        except BaseException:
            self._abandon_pull()
            raise
        self._finish_pull()

    def _abandon_pull(self) -> None:
        """The build failed mid-FROM: settle the in-flight pull without
        masking the original error (queued downloads cancel, running ones
        join, their errors are swallowed)."""
        handle, self._pull_handle = self._pull_handle, None
        if handle is not None:
            handle.abandon()

    def _finish_pull(self) -> None:
        """Join any still-running downloads and save the manifest (a
        no-op once done); commit() settles the pull on paths that never
        applied the layers."""
        if self._pull_handle is not None:
            self._pull_handle.wait_all()
            self._pull_handle = None

    def commit(self, ctx: BuildContext) -> list[DigestPair]:
        if self.is_scratch:
            return []
        self._load(ctx)
        self._finish_pull()
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
