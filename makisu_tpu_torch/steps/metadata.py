"""Metadata steps: pure image-config mutations.

Copy of ``makisu_tpu/steps/metadata.py`` (reference:
lib/builder/step/{arg,cmd,entrypoint,env,expose,healthcheck,
label,maintainer,stopsignal,user,volume,workdir}_step.go).
"""

from __future__ import annotations

import os

from makisu_tpu_torch.context import BuildContext
from makisu_tpu_torch.docker.image import HealthConfig, ImageConfig
from makisu_tpu_torch.steps.base import BuildStep
from makisu_tpu_torch.utils import envutils, pathutils


def merge_env(existing: list[str], updates: dict[str, str]) -> list[str]:
    """Merge KEY=VAL updates into a docker env list, replacing in place."""
    out = list(existing)
    seen = set()
    for i, kv in enumerate(out):
        key = kv.split("=", 1)[0]
        if key in updates:
            out[i] = f"{key}={updates[key]}"
            seen.add(key)
    for key, val in updates.items():
        if key not in seen:
            out.append(f"{key}={val}")
    return out


class ArgStep(BuildStep):
    directive = "ARG"

    def __init__(self, args: str, name: str, resolved_val: str | None,
                 commit: bool) -> None:
        super().__init__(args, commit)
        self.name = name
        self.resolved_val = resolved_val

    def update_config(self, ctx: BuildContext,
                      config: ImageConfig) -> ImageConfig:
        if self.resolved_val is not None:
            ctx.stage_vars[self.name] = self.resolved_val
        return config


class CmdStep(BuildStep):
    directive = "CMD"

    def __init__(self, args: str, cmd: list[str], commit: bool) -> None:
        super().__init__(args, commit)
        self.cmd = cmd

    def update_config(self, ctx, config):
        config.config.cmd = list(self.cmd)
        return config


class EntrypointStep(BuildStep):
    directive = "ENTRYPOINT"

    def __init__(self, args: str, entrypoint: list[str],
                 commit: bool) -> None:
        super().__init__(args, commit)
        self.entrypoint = entrypoint

    def update_config(self, ctx, config):
        config.config.entrypoint = list(self.entrypoint)
        return config


class EnvStep(BuildStep):
    directive = "ENV"

    def __init__(self, args: str, envs: dict[str, str], commit: bool) -> None:
        super().__init__(args, commit)
        self.envs = envs

    def update_config(self, ctx, config):
        ctx.stage_vars.update(self.envs)
        expanded = {k: envutils.expand(v, ctx.exec_env)
                    for k, v in self.envs.items()}
        config.config.env = merge_env(config.config.env, expanded)
        return config


class ExposeStep(BuildStep):
    directive = "EXPOSE"

    def __init__(self, args: str, ports: list[str], commit: bool) -> None:
        super().__init__(args, commit)
        self.ports = ports

    def update_config(self, ctx, config):
        existing = dict(config.config.exposed_ports or {})
        for port in self.ports:
            key = port if "/" in port else f"{port}/tcp"
            existing[key] = {}
        config.config.exposed_ports = existing
        return config


class HealthcheckStep(BuildStep):
    directive = "HEALTHCHECK"

    def __init__(self, args: str, interval: int, timeout: int,
                 start_period: int, retries: int, test: list[str],
                 commit: bool) -> None:
        super().__init__(args, commit)
        self.health = HealthConfig(test, interval, timeout, start_period,
                                   retries)

    def update_config(self, ctx, config):
        config.config.healthcheck = HealthConfig(
            list(self.health.test), self.health.interval,
            self.health.timeout, self.health.start_period,
            self.health.retries)
        return config


class LabelStep(BuildStep):
    directive = "LABEL"

    def __init__(self, args: str, labels: dict[str, str],
                 commit: bool) -> None:
        super().__init__(args, commit)
        self.labels = labels

    def update_config(self, ctx, config):
        merged = dict(config.config.labels or {})
        merged.update(self.labels)
        config.config.labels = merged
        return config


class MaintainerStep(BuildStep):
    directive = "MAINTAINER"

    def __init__(self, args: str, author: str, commit: bool) -> None:
        super().__init__(args, commit)
        self.author = author

    def update_config(self, ctx, config):
        config.author = self.author
        return config


class StopsignalStep(BuildStep):
    directive = "STOPSIGNAL"

    def __init__(self, args: str, signal: int, commit: bool) -> None:
        super().__init__(args, commit)
        self.signal = signal

    def update_config(self, ctx, config):
        config.config.stop_signal = str(self.signal)
        return config


class UserStep(BuildStep):
    directive = "USER"

    def __init__(self, args: str, user: str, commit: bool) -> None:
        super().__init__(args, commit)
        self.user = user

    def update_config(self, ctx, config):
        config.config.user = self.user
        return config


class VolumeStep(BuildStep):
    directive = "VOLUME"

    def __init__(self, args: str, volumes: list[str], commit: bool) -> None:
        super().__init__(args, commit)
        self.volumes = volumes

    def update_config(self, ctx, config):
        existing = dict(config.config.volumes or {})
        for v in self.volumes:
            existing[v] = {}
        config.config.volumes = existing
        return config


class WorkdirStep(BuildStep):
    directive = "WORKDIR"

    def __init__(self, args: str, working_dir: str, commit: bool) -> None:
        super().__init__(args, commit)
        self.workdir = working_dir

    def update_config(self, ctx, config):
        workdir = envutils.expand(self.workdir, ctx.exec_env)
        if os.path.isabs(workdir):
            config.config.working_dir = workdir
        else:
            base = config.config.working_dir or "/"
            config.config.working_dir = os.path.normpath(
                os.path.join(base, workdir))
        # The config path is logical; materialize it under the build root
        # (identical in production where root is "/").
        physical = pathutils.join_root(ctx.root_dir,
                                       config.config.working_dir)
        if not os.path.lexists(physical):
            os.makedirs(physical, exist_ok=True)
        return config
