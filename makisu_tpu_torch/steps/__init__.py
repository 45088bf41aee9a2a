"""Build steps: executable forms of the 16 Dockerfile directives.

Copy of ``makisu_tpu/steps/`` (reference: lib/builder/step/ — BuildStep
interface step.go:49-84, factory step.go:86).
"""

from __future__ import annotations

from makisu_tpu_torch import dockerfile as df
from makisu_tpu_torch.context import BuildContext
from makisu_tpu_torch.steps.add_copy import AddCopyStep, AddStep, CopyStep
from makisu_tpu_torch.steps.base import BuildStep, chain_cache_id, commit_layer
from makisu_tpu_torch.steps.from_step import FromStep
from makisu_tpu_torch.steps.metadata import (
    ArgStep,
    CmdStep,
    EntrypointStep,
    EnvStep,
    ExposeStep,
    HealthcheckStep,
    LabelStep,
    MaintainerStep,
    StopsignalStep,
    UserStep,
    VolumeStep,
    WorkdirStep,
)
from makisu_tpu_torch.steps.run_step import RunStep


def new_step(ctx: BuildContext, directive: df.Directive,
             seed: str) -> BuildStep:
    """Directive → step, with its cache ID chained from ``seed``
    (reference: NewDockerfileStep step.go:86)."""
    d = directive
    if isinstance(d, df.AddDirective):
        step = AddStep(d.args, d.chown, d.srcs, d.dst, d.commit,
                       d.preserve_owner, d.inline_files,
                       d.ordered_sources)
    elif isinstance(d, df.ArgDirective):
        step = ArgStep(d.args, d.name, d.resolved_val, d.commit)
    elif isinstance(d, df.CmdDirective):
        step = CmdStep(d.args, d.cmd, d.commit)
    elif isinstance(d, df.CopyDirective):
        step = CopyStep(d.args, d.chown, d.from_stage, d.srcs, d.dst,
                        d.commit, d.preserve_owner, d.inline_files,
                        d.ordered_sources)
    elif isinstance(d, df.EntrypointDirective):
        step = EntrypointStep(d.args, d.entrypoint, d.commit)
    elif isinstance(d, df.EnvDirective):
        step = EnvStep(d.args, d.envs, d.commit)
    elif isinstance(d, df.ExposeDirective):
        step = ExposeStep(d.args, d.ports, d.commit)
    elif isinstance(d, df.FromDirective):
        step = FromStep(d.args, d.image, d.alias)
    elif isinstance(d, df.HealthcheckDirective):
        step = HealthcheckStep(d.args, d.interval, d.timeout,
                               d.start_period, d.retries, d.test, d.commit)
    elif isinstance(d, df.LabelDirective):
        step = LabelStep(d.args, d.labels, d.commit)
    elif isinstance(d, df.MaintainerDirective):
        step = MaintainerStep(d.args, d.author, d.commit)
    elif isinstance(d, df.RunDirective):
        step = RunStep(d.args, d.cmd, d.commit)
    elif isinstance(d, df.StopsignalDirective):
        step = StopsignalStep(d.args, d.signal, d.commit)
    elif isinstance(d, df.UserDirective):
        step = UserStep(d.args, d.user, d.commit)
    elif isinstance(d, df.VolumeDirective):
        step = VolumeStep(d.args, d.volumes, d.commit)
    elif isinstance(d, df.WorkdirDirective):
        step = WorkdirStep(d.args, d.working_dir, d.commit)
    else:
        raise TypeError(f"unsupported directive type: {type(d).__name__}")
    step.set_cache_id(ctx, seed)
    return step


__all__ = [
    "AddCopyStep", "AddStep", "ArgStep", "BuildStep", "CmdStep", "CopyStep",
    "EntrypointStep", "EnvStep", "ExposeStep", "FromStep",
    "HealthcheckStep", "LabelStep", "MaintainerStep", "RunStep",
    "StopsignalStep", "UserStep", "VolumeStep", "WorkdirStep",
    "chain_cache_id", "commit_layer", "new_step",
]
