"""RUN step: shell out, then mark the FS for scanning.

Copy of ``makisu_tpu/steps/run_step.py`` (reference:
lib/builder/step/run_step.go — RequireOnDisk:46, Execute:63-71).
"""

from __future__ import annotations

from makisu_tpu_torch import shell
from makisu_tpu_torch.context import BuildContext
from makisu_tpu_torch.docker.image import ImageConfig
from makisu_tpu_torch.steps.base import BuildStep


class RunStep(BuildStep):
    directive = "RUN"

    def __init__(self, args: str, cmd: str, commit: bool) -> None:
        super().__init__(args, commit)
        self.cmd = cmd
        self.user = ""

    def require_on_disk(self) -> bool:
        return True

    def apply_ctx_and_config(self, ctx: BuildContext,
                             config: ImageConfig | None) -> None:
        super().apply_ctx_and_config(ctx, config)
        if config is not None:
            self.user = config.config.user

    def execute(self, ctx: BuildContext, modify_fs: bool) -> None:
        if not modify_fs:
            raise RuntimeError(
                "RUN step requires a modifiable filesystem (--modifyfs)")
        ctx.must_scan = True
        shell.exec_command(self.working_dir, self.user, "sh", "-c", self.cmd,
                           env=ctx.exec_env)
