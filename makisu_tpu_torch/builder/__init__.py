"""Build orchestration: copy of ``makisu_tpu/builder/`` (reference:
lib/builder/)."""

from makisu_tpu_torch.builder.node import BuildNode, NodeOptions
from makisu_tpu_torch.builder.plan import BuildPlan
from makisu_tpu_torch.builder.stage import BuildStage, StageOptions

__all__ = ["BuildNode", "BuildPlan", "BuildStage", "NodeOptions",
           "StageOptions"]
