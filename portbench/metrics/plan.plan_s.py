"""plan.plan_s: per build, its log's first "stage 1/" record less the
build's start: the CLI, the Dockerfile's parse, the context walk and its
cache IDs through the stat cache."""

from portbench.metrics._common import per_build


def read(run):
    return per_build(run, "plan_s")
