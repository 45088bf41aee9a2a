"""snapshot.commit_s: per build, the sum of its "committed layer"
records' ``commit_s``: the sync and the 1 s mtime wait, the tree diff,
the layer sink and the chunk session."""

from portbench.metrics._common import per_build


def read(run):
    return per_build(run, "commit_s")
