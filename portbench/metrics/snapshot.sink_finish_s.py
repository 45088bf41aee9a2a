"""snapshot.sink_finish_s: per build, the program's ``commit.sink_finish``
spans: the sink's finish, the deflate's join and the chunk session's
drain (its last G1 and S1 launches and their digests)."""

from portbench.metrics._program import span_s


def read(run):
    return span_s(run, "commit.sink_finish")
