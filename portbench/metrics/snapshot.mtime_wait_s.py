"""snapshot.mtime_wait_s: per build, the program's ``commit.mtime_wait``
spans: the sleep that waits out tar's 1 s mtime granularity before a
layer's scan (the record's ``sync_s`` less it is the ``os.sync``)."""

from portbench.metrics._program import span_s


def read(run):
    return span_s(run, "commit.mtime_wait")
