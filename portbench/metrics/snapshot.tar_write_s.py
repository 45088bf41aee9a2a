"""snapshot.tar_write_s: per build, the program's ``commit.tar_write``
spans: the layer's tar write through the sink, with the native sink's
framing, digests, deflate and the chunk session's tap inside it."""

from portbench.metrics._program import span_s


def read(run):
    return span_s(run, "commit.tar_write")
