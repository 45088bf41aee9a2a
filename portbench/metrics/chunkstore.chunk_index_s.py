"""chunkstore.chunk_index_s: per build, the program's ``index_layer``
spans: each committed layer's index into the chunk store and its dedup
accounting (a part of ``chunkstore.index_s``)."""

from portbench.metrics._program import span_s


def read(run):
    return span_s(run, "index_layer")
