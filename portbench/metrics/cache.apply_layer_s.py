"""cache.apply_layer_s: per build, the program's ``apply_layer`` spans:
each cache hit's layer read and folded into the build's tree (a part of
``cache.apply_s``)."""

from portbench.metrics._program import span_s


def read(run):
    return span_s(run, "apply_layer")
