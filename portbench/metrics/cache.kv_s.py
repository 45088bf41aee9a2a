"""cache.kv_s: per build, the program's ``kv_pull`` and ``kv_push``
spans: every KV GET and SET attempt, the SETs on the build's push
threads included."""

from portbench.metrics._program import span_s


def read(run):
    return span_s(run, "kv_pull", "kv_push")
