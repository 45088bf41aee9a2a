"""session.host_s: the chunk session's host seconds inside update() and
finish() per GiB committed: ``ChunkSession.host_seconds``."""

from portbench.metrics._common import per_gib


def read(run):
    return per_gib(run, "session_host_s")
