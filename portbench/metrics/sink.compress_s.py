"""sink.compress_s: the native layer sink's seconds in C++ less the tap's
(framing, both digests, deflate or feeding pgzip's lanes, the blob's
writes) per GiB committed: ``NativeLayerSink.compress_seconds``."""

from portbench.metrics._common import per_gib


def read(run):
    return per_gib(run, "compress_s")
