"""sink.compress_s.build: the "committed layer" records' ``compress_s``
(the native layer sink's seconds in C++ less the tap's: framing, both
digests, deflate or feeding pgzip's lanes, the blob's writes) per GiB of
the layers' tar bytes (the "indexed" records' ``bytes_total``), over the
window's builds."""

from portbench.metrics._common import GIB


def read(run):
    recs = [r for r in run.records if r.get("committed")
            and r.get("bytes_total")]
    if not recs:
        return None
    return sum(r["compress_s"] for r in recs) / (
        sum(r["bytes_total"] for r in recs) / GIB)
