"""sha256_roofline.build: S1's least time over the chunks of the layers
that the window's builds committed (their KV entries' chunk lists: the
chunk bytes read once, 8 bytes of metadata and 32 of digest per chunk;
1,040 ALU-only ops and 360 adds per live 64-byte block at the measured
SM clock) over the CUPTI time of every S1 launch in the traced window,
in %."""

from portbench import peaks
from portbench.metrics._chunks import committed_lengths


def read(run):
    if run.trace is None or run.card is None:
        return None
    secs, launches = run.trace.op_seconds("sha256_spans_kernel")
    if not launches or secs <= 0:
        return None
    lengths = committed_lengths(run)
    if lengths is None:
        return None
    blocks = int(((lengths + 9 + 63) // 64).sum())
    rate = peaks.int32_ops_per_s(run.card["sms"], run.card["sm_hz"])
    least, _ = peaks.sha_bound_s(int(lengths.sum()), len(lengths), blocks,
                                 rate)
    return 100.0 * least / secs
