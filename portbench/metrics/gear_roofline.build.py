"""gear_roofline.build: G1's least time over the layer streams that the
window's builds committed (the sum of their KV entries' chunk lengths;
each byte read once, its candidate bit written once; bytes at the
published 3.35 TB/s, INT32 ops at the measured SM clock) over the CUPTI
time of every G1 launch in the traced window, in %."""

from portbench import peaks
from portbench.metrics._chunks import committed_lengths


def read(run):
    if run.trace is None or run.card is None:
        return None
    secs, launches = run.trace.op_seconds("gear_bitmap_kernel")
    if not launches or secs <= 0:
        return None
    lengths = committed_lengths(run)
    if lengths is None:
        return None
    rate = peaks.int32_ops_per_s(run.card["sms"], run.card["sm_hz"])
    least, _ = peaks.gear_bound_s(int(lengths.sum()), rate)
    return 100.0 * least / secs
