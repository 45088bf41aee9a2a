"""gear_roofline: G1's least time over the window's layer stream
(each byte read once, its candidate bit written once; bytes at the
published 3.35 TB/s, INT32 ops at the measured SM clock) over the CUPTI
time of every G1 launch in the traced window, in %."""

from portbench import peaks


def read(run):
    if run.trace is None or run.card is None:
        return None
    secs, launches = run.trace.op_seconds("gear_bitmap_kernel")
    stream = sum(r.get("tar_bytes") or 0 for r in run.records)
    if not launches or secs <= 0 or not stream:
        return None
    rate = peaks.int32_ops_per_s(run.card["sms"], run.card["sm_hz"])
    least, _ = peaks.gear_bound_s(stream, rate)
    return 100.0 * least / secs
