"""sha256_roofline: S1's least time over the window's chunks (the
chunk bytes read once, 8 bytes of metadata and 32 of digest per chunk;
1,040 ALU-only ops and 360 adds per live 64-byte block at the measured
SM clock) over the CUPTI time of every S1 launch in the traced window,
in %."""

import numpy as np

from portbench import peaks


def read(run):
    if run.trace is None or run.card is None:
        return None
    secs, launches = run.trace.op_seconds("sha256_spans_kernel")
    commits = [r["commit"] for r in run.records if r.get("commit")]
    if not launches or secs <= 0 or not commits:
        return None
    lengths = np.concatenate([np.fromiter((c.length for c in cm.chunks),
                                          dtype=np.int64)
                              for cm in commits])
    blocks = int(((lengths + 9 + 63) // 64).sum())
    rate = peaks.int32_ops_per_s(run.card["sms"], run.card["sm_hz"])
    least, _ = peaks.sha_bound_s(int(lengths.sum()), len(lengths), blocks,
                                 rate)
    return 100.0 * least / secs
