"""commit_GBps: the tar bytes of every commit the window ran over the time
from the window's start to the end of its last commit (10^9 bytes/s)."""


def read(run):
    recs = [r for r in run.records if r.get("tar_bytes")]
    if not recs or run.window_s <= 0:
        return None
    return sum(r["tar_bytes"] for r in recs) / run.window_s / 1e9
