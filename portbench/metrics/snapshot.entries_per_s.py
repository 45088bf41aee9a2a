"""snapshot.entries_per_s: per build, the entries written into its layer
tars (the telemetry line's ``commit_entries``, the counter
``makisu_commit_entries_total``: files, directories and whiteouts) over
its ``commit.tar_write`` spans: the tar writer's per-file rate."""

from portbench.metrics._program import per_build


def read(run):
    def value(line):
        entries = line.get("commit_entries")
        seconds = (line.get("span_seconds") or {}).get("commit.tar_write")
        if entries is None or not seconds:
            return None
        return entries / seconds

    return per_build(run, value)
