"""chunkstore.probe_stat_pct: per build, the chunk store's dedup existence
answers that took a stat, over all its answers (a stat or the window's
listing of the digest's CAS shard), in %. From the telemetry line's
``chunk_probes`` (route -> count, the counter
``makisu_chunk_probes_total{route=listing|stat}``); None for a build
whose line lacks it or gave no answer."""

from portbench.metrics._program import per_build


def read(run):
    def value(line):
        probes = line.get("chunk_probes")
        if not isinstance(probes, dict) or not sum(probes.values()):
            return None
        return 100.0 * probes.get("stat", 0) / sum(probes.values())

    return per_build(run, value)
