"""chunkstore.index_s: per build, the sum over its layers of the
"indexed" record less the "committed layer" record before it: the KV
write and the layer's index into the chunk store."""


def read(run):
    builds = [r for r in run.records if r.get("committed")]
    if not builds:
        return None
    return sum(r["index_s"] for r in builds) / len(builds)
