"""cache.apply_s: per build, the sum over its hits of the "applying
cached layer" record to the end of its step."""


def read(run):
    builds = [r for r in run.records if r.get("hits")]
    if not builds:
        return None
    return sum(r["apply_s"] for r in builds) / len(builds)
