"""build_s: the window, from its start to the end of its last build, over
the builds it completed (edits and all)."""


def read(run):
    builds = [r for r in run.records if "committed" in r]
    if not builds:
        return None
    return run.window_s / len(builds)
