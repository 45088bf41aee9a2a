"""Helpers the metric readers share."""

GIB = float(1 << 30)


def per_build(run, key: str):
    """The mean of a build record's ``key`` over the window's builds, or
    None where no build holds it."""
    values = [r[key] for r in run.records if r.get(key) is not None]
    return sum(values) / len(values) if values else None


def per_gib(run, key: str):
    """Seconds of ``key`` per GiB of layer stream committed."""
    recs = [r for r in run.records if r.get(key) is not None
            and r.get("tar_bytes")]
    if not recs:
        return None
    return sum(r[key] for r in recs) / (sum(r["tar_bytes"] for r in recs)
                                        / GIB)


def idle_pct(run):
    """The share of the traced window in which nothing ran on the card."""
    if run.trace is None or run.trace.window_s <= 0 \
            or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
