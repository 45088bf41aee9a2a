"""Readers of what the program reports on itself: each build's last log
record, "build telemetry", carries ``span_seconds`` (span name -> seconds
over the build's span tree) and ``device_busy_seconds`` (the card's
kernel seconds, from CUDA timing events around each launch)."""

TELEMETRY = "build telemetry"


def telemetry(rec: dict) -> dict | None:
    """The "build telemetry" record of one build's log, or None."""
    for r in reversed(rec.get("log") or ()):
        if r.get("msg") == TELEMETRY:
            return r
    return None


def per_build(run, value):
    """The mean over the window's builds of ``value(line)``, over the
    builds whose telemetry line gives one; None where none does."""
    values = []
    for rec in run.records:
        line = telemetry(rec)
        v = value(line) if line is not None else None
        if v is not None:
            values.append(v)
    return sum(values) / len(values) if values else None


def span_s(run, *names: str):
    """Per build, the seconds of the spans named ``names`` (summed over
    the build's tree and the names), over the builds whose line holds
    one of them."""
    def value(line):
        spans = line.get("span_seconds")
        if not isinstance(spans, dict) or not any(n in spans for n in names):
            return None
        return sum(spans.get(n, 0.0) for n in names)

    return per_build(run, value)
