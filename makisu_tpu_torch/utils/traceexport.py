"""Trace export and critical-path analysis of build telemetry reports.

Input everywhere is the ``--metrics-out`` report dict
(``metrics.MetricsRegistry.report()`` plus CLI extras): span tree,
counters, trace id. Two consumers:

- :func:`perfetto_trace` renders the span tree as Chrome/Perfetto
  trace-event JSON (the ``--trace-out`` file): complete ("X") events
  with microsecond timestamps, loadable in ui.perfetto.dev or
  chrome://tracing.
- :func:`render_report` is the ``makisu-tpu report`` subcommand's
  output: the longest span chain (the critical path through the nested
  timing tree — what to attack first to make the build faster), the
  top self-time sinks grouped into pull/chunk/hash/push phases, cache
  hit ratio, and bytes hashed per backend.

Self-time is a span's duration minus its children's — the time the
span itself burned. Summed over the tree it reconstructs the root's
wall time (concurrent children can push a span's child-sum past its
own duration; self-time floors at zero so aggregates stay sane).

Copy of the single-build half of ``makisu_tpu/utils/traceexport.py``
(phase rules, Perfetto export, critical path, phase and stage totals,
the ``report`` text). Its fleet half (``assemble_fleet_trace``,
``fleet_perfetto_trace``, ``render_fleet_report``) comes with the
port's fleet, the only producer of a fleet log. The phase rules are the
reference's: both packages' span names and frame labels land in the
same phases.
"""

from __future__ import annotations

from typing import Iterator

# Span-name substrings -> build phase, first match wins. Order matters:
# "pull_cache_layers" must classify as pull before "cache" could ever
# grow a phase of its own, and commit/hash both land in hash (layer
# commit IS the hashing path).
_PHASE_RULES: tuple[tuple[str, str], ...] = (
    ("pull", "pull"),
    ("from", "pull"),
    ("chunk", "chunk"),
    ("hash", "hash"),
    ("commit", "hash"),
    ("push", "push"),
)

PHASES = ("pull", "chunk", "hash", "push", "other")


def phase_of(span_name: str) -> str:
    name = span_name.lower()
    for needle, phase in _PHASE_RULES:
        if needle in name:
            return phase
    return "other"


def _walk(span: dict, depth: int = 0) -> Iterator[tuple[dict, int]]:
    yield span, depth
    for child in span.get("children", []):
        yield from _walk(child, depth + 1)


def _duration(span: dict) -> float:
    # Open spans (process died mid-span) carry null; treat as zero so
    # analysis of a torn report still works.
    return float(span.get("duration") or 0.0)


def root_span(report: dict) -> dict | None:
    """The invocation's top span (reports hold one top-level span per
    command; if several exist, the longest wins)."""
    spans = report.get("spans") or []
    if not spans:
        return None
    return max(spans, key=_duration)


# -- Perfetto / Chrome trace-event export ----------------------------------


def perfetto_trace(report: dict) -> dict:
    """Chrome trace-event JSON (the subset Perfetto loads) from a
    report's span tree. One complete ("X") slice per span; nesting
    falls out of timestamp containment on a single track. Span/trace
    ids and attrs ride in ``args`` so slices link back to event-log
    lines and server-side traceparent correlation."""
    trace_id = report.get("trace_id", "")
    slices: list[dict] = []
    for top in report.get("spans") or []:
        for span, _depth in _walk(top):
            event = {
                "name": span.get("name", "?"),
                "ph": "X",
                "ts": round(float(span.get("start", 0.0)) * 1e6, 3),
                "dur": round(_duration(span) * 1e6, 3),
                "pid": 1,
                "tid": 1,
                "cat": phase_of(span.get("name", "")),
                "args": {},
            }
            if span.get("span_id"):
                event["args"]["span_id"] = span["span_id"]
            if span.get("parent_id"):
                event["args"]["parent_id"] = span["parent_id"]
            if span.get("attrs"):
                event["args"].update(span["attrs"])
            if span.get("error"):
                event["args"]["error"] = span["error"]
            slices.append(event)
    out = {
        "traceEvents": [
            {"name": "process_name", "ph": "M", "pid": 1,
             "args": {"name": f"makisu-tpu {report.get('command', '')}"
                      .strip()}},
            {"name": "thread_name", "ph": "M", "pid": 1, "tid": 1,
             "args": {"name": "build"}},
            *slices,
        ],
        "displayTimeUnit": "ms",
    }
    if trace_id:
        out["otherData"] = {"trace_id": trace_id}
    return out


# -- critical path ---------------------------------------------------------


def critical_path(report: dict) -> list[dict]:
    """The longest span chain root→leaf: from each span, descend into
    the child that consumed the most wall time. Returns hops as
    ``{"name", "duration", "self", "depth", "attrs"}``; the first hop
    is the root, so the path's total IS the root's wall time — the
    chain tells you where that time concentrates."""
    top = root_span(report)
    if top is None:
        return []
    path: list[dict] = []
    span, depth = top, 0
    while span is not None:
        children = span.get("children", [])
        child_sum = sum(_duration(c) for c in children)
        path.append({
            "name": span.get("name", "?"),
            "duration": _duration(span),
            "self": max(_duration(span) - child_sum, 0.0),
            "depth": depth,
            "attrs": span.get("attrs", {}),
        })
        span = max(children, key=_duration) if children else None
        depth += 1
    return path


def self_time_by_name(report: dict) -> dict[str, float]:
    """Aggregate self-time per span name across the whole tree."""
    out: dict[str, float] = {}
    for top in report.get("spans") or []:
        for span, _depth in _walk(top):
            child_sum = sum(_duration(c)
                            for c in span.get("children", []))
            self_t = max(_duration(span) - child_sum, 0.0)
            name = span.get("name", "?")
            out[name] = out.get(name, 0.0) + self_t
    return out


def phase_totals(report: dict) -> dict[str, float]:
    """Self-time per build phase (pull/chunk/hash/push/other)."""
    totals = {phase: 0.0 for phase in PHASES}
    for name, self_t in self_time_by_name(report).items():
        totals[phase_of(name)] += self_t
    return totals


def open_spans_in(report: dict) -> list[dict]:
    """Spans with a null duration — open when the report was captured,
    i.e. the process died (or was snapshotted) mid-span. A finished
    build's report has none; a flight-recorder bundle's metrics
    snapshot typically has the whole stuck chain."""
    out = []
    for top in report.get("spans") or []:
        for span, depth in _walk(top):
            if span.get("duration") is None:
                out.append({
                    "name": span.get("name", "?"),
                    "depth": depth,
                    "start": float(span.get("start", 0.0)),
                    "attrs": span.get("attrs", {}),
                })
    return out


def resources_by_phase(report: dict) -> dict[str, dict[str, float]]:
    """Peak RSS and CPU seconds per build phase, from the per-span
    resource attribution the sampler recorded (utils/resources.py).
    Peak RSS is a max (it is a process-wide level observed while the
    span was open); CPU sums the per-leaf charges, so phases are
    roughly exclusive."""
    out: dict[str, dict[str, float]] = {}
    for top in report.get("spans") or []:
        for span, _depth in _walk(top):
            res = span.get("resources")
            if not res:
                continue
            phase = phase_of(span.get("name", ""))
            agg = out.setdefault(phase,
                                 {"peak_rss_bytes": 0.0,
                                  "cpu_seconds": 0.0})
            agg["peak_rss_bytes"] = max(agg["peak_rss_bytes"],
                                        float(res.get("peak_rss_bytes",
                                                      0)))
            agg["cpu_seconds"] += float(res.get("cpu_seconds", 0.0))
    return out


# -- counters --------------------------------------------------------------


def _counter_series(report: dict, name: str) -> list[dict]:
    return (report.get("counters") or {}).get(name, [])


def cache_stats(report: dict) -> dict[str, float]:
    by_result = {"hit": 0.0, "miss": 0.0, "empty": 0.0}
    for series in _counter_series(report, "makisu_cache_pull_total"):
        result = series.get("labels", {}).get("result", "")
        if result in by_result:
            by_result[result] += series.get("value", 0.0)
    lookups = by_result["hit"] + by_result["miss"]
    by_result["ratio"] = by_result["hit"] / lookups if lookups else 0.0
    return by_result


def bytes_hashed_by_backend(report: dict) -> dict[str, float]:
    out: dict[str, float] = {}
    for series in _counter_series(report, "makisu_bytes_hashed_total"):
        backend = series.get("labels", {}).get("backend", "?")
        out[backend] = out.get(backend, 0.0) + series.get("value", 0.0)
    return out


def commit_stage_busy(report: dict) -> dict[str, float]:
    """Busy seconds per layer-commit pipeline stage (tar_write,
    read_ahead, gear_scan, chunk_sha, compress) — the multicore
    commit's own breakdown. The busiest stage is the one to attack:
    it bounds commit throughput no matter how many workers the others
    get."""
    from makisu_tpu_torch.utils import metrics
    out: dict[str, float] = {}
    for series in _counter_series(report, metrics.COMMIT_STAGE_BUSY):
        stage = series.get("labels", {}).get("stage", "?")
        out[stage] = out.get(stage, 0.0) + series.get("value", 0.0)
    return out


# -- the `makisu-tpu report` text ------------------------------------------


def fmt_bytes(n: float) -> str:
    """Human byte count; shared by this report and `doctor`
    (utils/flightrecorder.py) so the two outputs can't drift."""
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return (f"{n:.1f}{unit}" if unit != "B"
                    else f"{int(n)}{unit}")
        n /= 1024
    return f"{n:.1f}GiB"  # pragma: no cover - loop always returns


_fmt_bytes = fmt_bytes  # internal call sites predate the public name


def render_report(report: dict, event_log: list[dict] | None = None,
                  capture_ts: float | None = None) -> str:
    """The ``makisu-tpu report`` output: critical path, phase
    breakdown, top time sinks, cache/hashing counters, resource usage
    per phase (when the sampler ran), and (with an event log) an
    event-type census. Handles a build that died mid-flight: open
    spans (null durations) are listed and marked, completed spans
    still get phase self-times, and ``capture_ts`` (a bundle's capture
    moment) substitutes for the missing root wall time."""
    lines: list[str] = []
    top = root_span(report)
    command = report.get("command") or (top or {}).get("name") or "?"
    lines.append(f"makisu-tpu build report — command: {command}")
    if report.get("trace_id"):
        lines.append(f"trace id: {report['trace_id']}")
    if top is None:
        lines.append("no spans recorded (empty report)")
        return "\n".join(lines) + "\n"
    total = _duration(top)
    died_open = top.get("duration") is None
    if died_open and capture_ts:
        total = max(capture_ts - float(top.get("start", capture_ts)), 0.0)
    lines.append(f"wall time: {total:.3f}s"
                 + ("  (build died mid-flight; root span never closed)"
                    if died_open else "")
                 + (f"  exit code: {report['exit_code']}"
                    if "exit_code" in report else ""))

    path = critical_path(report)
    lines.append("")
    lines.append(f"critical path (longest span chain, "
                 f"total {total:.3f}s):")
    for hop in path:
        pct = 100.0 * hop["duration"] / total if total else 0.0
        attrs = hop["attrs"]
        label = hop["name"]
        detail = ", ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        if detail:
            label += f" [{detail}]"
        indent = "  " * hop["depth"]
        lines.append(f"  {indent}{label:<40s} {hop['duration']:9.3f}s "
                     f"{pct:5.1f}%  (self {hop['self']:.3f}s)")

    open_spans = open_spans_in(report)
    if open_spans:
        lines.append("")
        lines.append(f"spans still open at capture ({len(open_spans)}) "
                     "— where the build was when it died:")
        for span in open_spans:
            detail = ", ".join(f"{k}={v}" for k, v in
                               sorted(span["attrs"].items()))
            label = span["name"] + (f" [{detail}]" if detail else "")
            indent = "  " * span["depth"]
            age = ""
            if capture_ts:
                age = f"  open {max(capture_ts - span['start'], 0.0):.1f}s"
            lines.append(f"  {indent}{label:<40s} ✱ open{age}")

    phases = phase_totals(report)
    lines.append("")
    lines.append("phase breakdown (self time, completed spans): "
                 + "  ".join(
                     f"{phase}={phases[phase]:.3f}s" for phase in PHASES))

    resources = resources_by_phase(report)
    if resources:
        lines.append("")
        lines.append("resource usage by phase (sampled):")
        for phase in PHASES:
            agg = resources.get(phase)
            if not agg:
                continue
            lines.append(
                f"  {phase:<6s} peak rss "
                f"{_fmt_bytes(agg['peak_rss_bytes']):>10s}   cpu "
                f"{agg['cpu_seconds']:8.3f}s")

    sinks = sorted(self_time_by_name(report).items(),
                   key=lambda kv: kv[1], reverse=True)[:5]
    lines.append("")
    lines.append("top time sinks (self time):")
    for name, self_t in sinks:
        pct = 100.0 * self_t / total if total else 0.0
        lines.append(f"  {name:<28s} {phase_of(name):<6s} "
                     f"{self_t:9.3f}s {pct:5.1f}%")

    cache = cache_stats(report)
    lines.append("")
    lines.append(f"cache: {int(cache['hit'])} hit / "
                 f"{int(cache['miss'])} miss / "
                 f"{int(cache['empty'])} empty  "
                 f"(hit ratio {100.0 * cache['ratio']:.1f}%)")

    hashed = bytes_hashed_by_backend(report)
    if hashed:
        per_backend = "  ".join(
            f"{backend}={_fmt_bytes(n)}"
            for backend, n in sorted(hashed.items()))
        lines.append(f"bytes hashed: {per_backend}"
                     + (f"  ({_fmt_bytes(sum(hashed.values()) / total)}/s)"
                        if total else ""))
    else:
        lines.append("bytes hashed: none recorded")

    stages = commit_stage_busy(report)
    if stages:
        lines.append("")
        lines.append("commit pipeline stages (busy time):")
        ordered = sorted(stages.items(), key=lambda kv: kv[1],
                         reverse=True)
        for i, (stage, busy) in enumerate(ordered):
            lines.append(f"  {stage:<12s} {busy:9.3f}s"
                         + ("  ← bottleneck" if i == 0 and busy else ""))

    if event_log is not None:
        census: dict[str, int] = {}
        for event in event_log:
            census[event.get("type", "?")] = \
                census.get(event.get("type", "?"), 0) + 1
        lines.append("")
        lines.append(f"event log: {len(event_log)} events  " + "  ".join(
            f"{t}={n}" for t, n in sorted(census.items())))
    return "\n".join(lines) + "\n"
