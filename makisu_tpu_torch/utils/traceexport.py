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

Copy of ``makisu_tpu/utils/traceexport.py``: phase rules, Perfetto
export, critical path, phase and stage totals, the ``report`` text, and
the fleet half (:func:`assemble_fleet_trace` stitches the front door's
merged event log into one span tree per trace id,
:func:`fleet_perfetto_trace` exports it, :func:`render_fleet_report` is
``report --fleet``). The phase rules are the reference's: both packages'
span names and frame labels land in the same phases.
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


# -- cross-process fleet trace assembly ------------------------------------

FLEET_TRACE_SCHEMA = "makisu-tpu.fleet-trace.v1"


def assemble_fleet_trace(event_log: list[dict]) -> dict:
    """Reconstruct cross-process span trees from a merged event
    stream — the fleet front door's own span events plus the worker
    build events its forwarder tees back in (each tagged ``worker``).

    The stitch is structural, not heuristic: the worker adopted the
    front door's ``fleet_forward`` span as its registry root, so its
    top build span's ``parent_id`` IS that forward span's id — linking
    parents across processes builds one tree per trace id, failover
    attempts landing as sibling ``fleet_forward`` subtrees. Worker
    admission waits (``queue_wait`` events, stamped with the inbound
    trace ids) synthesize into spans so the front-door quota wait and
    the worker queue wait sit side by side on the timeline. Duplicate
    deliveries (an in-process fleet sees a worker's event both
    directly and via the tee) collapse by span id."""
    spans: dict[str, dict] = {}
    order: list[str] = []
    seen_waits: set[tuple] = set()
    seen_access: set[tuple] = set()
    wire: dict[str, dict[str, float]] = {}

    def note_wire(trace_id: str, kind: str, nbytes: float) -> None:
        per = wire.setdefault(trace_id or "?", {})
        per[kind] = per.get(kind, 0.0) + nbytes

    for ev in event_log:
        etype = ev.get("type")
        if etype == "span_start":
            sid = str(ev.get("span_id") or "")
            if not sid:
                continue
            if sid in spans:
                # Duplicate delivery: keep the first copy, but adopt
                # the worker tag if only the teed copy carries it.
                if ev.get("worker") and not spans[sid].get("source"):
                    spans[sid]["source"] = str(ev["worker"])
                continue
            span = {
                "name": str(ev.get("name", "?")),
                "span_id": sid,
                "parent_id": str(ev.get("parent_id") or ""),
                "trace_id": str(ev.get("trace_id") or ""),
                "start": float(ev.get("ts") or 0.0),
                "duration": None,
                "attrs": dict(ev.get("attrs") or {}),
                "children": [],
            }
            if ev.get("worker"):
                span["source"] = str(ev["worker"])
            spans[sid] = span
            order.append(sid)
        elif etype == "span_end":
            span = spans.get(str(ev.get("span_id") or ""))
            if span is not None and span["duration"] is None:
                span["duration"] = float(ev.get("duration") or 0.0)
                if ev.get("error"):
                    span["error"] = str(ev["error"])
        elif etype == "queue_wait":
            key = (ev.get("trace_id", ""), ev.get("parent_id", ""),
                   ev.get("ts", 0.0))
            if key in seen_waits:
                continue
            seen_waits.add(key)
            seconds = float(ev.get("seconds") or 0.0)
            end = float(ev.get("ts") or 0.0)
            sid = f"queue-wait-{len(seen_waits)}"
            span = {
                "name": "queue_wait",
                "span_id": sid,
                "parent_id": str(ev.get("parent_id") or ""),
                "trace_id": str(ev.get("trace_id") or ""),
                "start": end - seconds,
                "duration": seconds,
                "attrs": {"tenant": str(ev.get("tenant") or "")},
                "children": [],
            }
            if ev.get("worker"):
                span["source"] = str(ev["worker"])
            spans[sid] = span
            order.append(sid)
        elif etype == "serve_access":
            # An in-process fleet sees a worker's access row twice —
            # the direct emission and the shutdown ledger collection —
            # as byte-equal events (the AccessLog delivers the row
            # itself); dedupe on the row's identifying fields.
            key = (ev.get("ts"), ev.get("kind"), ev.get("name"),
                   ev.get("status"), ev.get("bytes"),
                   ev.get("trace_id"))
            if key in seen_access:
                continue
            seen_access.add(key)
            note_wire(str(ev.get("trace_id") or ""), "serve",
                      float(ev.get("bytes") or 0.0))
        elif etype == "registry_blob":
            note_wire("?", f"registry_{ev.get('direction', '?')}",
                      float(ev.get("bytes") or 0.0))

    # Trace ids flood down: a child span inherits its ancestors' trace
    # id when its own event predates adoption metadata (defensive —
    # span events all carry trace_id today).
    roots: list[dict] = []
    for sid in order:
        span = spans[sid]
        parent = spans.get(span["parent_id"])
        if parent is not None and parent is not span:
            if not span["trace_id"]:
                span["trace_id"] = parent["trace_id"]
            parent["children"].append(span)
        else:
            roots.append(span)
    for span in spans.values():
        span["children"].sort(key=lambda s: s["start"])

    by_trace: dict[str, list[dict]] = {}
    trace_order: list[str] = []
    for root in roots:
        tid = root["trace_id"] or "?"
        if tid not in by_trace:
            by_trace[tid] = []
            trace_order.append(tid)
        by_trace[tid].append(root)
    traces = []
    for tid in trace_order:
        tops = sorted(by_trace[tid], key=lambda s: s["start"])
        traces.append({
            "trace_id": tid,
            "spans": tops,
            "wire_bytes": {k: int(v) for k, v in
                           sorted(wire.get(tid, {}).items())},
        })
    shared_wire = {k: int(v) for k, v in sorted(wire.get("?",
                                                         {}).items())}
    return {
        "schema": FLEET_TRACE_SCHEMA,
        "traces": traces,
        "span_count": len(spans),
        "untraced_wire_bytes": shared_wire,
    }


def fleet_perfetto_trace(assembled: dict) -> dict:
    """Chrome trace-event JSON of an assembled fleet trace: one
    Perfetto PROCESS track per source — the front door plus each
    worker — so the cross-process handoff (forward span here, build
    span there) reads as a fleet, not a flattened single track."""
    pids: dict[str, int] = {"frontdoor": 1}
    meta: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": 1,
         "args": {"name": "makisu-tpu fleet front door"}},
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": 1,
         "args": {"name": "route"}},
    ]
    slices: list[dict] = []

    def pid_of(source: str) -> int:
        if source not in pids:
            pids[source] = len(pids) + 1
            meta.append({"name": "process_name", "ph": "M",
                         "pid": pids[source],
                         "args": {"name": f"worker {source}"}})
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": pids[source], "tid": 1,
                         "args": {"name": "build"}})
        return pids[source]

    for trace in assembled.get("traces", []):
        for top in trace.get("spans", []):
            for span, _depth in _walk(top):
                event = {
                    "name": span.get("name", "?"),
                    "ph": "X",
                    "ts": round(float(span.get("start", 0.0)) * 1e6,
                                3),
                    "dur": round(_duration(span) * 1e6, 3),
                    "pid": pid_of(span.get("source", "frontdoor")),
                    "tid": 1,
                    "cat": phase_of(span.get("name", "")),
                    "args": {"trace_id": trace.get("trace_id", "")},
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
    return {
        "traceEvents": meta + slices,
        "displayTimeUnit": "ms",
        "otherData": {
            "schema": assembled.get("schema", FLEET_TRACE_SCHEMA),
            "traces": [t.get("trace_id", "")
                       for t in assembled.get("traces", [])],
        },
    }


def _find_spans(top: dict, name: str) -> list[dict]:
    return [span for span, _ in _walk(top)
            if span.get("name") == name]


def render_fleet_report(assembled: dict, profile: dict | None = None) -> str:
    """The ``makisu-tpu report --fleet`` output: per trace, the
    cross-process critical path (whose total is the front door's wall
    time — the root IS the fleet_build span), the admission economics
    side by side (front-door quota wait vs worker queue wait), per-
    attempt routing (failover attempts as sibling subtrees), build
    phase self-times, and bytes on wire. ``profile`` (a merged
    ``makisu-tpu.profile.v1`` document, e.g. from ``profile --fleet
    --out``) appends the sampled where-did-the-cycles-go view beside
    the span-declared one."""
    traces = assembled.get("traces", [])
    lines = [f"makisu-tpu fleet trace report — {len(traces)} "
             f"trace(s), {assembled.get('span_count', 0)} span(s)"]
    for trace in traces:
        report_shape = {"spans": trace.get("spans", []),
                        "trace_id": trace.get("trace_id", "")}
        top = root_span(report_shape)
        if top is None:
            continue
        total = _duration(top)
        lines.append("")
        lines.append(f"trace {trace.get('trace_id', '?')} — "
                     f"{top.get('name', '?')}  wall {total:.3f}s")
        # Admission economics: the front door's quota wait vs the
        # worker's admission-queue wait, side by side.
        quota = sum(_duration(s)
                    for s in _find_spans(top, "fleet_admit"))
        queue = sum(_duration(s)
                    for s in _find_spans(top, "queue_wait"))
        lines.append(f"  front-door quota wait {quota:.3f}s   "
                     f"worker queue wait {queue:.3f}s")
        # Per-attempt routing: each fleet_forward subtree is one
        # attempt; >1 means failover happened inside this ONE trace.
        forwards = _find_spans(top, "fleet_forward")
        for f in sorted(forwards,
                        key=lambda s: int(s.get("attrs", {})
                                          .get("attempt", 0))):
            attrs = f.get("attrs", {})
            outcome = "failed" if f.get("error") else "ok"
            built = any(s.get("source") for s, _ in _walk(f)
                        if s is not f)
            lines.append(
                f"  attempt {attrs.get('attempt', '?')}: worker "
                f"{attrs.get('worker', '?')} ({attrs.get('verdict', '?')})"
                f"  {_duration(f):.3f}s  "
                f"{'built' if built else outcome}")
        phases = phase_totals(report_shape)
        lines.append("  build phases (self time): " + "  ".join(
            f"{phase}={phases[phase]:.3f}s" for phase in PHASES))
        wire = trace.get("wire_bytes", {})
        if wire:
            lines.append("  bytes on wire: " + "  ".join(
                f"{kind}={fmt_bytes(n)}"
                for kind, n in sorted(wire.items())))
        path = critical_path(report_shape)
        lines.append(f"  critical path (longest chain, total "
                     f"{total:.3f}s):")
        for hop in path:
            pct = 100.0 * hop["duration"] / total if total else 0.0
            attrs = hop["attrs"]
            label = hop["name"]
            detail = ", ".join(f"{k}={v}"
                               for k, v in sorted(attrs.items()))
            if detail:
                label += f" [{detail}]"
            indent = "  " * hop["depth"]
            lines.append(
                f"    {indent}{label:<40s} {hop['duration']:9.3f}s "
                f"{pct:5.1f}%  (self {hop['self']:.3f}s)")
    untraced = assembled.get("untraced_wire_bytes", {})
    if untraced:
        lines.append("")
        lines.append("untraced wire bytes: " + "  ".join(
            f"{kind}={fmt_bytes(n)}"
            for kind, n in sorted(untraced.items())))
    if profile and profile.get("samples"):
        from makisu_tpu_torch.utils import profiler
        total = profile["samples"]
        workers = profile.get("workers") or {}
        lines.append("")
        lines.append(
            f"fleet profile: {total} samples"
            + (f" across {len(workers)} worker(s)" if workers else "")
            + f", sampler overhead "
              f"{100.0 * profile.get('overhead_fraction', 0.0):.2f}%")
        phases = profile.get("phases") or {}
        if phases:
            lines.append("  sampled phase shares: " + "  ".join(
                f"{phase}={100.0 * phases.get(phase, 0) / total:.1f}%"
                for phase in PHASES if phases.get(phase)))
        for phase in sorted(phases):
            hot = profiler.dominant_frame(profile, phase)
            if hot:
                lines.append(f"  {phase:<6s} hottest frame {hot[0]} "
                             f"({hot[1]} samples)")
    return "\n".join(lines) + "\n"


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
