"""The port's telemetry layer held against the reference's.

The cases of the reference's tests/test_events.py, test_metrics.py and
test_trace_propagation.py that need no worker, fleet or HTTP cache KV,
run against makisu_tpu_torch; then one sequence of telemetry calls into
both packages' registries, ledgers and buses, whose artifacts must be
equal once ids and times are removed; then the port's own parts: its
separate globals, the device plane's counters, and the chunk session's
taps (per block, per launch and per stream)."""

import contextvars
import json
import re
import threading

import numpy as np
import pytest

from makisu_tpu_torch import cli
from makisu_tpu_torch.tools.miniregistry import MiniRegistry
from makisu_tpu_torch.utils import events, httputil, metrics


# -- the event bus -------------------------------------------------------

def test_emit_without_sink_is_noop():
    # Must simply not raise — instrumentation sites run unconditionally.
    events.emit("anything", value=1)
    assert not events.active()


def test_sink_receives_typed_timestamped_events():
    seen = []
    token = events.add_sink(seen.append)
    try:
        assert events.active()
        events.emit("cache", result="hit", cache_id="abc")
    finally:
        events.reset_sink(token)
    [event] = seen
    assert event["type"] == "cache"
    assert event["result"] == "hit"
    assert event["cache_id"] == "abc"
    assert isinstance(event["ts"], float)


def test_sinks_stack_and_raising_sink_is_swallowed():
    seen = []

    def bad_sink(event):
        raise RuntimeError("dead sink")

    t1 = events.add_sink(bad_sink)
    t2 = events.add_sink(seen.append)
    try:
        events.emit("step", phase="start")
    finally:
        events.reset_sink(t2)
        events.reset_sink(t1)
    assert len(seen) == 1


def test_raising_sink_counts_drop():
    """A swallowed sink failure must be visible: the drop lands in
    makisu_events_dropped_total (labeled by event type), so a lossy
    event log is detectable from /metrics."""
    from makisu_tpu_torch.utils import metrics

    g = metrics.global_registry()
    before = g.counter_total("makisu_events_dropped_total",
                             event_type="chunk_fetch")

    def bad_sink(event):
        raise RuntimeError("dead sink")

    token = events.add_sink(bad_sink)
    try:
        events.emit("chunk_fetch", route="pack")
        events.emit("chunk_fetch", route="blob")
    finally:
        events.reset_sink(token)
    after = g.counter_total("makisu_events_dropped_total",
                            event_type="chunk_fetch")
    assert after == before + 2


def test_global_sink_sees_every_context_and_removes():
    """A global sink observes events from bare threads (no context
    copy) — the worker's process-level flight recorder relies on it —
    and remove_global_sink detaches it (bound-method equality)."""
    seen = []
    sink = seen.append
    events.add_global_sink(sink)
    try:
        bare = threading.Thread(
            target=lambda: events.emit("global_probe"))
        bare.start()
        bare.join()
    finally:
        events.remove_global_sink(sink)
    events.emit("after_removal")
    assert [e["type"] for e in seen] == ["global_probe"]


def test_emit_stamps_progress_clock():
    before = events.last_emit_monotonic()
    events.emit("tick")  # no sink bound: still stamps
    assert events.last_emit_monotonic() >= before
    mark = events.last_emit_monotonic()
    events.note_progress()
    assert events.last_emit_monotonic() >= mark


def test_sink_is_context_scoped():
    """A sink bound in one context must be invisible to a bare thread
    (no copy_context) — the isolation that keeps concurrent worker
    builds' event streams separate."""
    seen = []
    leaked = []

    def probe():
        events.emit("leak_probe")

    token = events.add_sink(seen.append)
    try:
        bare = threading.Thread(target=probe)
        bare.start()
        bare.join()
        leaked = list(seen)
        # A thread that DOES carry the context delivers.
        carried = threading.Thread(
            target=contextvars.copy_context().run, args=(probe,))
        carried.start()
        carried.join()
    finally:
        events.reset_sink(token)
    assert leaked == []
    assert [e["type"] for e in seen] == ["leak_probe"]


def test_jsonl_writer_round_trip(tmp_path):
    path = str(tmp_path / "events.jsonl")
    writer = events.JsonlWriter(path)
    token = events.add_sink(writer)
    try:
        events.emit("build_start", command="build")
        events.emit("span_start", name="stage", span_id="ab" * 8)
        events.emit("build_end", exit_code=0)
    finally:
        events.reset_sink(token)
        writer.close()
    log = events.read_jsonl(path)
    assert [e["type"] for e in log] == \
        ["build_start", "span_start", "build_end"]
    # One event per line, compact separators, no trailing garbage.
    lines = (tmp_path / "events.jsonl").read_text().splitlines()
    assert len(lines) == 3
    assert all(json.loads(line) for line in lines)


def test_jsonl_writer_after_close_is_noop(tmp_path):
    writer = events.JsonlWriter(str(tmp_path / "e.jsonl"))
    writer.close()
    writer({"type": "late"})  # must not raise on the closed file
    assert (tmp_path / "e.jsonl").read_text() == ""


def test_read_jsonl_names_truncated_line(tmp_path):
    path = tmp_path / "torn.jsonl"
    path.write_text('{"ts": 1, "type": "ok"}\n{"ts": 2, "ty')
    with pytest.raises(ValueError, match=r"torn\.jsonl:2"):
        events.read_jsonl(str(path))


def test_read_jsonl_skips_blank_lines(tmp_path):
    path = tmp_path / "gaps.jsonl"
    path.write_text('{"type": "a"}\n\n{"type": "b"}\n')
    assert [e["type"] for e in events.read_jsonl(str(path))] == ["a", "b"]


def test_read_jsonl_skip_invalid_salvages_prefix(tmp_path):
    path = tmp_path / "torn.jsonl"
    path.write_text('{"type": "a"}\nnot json\n{"type": "b"}\n{"ty')
    assert [e["type"]
            for e in events.read_jsonl(str(path), skip_invalid=True)] \
        == ["a", "b"]


# -- the registry --------------------------------------------------------

# -- registry semantics ----------------------------------------------------


def test_counter_add_and_totals():
    reg = metrics.MetricsRegistry()
    reg.counter_add("hits", 1, result="hit")
    reg.counter_add("hits", 2, result="hit")
    reg.counter_add("hits", 5, result="miss")
    assert reg.counter_total("hits") == 8
    assert reg.counter_total("hits", result="hit") == 3
    assert reg.counter_total("hits", result="miss") == 5
    assert reg.counter_total("absent") == 0
    assert reg.counter_by_label("hits", "result") == {
        "hit": 3.0, "miss": 5.0}


def test_gauge_last_write_wins():
    reg = metrics.MetricsRegistry()
    reg.gauge_set("depth", 3)
    reg.gauge_set("depth", 7)
    assert reg.report()["gauges"]["depth"] == [
        {"labels": {}, "value": 7.0}]


def test_histogram_tracks_count_sum_min_max():
    reg = metrics.MetricsRegistry()
    for v in (0.5, 1.5, 4.0):
        reg.observe("lat", v)
    [series] = reg.report()["histograms"]["lat"]
    assert series["count"] == 3
    assert series["sum"] == 6.0
    assert series["min"] == 0.5
    assert series["max"] == 4.0


def test_span_tree_nesting_and_error():
    reg = metrics.MetricsRegistry()
    token = metrics.set_build_registry(reg)
    try:
        with metrics.span("outer", alias="0"):
            with metrics.span("inner"):
                pass
        with pytest.raises(ValueError):
            with metrics.span("failing"):
                raise ValueError("boom")
    finally:
        metrics.reset_build_registry(token)
    spans = reg.report()["spans"]
    assert [s["name"] for s in spans] == ["outer", "failing"]
    assert spans[0]["attrs"] == {"alias": "0"}
    assert [c["name"] for c in spans[0].get("children", [])] == ["inner"]
    assert spans[0]["duration"] is not None
    assert "ValueError: boom" in spans[1]["error"]


def test_writes_land_in_both_scopes():
    reg = metrics.MetricsRegistry()
    token = metrics.set_build_registry(reg)
    try:
        metrics.counter_add("test_dual_scope_total", 2)
    finally:
        metrics.reset_build_registry(token)
    assert reg.counter_total("test_dual_scope_total") == 2
    assert metrics.global_registry().counter_total(
        "test_dual_scope_total") >= 2


def test_concurrent_contexts_isolated():
    """Two threads with their own bound registries: counters and spans
    never cross (the contextvar scoping the worker relies on)."""
    regs = {}
    barrier = threading.Barrier(2)

    def one(i):
        reg = metrics.MetricsRegistry()
        regs[i] = reg
        token = metrics.set_build_registry(reg)
        try:
            barrier.wait(timeout=5)
            with metrics.span(f"build-{i}"):
                metrics.counter_add("test_iso_total", i + 1, who=str(i))
        finally:
            metrics.reset_build_registry(token)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(2):
        report = regs[i].report()
        assert [s["name"] for s in report["spans"]] == [f"build-{i}"]
        assert regs[i].counter_total("test_iso_total") == i + 1
        assert regs[i].counter_total("test_iso_total",
                                     who=str(1 - i)) == 0


def test_spawned_thread_inherits_context():
    """Threads started via contextvars.copy_context (async cache
    pushes, chunk uploads) report into the spawning build's registry."""
    import contextvars

    reg = metrics.MetricsRegistry()
    token = metrics.set_build_registry(reg)
    try:
        t = threading.Thread(
            target=contextvars.copy_context().run,
            args=(lambda: metrics.counter_add("test_inherit_total"),))
        t.start()
        t.join()
    finally:
        metrics.reset_build_registry(token)
    assert reg.counter_total("test_inherit_total") == 1


# -- Prometheus text format ------------------------------------------------


def test_prometheus_golden():
    reg = metrics.MetricsRegistry()
    reg.counter_add("makisu_cache_pull_total", 3, result="hit")
    reg.counter_add("makisu_cache_pull_total", 1, result="miss")
    reg.counter_add("makisu_bytes_hashed_total", 4096,
                    backend="python", path="layer_sink")
    reg.gauge_set("makisu_cache_push_queue_depth", 2)
    reg.observe("makisu_step_seconds", 0.25, buckets=(0.1, 1.0))
    expected = (
        '# TYPE makisu_bytes_hashed_total counter\n'
        'makisu_bytes_hashed_total{backend="python",path="layer_sink"}'
        ' 4096\n'
        '# TYPE makisu_cache_pull_total counter\n'
        'makisu_cache_pull_total{result="hit"} 3\n'
        'makisu_cache_pull_total{result="miss"} 1\n'
        '# TYPE makisu_cache_push_queue_depth gauge\n'
        'makisu_cache_push_queue_depth 2\n'
        '# TYPE makisu_step_seconds histogram\n'
        'makisu_step_seconds_bucket{le="0.1"} 0\n'
        'makisu_step_seconds_bucket{le="1"} 1\n'
        'makisu_step_seconds_bucket{le="+Inf"} 1\n'
        'makisu_step_seconds_sum 0.25\n'
        'makisu_step_seconds_count 1\n'
    )
    assert metrics.render_prometheus(reg) == expected


def test_prometheus_histogram_buckets_cumulative():
    """Multiple observations landing in one bucket must render as a
    monotonic cumulative ladder capped by _count (regression: buckets
    were double-cumulated, inflating every le above the value)."""
    reg = metrics.MetricsRegistry()
    reg.observe("lat", 0.002)
    reg.observe("lat", 0.002)
    reg.observe("lat", 0.3)
    out = metrics.render_prometheus(reg)
    assert 'lat_bucket{le="0.005"} 2' in out
    assert 'lat_bucket{le="0.01"} 2' in out
    assert 'lat_bucket{le="0.5"} 3' in out
    assert 'lat_bucket{le="60"} 3' in out
    assert 'lat_bucket{le="+Inf"} 3' in out
    assert 'lat_count 3' in out


def test_prometheus_label_escaping():
    reg = metrics.MetricsRegistry()
    reg.counter_add("weird_total", 1, msg='say "hi"\nback\\slash')
    out = metrics.render_prometheus(reg)
    assert r'msg="say \"hi\"\nback\\slash"' in out


def test_write_report_atomic_with_extras(tmp_path):
    """write_report lands complete JSON (tmp + os.replace) including
    caller extras, and stringifies non-JSON-native span attrs instead
    of failing the invocation."""
    import os

    reg = metrics.MetricsRegistry()
    token = metrics.set_build_registry(reg)
    try:
        with metrics.span("build", where=tmp_path):  # Path attr
            metrics.counter_add("makisu_layer_commits_total")
    finally:
        metrics.reset_build_registry(token)
    out = tmp_path / "report.json"
    metrics.write_report(str(out), reg, command="build", exit_code=0)
    report = json.loads(out.read_text())
    assert report["command"] == "build"
    assert report["exit_code"] == 0
    assert report["spans"][0]["attrs"]["where"] == str(tmp_path)
    assert not [p for p in os.listdir(tmp_path)
                if p.startswith("report.json.tmp.")]


# -- trace propagation ---------------------------------------------------

TRACEPARENT_RE = re.compile(r"^00-([0-9a-f]{32})-([0-9a-f]{16})-01$")


def trace_id_of(header: str) -> str:
    match = TRACEPARENT_RE.match(header)
    assert match, f"malformed traceparent {header!r}"
    return match.group(1)


# -- unit: header shape and injection point --------------------------------


def test_current_traceparent_is_w3c_shaped():
    assert TRACEPARENT_RE.match(metrics.current_traceparent())


def test_traceparent_names_bound_registry_and_open_span():
    reg = metrics.MetricsRegistry()
    token = metrics.set_build_registry(reg)
    try:
        with metrics.span("outer") as s:
            header = metrics.current_traceparent()
            assert trace_id_of(header) == reg.trace_id
            assert header.split("-")[2] == s.span_id
        # No open span: falls back to the registry's root span.
        assert metrics.current_traceparent().split("-")[2] == \
            reg.root.span_id
    finally:
        metrics.reset_build_registry(token)


class _RecordingTransport(httputil.Transport):
    def __init__(self) -> None:
        super().__init__()
        self.seen: list[dict] = []

    def round_trip(self, method, url, headers, body=None, timeout=60.0,
                   stream_to=None):
        self.seen.append(dict(headers))
        return httputil.Response(200, {}, b"ok")


def test_send_injects_traceparent():
    transport = _RecordingTransport()
    reg = metrics.MetricsRegistry()
    token = metrics.set_build_registry(reg)
    try:
        httputil.send(transport, "GET", "http://example/x")
    finally:
        metrics.reset_build_registry(token)
    [headers] = transport.seen
    assert trace_id_of(headers["traceparent"]) == reg.trace_id


def test_send_keeps_caller_traceparent():
    """An explicitly provided traceparent (a caller continuing an
    upstream trace) must not be clobbered."""
    transport = _RecordingTransport()
    upstream = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    httputil.send(transport, "GET", "http://example/x",
                  headers={"traceparent": upstream})
    assert transport.seen[0]["traceparent"] == upstream


# -- traceparent parse / adopt / reject ------------------------------------


def test_parse_traceparent_matrix():
    good = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    assert metrics.parse_traceparent(good) == ("ab" * 16, "cd" * 8)
    # Unknown (but well-formed) versions parse; ff is reserved-invalid.
    assert metrics.parse_traceparent("07-" + "ab" * 16 + "-"
                                     + "cd" * 8 + "-00") is not None
    bad = [
        "",                                              # empty
        "garbage",                                       # no fields
        "00-" + "ab" * 16 + "-" + "cd" * 8,              # 3 fields
        "00-" + "AB" * 16 + "-" + "cd" * 8 + "-01",      # uppercase
        "00-" + "ab" * 15 + "-" + "cd" * 8 + "-01",      # short trace
        "00-" + "ab" * 16 + "-" + "cd" * 7 + "-01",      # short span
        "00-" + "00" * 16 + "-" + "cd" * 8 + "-01",      # zero trace
        "00-" + "ab" * 16 + "-" + "00" * 8 + "-01",      # zero span
        "ff-" + "ab" * 16 + "-" + "cd" * 8 + "-01",      # version ff
        "00-" + "zz" * 16 + "-" + "cd" * 8 + "-01",      # non-hex
        None,
    ]
    for value in bad:
        assert metrics.parse_traceparent(value) is None, value


def test_registry_adopt_trace():
    reg = metrics.MetricsRegistry()
    reg.adopt_trace("ab" * 16, "cd" * 8)
    assert reg.trace_id == "ab" * 16
    assert reg.root.span_id == "cd" * 8
    token = metrics.set_build_registry(reg)
    try:
        # No open span: the header names the ADOPTED parent span, so
        # outbound requests chain under the upstream caller.
        assert metrics.current_traceparent() == \
            "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        with metrics.span("child") as s:
            assert s.parent_id == "cd" * 8
    finally:
        metrics.reset_build_registry(token)


def test_span_events_carry_trace_id():
    from makisu_tpu_torch.utils import events
    reg = metrics.MetricsRegistry()
    seen = []
    reg_token = metrics.set_build_registry(reg)
    sink_token = events.add_sink(seen.append)
    try:
        with metrics.span("traced"):
            pass
    finally:
        events.reset_sink(sink_token)
        metrics.reset_build_registry(reg_token)
    kinds = {e["type"]: e for e in seen}
    assert kinds["span_start"]["trace_id"] == reg.trace_id
    assert kinds["span_end"]["trace_id"] == reg.trace_id


# -- prometheus relabel / merge --------------------------------------------


def test_relabel_and_merge_prometheus():
    a = ("# TYPE m_total counter\n"
         'm_total{k="v"} 3\n'
         "m_total 1\n"
         "# TYPE h histogram\n"
         'h_bucket{le="1"} 2\n'
         "h_sum 1.5\n"
         "h_count 2\n")
    relabeled = metrics.relabel_prometheus(a, worker="w1")
    assert 'm_total{worker="w1",k="v"} 3' in relabeled
    assert 'm_total{worker="w1"} 1' in relabeled
    assert 'h_bucket{worker="w1",le="1"} 2' in relabeled
    merged = metrics.merge_prometheus([a, relabeled])
    lines = merged.splitlines()
    # One TYPE line per family, every family's samples in ONE group.
    assert lines.count("# TYPE m_total counter") == 1
    assert lines.count("# TYPE h histogram") == 1
    m_rows = [i for i, ln in enumerate(lines)
              if ln.startswith("m_total")]
    assert m_rows == list(range(m_rows[0], m_rows[0] + len(m_rows)))
    h_rows = [i for i, ln in enumerate(lines)
              if ln.startswith("h_")]
    assert h_rows == list(range(h_rows[0], h_rows[0] + len(h_rows)))
    assert 'h_sum{worker="w1"} 1.5' in merged


def test_build_requests_carry_build_trace_id(tmp_path):
    """A tiny build that pushes to the miniregistry: every registry
    request carries a traceparent whose trace id is the build's root
    trace id, as written to the --metrics-out report. (The reference's
    case also drives an HTTP cache KV, which the port does not have.)"""
    ctx = tmp_path / "ctx"
    ctx.mkdir()
    (ctx / "Dockerfile").write_text(
        "FROM scratch\nCOPY data.txt /data.txt\n")
    (ctx / "data.txt").write_text("trace propagation payload\n" * 32)
    (tmp_path / "root").mkdir()
    report_path = tmp_path / "report.json"

    with MiniRegistry() as registry:
        code = cli.main([
            "--metrics-out", str(report_path),
            "build", str(ctx), "-t", "trace/prop:1",
            "--push", registry.addr, "--hasher", "cpu",
            "--storage", str(tmp_path / "storage"),
            "--root", str(tmp_path / "root"),
        ], device="cpu")
        assert code == 0
        registry_requests = list(registry.state.requests)

    report = json.loads(report_path.read_text())
    trace_id = report["trace_id"]
    assert re.fullmatch(r"[0-9a-f]{32}", trace_id)
    assert registry_requests, "build issued no registry requests?"
    for method, path, header in registry_requests:
        assert trace_id_of(header) == trace_id, \
            f"{method} {path} carried foreign/absent trace {header!r}"


# -- the port against the reference ------------------------------------------

# Keys that differ between any two runs: ids, wall times, durations and
# the process sampler's readings.
_VOLATILE = {"trace_id", "span_id", "parent_id", "start", "duration", "ts",
             "resources", "pid"}


def _stable(value):
    if isinstance(value, dict):
        return {k: _stable(v) for k, v in value.items()
                if k not in _VOLATILE}
    if isinstance(value, list):
        return [_stable(v) for v in value]
    return value


def _drive(m):
    """One fixed sequence of span, counter, gauge and histogram calls
    into a fresh registry of metrics module ``m``; the port opens its
    own spans (``PORT_SPANS``) inside ``commit_layer`` besides."""
    reg = m.MetricsRegistry()
    token = m.set_build_registry(reg)
    try:
        with m.span("build", command="build"):
            with m.span("stage", alias="0", index=0):
                m.counter_add(m.STAGES_TOTAL)
                m.counter_add("makisu_cache_pull_total", result="hit")
                m.counter_add("makisu_cache_pull_total", 2, result="miss")
                m.counter_add("makisu_layer_bytes_total", 123456)
                m.gauge_set("makisu_transfer_queue_depth", 3)
                m.gauge_set(m.DEVICE_COMPILE_SECONDS, 0.25, bucket=4096)
                m.observe(m.DEVICE_DISPATCH_SECONDS, 0.004, bucket=4096)
                m.observe(m.DEVICE_DISPATCH_SECONDS, 0.3, bucket=4096)
                m.observe_batch("makisu_chunk_size_bytes",
                                [1500, 2048, 9000, 70000, 200000],
                                buckets=(1024.0, 2048.0, 8192.0, 65536.0))
                m.stage_busy_add("tar_write", 0.5)
                m.stage_queue_depth("compress", 2)
                with m.span("commit_layer", directive="COPY"):
                    m.counter_add("makisu_layer_commits_total")
                    for name in getattr(m, "PORT_SPANS", ()):
                        with m.span(name):
                            pass
            with pytest.raises(ValueError):
                with m.span("failing"):
                    raise ValueError("boom")
    finally:
        m.reset_build_registry(token)
    return reg


def _without_port_spans(spans):
    """The span dicts less exactly those named in ``PORT_SPANS``."""
    out = []
    for s in spans:
        if s["name"] in metrics.PORT_SPANS:
            continue
        s = dict(s)
        if "children" in s:
            s["children"] = _without_port_spans(s["children"])
            if not s["children"]:
                del s["children"]
        out.append(s)
    return out


def test_registry_report_and_prometheus_equal_the_reference():
    from makisu_tpu.utils import metrics as ref_metrics
    port, ref = _drive(metrics), _drive(ref_metrics)
    port_report = port.report()
    [commit] = port_report["spans"][0]["children"][0]["children"]
    assert [c["name"] for c in commit["children"]] == \
        list(metrics.PORT_SPANS)
    port_report["spans"] = _without_port_spans(port_report["spans"])
    assert _stable(port_report) == _stable(ref.report())
    assert metrics.render_prometheus(port) == \
        ref_metrics.render_prometheus(ref)
    assert metrics.summary(port).keys() == ref_metrics.summary(ref).keys()
    # The name constants the port only copies (planes not ported yet)
    # are the reference's, name for name.
    names = {k: v for k, v in vars(ref_metrics).items()
             if k.isupper() and isinstance(v, str)}
    assert {k: getattr(metrics, k, None) for k in names} == names


def test_port_counters_are_names_the_reference_never_writes():
    """The commit's entry count and mtime waits, and the chunk store's
    probe answers by route and shard listings, are the port's own
    (``PORT_COUNTERS``): no name of the reference's, so the telemetry
    parity tests leave them out; the build summary does not carry them."""
    from makisu_tpu.utils import metrics as ref_metrics
    assert metrics.COMMIT_ENTRIES == "makisu_commit_entries_total"
    assert metrics.CHUNK_PROBES == "makisu_chunk_probes_total"
    assert metrics.CHUNK_SHARD_LISTINGS == \
        "makisu_chunk_shard_listings_total"
    assert {metrics.COMMIT_ENTRIES, metrics.COMMIT_MTIME_WAITS,
            metrics.CHUNK_PROBES, metrics.CHUNK_SHARD_LISTINGS} == set(
        metrics.PORT_COUNTERS)
    ref_names = {v for k, v in vars(ref_metrics).items()
                 if k.isupper() and isinstance(v, str)}
    assert not set(metrics.PORT_COUNTERS) & ref_names
    reg = metrics.MetricsRegistry()
    token = metrics.set_build_registry(reg)
    try:
        with metrics.span("build"):
            metrics.counter_add(metrics.COMMIT_ENTRIES, 12)
            metrics.counter_add(metrics.COMMIT_ENTRIES, 30)
    finally:
        metrics.reset_build_registry(token)
    assert reg.counter_total(metrics.COMMIT_ENTRIES) == 42
    assert metrics.COMMIT_ENTRIES in reg.report()["counters"]
    assert not any("entries" in k or "probes" in k
                   for k in metrics.summary(reg))


def _ledger_lines(pkg, path):
    from importlib import import_module
    ev = import_module(f"{pkg}.utils.events")
    ledger = import_module(f"{pkg}.utils.ledger")
    writer = ledger.LedgerWriter(str(path), trace_id="ab" * 16,
                                 command="build")
    token = ev.add_sink(writer)
    try:
        with ledger.node_scope(stage="0", step=1, directive="COPY"):
            ledger.record("statcache", "5e1653a8", "miss", files=2,
                          hits=0, misses=2, changed_files=["a", "b"])
            ledger.record("kv", "5e1653a8", "miss", reason="absent")
            ledger.record("chunk_index", "7a" * 32, "indexed", chunks=33)
        ledger.record("kv", "a2aef502", "empty")
        ev.emit("build_end", exit_code=0)
    finally:
        ev.reset_sink(token)
        writer.close()
    return [_stable(json.loads(line))
            for line in path.read_text().splitlines()]


def test_ledger_writer_lines_equal_the_reference(tmp_path):
    port = _ledger_lines("makisu_tpu_torch", tmp_path / "port.jsonl")
    ref = _ledger_lines("makisu_tpu", tmp_path / "ref.jsonl")
    assert port == ref
    assert port[0]["schema"] == "makisu-tpu.ledger.v1"
    assert port[-1]["type"] == "summary"
    assert port[-1]["decisions"] == 4


def test_packages_keep_separate_globals():
    """Two of everything in one process: the port's registry, bus,
    profiler slot and resource sampler are its own, so a port build
    never touches the reference's."""
    from makisu_tpu.utils import events as ref_events
    from makisu_tpu.utils import metrics as ref_metrics
    from makisu_tpu.utils import profiler as ref_profiler
    from makisu_tpu.utils import resources as ref_resources
    from makisu_tpu_torch.utils import profiler, resources
    assert metrics.global_registry() is not ref_metrics.global_registry()
    assert metrics._build_registry is not ref_metrics._build_registry
    before = ref_metrics.render_prometheus(ref_metrics.global_registry())
    seen = []
    token = ref_events.add_sink(seen.append)
    try:
        metrics.counter_add("makisu_isolation_probe_total")
        events.emit("isolation_probe")
    finally:
        ref_events.reset_sink(token)
    assert seen == []
    assert ref_metrics.render_prometheus(
        ref_metrics.global_registry()) == before
    assert metrics.global_registry().counter_total(
        "makisu_isolation_probe_total") >= 1
    sampler = profiler.SamplingProfiler(hz=0.0)
    profiler.set_process_profiler(sampler)
    try:
        assert ref_profiler.process_profiler() is not sampler
    finally:
        profiler.set_process_profiler(None)
    assert resources.ResourceSampler is not ref_resources.ResourceSampler


# -- the device plane --------------------------------------------------------


def test_device_dispatch_series_and_health(monkeypatch):
    from makisu_tpu_torch.ops import backend
    monkeypatch.setattr(backend, "_dispatch_rings", {})
    monkeypatch.setattr(backend, "_compiled", set())
    reg = metrics.MetricsRegistry()
    token = metrics.set_build_registry(reg)
    try:
        backend.note_device_dispatch(1 << 20, 10, 10, 90000, 0.002,
                                     h2d_bytes=90080)
        backend.note_device_dispatch(1 << 20, 4, 4, 30000, 0.004,
                                     h2d_bytes=30032)
    finally:
        metrics.reset_build_registry(token)
    [hist] = reg.report()["histograms"][metrics.DEVICE_DISPATCH_SECONDS]
    assert hist["labels"] == {"bucket": str(1 << 20)}
    assert hist["count"] == 2
    # What crossed, not lanes x bucket; no padding ships.
    assert reg.counter_total(metrics.DEVICE_H2D_BYTES) == 90080 + 30032
    assert reg.counter_total(metrics.DEVICE_PADDING_WASTE) == 0
    [compile_s] = reg.report()["gauges"][metrics.DEVICE_COMPILE_SECONDS]
    assert compile_s["value"] == 0.002  # the first launch only
    assert backend.dispatch_stats()[str(1 << 20)]["count"] == 2
    health = backend.device_health()
    # The reference's keys, with the kernel wrappers' launch counts and
    # the card's allocated bytes beside them.
    assert set(health) == {"probe", "dispatch_seconds", "h2d_bytes",
                           "padding_waste_bytes", "kernel_launches",
                           "memory"}
    assert set(health["kernel_launches"]) == {"gear_bitmap", "sha256_spans",
                                              "sha256_multi"}


def test_probe_state_follows_the_device_plane(monkeypatch):
    """The device plane's state is its phased probe's: absent before it
    starts, pending while a phase runs, wedged past the budget, then ok
    or failed."""
    import threading

    from makisu_tpu_torch.ops import backend
    for name, value in (("_done", threading.Event()), ("_result", [None]),
                        ("_started", False), ("_probe_start", 0.0),
                        ("_timed_out", False), ("_grace_spent", False),
                        ("_tracker", backend._ProbeTracker())):
        monkeypatch.setattr(backend, name, value)
    assert backend.probe_label() == "absent"  # no probe started
    release = threading.Event()

    def parked(ctx):
        release.wait(10)

    monkeypatch.setattr(backend, "_phase_context_init", parked)
    monkeypatch.setattr(backend, "_phase_first_dispatch",
                        lambda ctx: (_ for _ in ()).throw(
                            RuntimeError("3 spans differ")))
    monkeypatch.setenv("MAKISU_TPU_PROBE_TIMEOUT", "0.3")
    backend.warm_probe(device="cpu")
    assert backend.probe_label() == "pending"
    assert backend.probe_snapshot()["phase"] == "context_init"
    assert backend.backend_ready() is not None
    assert backend.probe_label() == "wedged"
    release.set()
    assert backend.wait_for_probe_record(10)
    snap = backend.probe_snapshot()
    assert snap["state"] == "failed"
    assert snap["detail"] == "backend init failed: 3 spans differ"
    assert snap["phase_reached"] == "kernel_build"
    assert backend.device_health()["probe"]["state"] == "failed"


def test_parity_probe_exports_cost_and_verdict(monkeypatch):
    import torch

    from makisu_tpu_torch.ops import backend, sha256_cuda
    monkeypatch.setattr(sha256_cuda, "_probed", set())
    monkeypatch.setattr(backend, "_compiled", set())
    reg = metrics.MetricsRegistry()
    seen = []
    token = metrics.set_build_registry(reg)
    sink = events.add_sink(seen.append)
    try:
        sha256_cuda.parity_probe(torch.device("cpu"), max_len=256)
    finally:
        events.reset_sink(sink)
        metrics.reset_build_registry(token)
    [gauge] = reg.report()["gauges"]["makisu_device_parity_probe_seconds"]
    assert gauge["labels"] == {"bucket": "256", "result": "ok"}
    [probe] = [e for e in seen if e["type"] == "device_probe"]
    assert probe["status"] == "done" and probe["phase"] == \
        "sha_parity_probe"
    assert "cpu" in sha256_cuda._probed  # once per process and device


def test_chunk_session_taps_per_block_launch_and_stream(monkeypatch):
    """On the CPU route: gear-scan bytes are the stream's, one dispatch
    per S1 launch (one per ring pass), the device H2D counter equals the
    session's h2d_bytes, and one chunk-size fold per stream."""
    from makisu_tpu_torch.chunker import cdc
    monkeypatch.setattr(cdc.ChunkSession, "RING_BLOCKS", 4)
    data = np.random.default_rng(8).integers(
        0, 256, 5 * 4 * 32768 + 1000, dtype=np.uint8).tobytes()
    reg = metrics.MetricsRegistry()
    token = metrics.set_build_registry(reg)
    try:
        session = cdc.ChunkSession(block=32768, device="cpu")
        for i in range(0, len(data), 50000):
            session.update(data[i:i + 50000])
        chunks = session.finish()
    finally:
        metrics.reset_build_registry(token)
    assert session.span_launches == 6  # five full passes and the tail
    assert reg.counter_total("makisu_gear_scan_bytes_total") == len(data)
    assert reg.counter_total("makisu_bytes_hashed_total",
                             path="cdc") == len(data)
    [hist] = reg.report()["histograms"][metrics.DEVICE_DISPATCH_SECONDS]
    assert hist["count"] == session.span_launches
    assert hist["labels"] == {"bucket": str(4 * 32768)}
    assert reg.counter_total(metrics.DEVICE_H2D_BYTES) == session.h2d_bytes
    [sizes] = reg.report()["histograms"]["makisu_chunk_size_bytes"]
    assert sizes["count"] == len(chunks)
    assert sizes["sum"] == len(data)


# -- the logging plane -------------------------------------------------------


def test_log_records_reach_taps_and_the_build_sink():
    """Every record reaches the context's taps whatever its level, the
    build sink from its level up, and stamps the progress clock."""
    from makisu_tpu_torch.utils import logging as log
    tapped, sunk = [], []
    cell_token = events.bind_progress_cell()
    tap_token = log.add_tap(lambda *rec: tapped.append(rec))
    sink_token = log.set_build_sink(lambda *rec: sunk.append(rec),
                                    level="info")
    try:
        before = events.progress_cell()[0]
        log.debug("quiet %d", 1, k="v")
        log.info("loud", n=2)
        after = events.progress_cell()[0]
    finally:
        log.reset_build_sink(sink_token)
        log.reset_tap(tap_token)
        events.reset_progress_cell(cell_token)
    assert tapped == [("debug", "quiet 1", {"k": "v"}),
                      ("info", "loud", {"n": 2})]
    assert sunk == [("info", "loud", {"n": 2})]
    assert after >= before
    log.info("outside")  # no tap or sink bound any more
    assert len(tapped) == 2 and len(sunk) == 1
