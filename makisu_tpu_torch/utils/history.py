"""Build-history store: one compact JSONL record per build, durable
across processes — the first persistent perf-trajectory artifact.

Every observability layer so far (metrics, events, traces, ledger,
forensics) describes ONE build and dies with its files. A fleet needs
the trajectory: is the warm rebuild getting slower, did the cache
ratio regress after that refactor, which ISA route was this host on
when the number moved. This module is that record.

- ``--history-out FILE`` (or ``$MAKISU_TPU_HISTORY_DIR``, which
  resolves to ``<dir>/history.jsonl``) makes ``cli.main`` append one
  record per build/pull/push invocation: schema
  ``makisu-tpu.history.v1``, wall duration, phase self-times (via
  ``traceexport.phase_totals``), cache economics, bytes hashed per
  backend, the native ISA route, backend/mode identity, exit code.
  Appends are a single ``O_APPEND`` write per record, so concurrent
  builds (a loadgen run, parallel CI jobs) can share one file without
  interleaving partial lines.
- ``makisu-tpu history PATH...`` renders the trend: per-record rows
  plus duration/cache aggregates (p50/p99 via ``metrics.percentile``).
- ``makisu-tpu history diff A B`` compares two history sets and FLAGS
  regressions beyond ``--threshold`` (default 25%): duration p50/p99
  growth, cache hit-ratio and chunk dedup-ratio drops. Exit code 1
  when a regression is flagged — wired into CI as a perf gate.

Like the rest of the telemetry layer: stdlib-only, and never able to
fail a build (``cli.main`` guards the append).

Copy of ``makisu_tpu/utils/history.py``. The device-route and
warm-mode labels come from the port's own modules, looked up by name
so a history append never imports torch.
"""

from __future__ import annotations

import contextvars
import json
import os
import sys
import time
from typing import Any

from makisu_tpu_torch.utils import events, metrics

HISTORY_SCHEMA = "makisu-tpu.history.v1"

# Default filename inside $MAKISU_TPU_HISTORY_DIR.
HISTORY_BASENAME = "history.jsonl"

# Regression gate metrics: (key, direction). "up" flags growth beyond
# the threshold (latencies); "down" flags shrinkage (ratios where
# bigger is better).
_GATES: tuple[tuple[str, str], ...] = (
    ("duration_p50", "up"),
    ("duration_p99", "up"),
    ("cache_hit_ratio", "down"),
    ("chunk_dedup_ratio", "down"),
)


# Fleet provenance for the NEXT record this context appends: the
# worker binds it (from the front door's forwarded routing outcome)
# around each /build it serves, so a build that arrived via the fleet
# records WHERE it ran and WHY it was routed there — the signal
# `history diff` needs to attribute a latency swing to a routing-mix
# change instead of a code change.
_fleet_provenance: "contextvars.ContextVar[dict | None]" = \
    contextvars.ContextVar("makisu_torch_history_fleet", default=None)


def bind_fleet_provenance(info: dict):
    """Bind this build's fleet routing provenance (worker socket,
    verdict, attempts, quota wait) in the current context. Returns a
    reset token."""
    return _fleet_provenance.set(dict(info))


def reset_fleet_provenance(token) -> None:
    _fleet_provenance.reset(token)


def fleet_provenance() -> dict | None:
    return _fleet_provenance.get()


def resolve_out(flag: str) -> str:
    """The history path this invocation appends to: the explicit
    ``--history-out`` file wins; else ``$MAKISU_TPU_HISTORY_DIR/
    history.jsonl``; else "" (history off)."""
    if flag:
        return flag
    history_dir = os.environ.get("MAKISU_TPU_HISTORY_DIR", "")
    if history_dir:
        return os.path.join(history_dir, HISTORY_BASENAME)
    return ""


def probe_label() -> str:
    """This process's device-route probe verdict for the history
    record: ``ok`` | ``wedged`` | ``failed`` | ``pending`` |
    ``absent`` | ``disabled``. Resolved WITHOUT importing the device
    stack: if ``ops.backend`` was never imported, no probe ran —
    that's ``absent`` — and a pull/push must not pay a torch import for
    a telemetry label."""
    mod = sys.modules.get("makisu_tpu_torch.ops.backend")
    if mod is None:
        return "absent"
    try:
        return str(mod.probe_label())
    except Exception:  # noqa: BLE001 - a label must never fail a build
        return "absent"


def warm_mode_label() -> str:
    """This build's residency state for the history record:
    ``resident`` (session reused, dirty-set incremental), ``rescan``
    (session reused but re-certifying), ``fresh`` (new session),
    ``off`` (sessions disabled/bypassed), ``none`` (no build ran).
    Resolved via sys.modules like :func:`probe_label`: if the session
    module never loaded, no session engaged."""
    mod = sys.modules.get("makisu_tpu_torch.worker.session")
    if mod is None:
        return "none"
    try:
        return str(mod.warm_mode())
    except Exception:  # noqa: BLE001 - a label must never fail a build
        return "none"


def record_from_report(report: dict, command: str = "",
                       exit_code: int = 0,
                       **extra: Any) -> dict:
    """Distill one build's ``--metrics-out``-shaped report into the
    compact history record. Everything here is derived from series the
    registry already carries — history adds durability, not new
    instrumentation."""
    from makisu_tpu_torch.utils import traceexport
    top = traceexport.root_span(report)
    duration = float((top or {}).get("duration") or 0.0)
    cache = traceexport.cache_stats(report)
    hashed = traceexport.bytes_hashed_by_backend(report)
    chunk_added = chunk_reused = 0.0
    for series in (report.get("counters") or {}).get(
            "makisu_chunk_bytes_total", []):
        value = float(series.get("value", 0.0))
        if series.get("labels", {}).get("result") == "added":
            chunk_added += value
        elif series.get("labels", {}).get("result") == "reused":
            chunk_reused += value
    chunk_total = chunk_added + chunk_reused
    info_labels: dict = {}
    for series in (report.get("gauges") or {}).get(
            "makisu_build_info", []):
        info_labels = series.get("labels", {})
        break
    record = {
        "schema": HISTORY_SCHEMA,
        "ts": round(time.time(), 3),
        "trace_id": report.get("trace_id", ""),
        "command": command or report.get("command", ""),
        "exit_code": exit_code,
        "duration_seconds": round(duration, 6),
        "phase_self_seconds": {
            phase: round(seconds, 6)
            for phase, seconds in
            traceexport.phase_totals(report).items() if seconds},
        "cache": {
            "hits": int(cache["hit"]),
            "misses": int(cache["miss"]),
            "hit_ratio": round(cache["ratio"], 4),
            "chunk_bytes_added": int(chunk_added),
            "chunk_bytes_reused": int(chunk_reused),
            "chunk_dedup_ratio": round(chunk_reused / chunk_total, 4)
            if chunk_total else 0.0,
        },
        "bytes_hashed": {backend: int(n)
                         for backend, n in sorted(hashed.items())},
        "backend": info_labels.get("platform", ""),
        "native_isa": info_labels.get("native_isa", ""),
        "mode": info_labels.get("mode", ""),
        "hasher": info_labels.get("hasher", ""),
        # Device-route state during this build: `history diff` uses it
        # to attribute latency swings to route changes (a build whose
        # chunk hashing degraded to whole-layer caching because the
        # backend wedged is slower for reasons no code change made).
        "device_probe": probe_label(),
        # Residency state: a latency swing between `resident` and
        # `off`/`rescan` records is warm-state economics, not a code
        # regression — `history diff` names the change.
        "warm_mode": warm_mode_label(),
    }
    # Fleet provenance (bound by the worker when a build arrived via
    # the front door): worker socket + routing verdict + attempt count
    # + front-door quota wait. Absent on direct builds — its presence
    # IS the route label the routing-mix aggregate counts.
    fleet = fleet_provenance()
    if fleet is not None:
        record["fleet"] = dict(fleet)
    record.update(extra)
    return record


def append_record(path: str, record: dict) -> None:
    """Append one record as a single ``O_APPEND`` write (one line).
    POSIX append semantics keep concurrent writers' lines whole —
    loadgen's N simultaneous builds share one history file safely."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    line = json.dumps(record, separators=(",", ":"),
                      default=str) + "\n"
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, line.encode())
    finally:
        os.close(fd)


def read_history(path: str) -> list[dict]:
    """Load history records from a file, or every ``*.jsonl`` under a
    directory, ordered by timestamp. Unknown-schema lines are skipped
    (the set is open, like the event bus); torn final lines of a
    killed build are salvaged like every other JSONL artifact."""
    files: list[str]
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, name) for name in os.listdir(path)
            if name.endswith(".jsonl"))
    else:
        files = [path]
    records: list[dict] = []
    for name in files:
        for line in events.read_jsonl(name, skip_invalid=True):
            if line.get("schema") == HISTORY_SCHEMA:
                records.append(line)
    records.sort(key=lambda r: r.get("ts", 0.0))
    return records


# -- aggregation -----------------------------------------------------------


def aggregate(records: list[dict]) -> dict:
    """The digest ``history diff`` gates on: duration percentiles,
    pooled cache hit ratio, pooled chunk dedup ratio."""
    durations = [float(r.get("duration_seconds", 0.0))
                 for r in records]
    hits = sum(int(r.get("cache", {}).get("hits", 0)) for r in records)
    misses = sum(int(r.get("cache", {}).get("misses", 0))
                 for r in records)
    added = sum(int(r.get("cache", {}).get("chunk_bytes_added", 0))
                for r in records)
    reused = sum(int(r.get("cache", {}).get("chunk_bytes_reused", 0))
                 for r in records)
    out: dict[str, Any] = {
        "records": len(records),
        "failures": sum(1 for r in records
                        if int(r.get("exit_code", 0) or 0) != 0),
        "cache_hit_ratio": round(hits / (hits + misses), 4)
        if hits + misses else 0.0,
        "chunk_dedup_ratio": round(reused / (added + reused), 4)
        if added + reused else 0.0,
    }
    if durations:
        out["duration_p50"] = round(
            metrics.percentile(durations, 50), 6)
        out["duration_p99"] = round(
            metrics.percentile(durations, 99), 6)
        out["duration_max"] = round(max(durations), 6)
    # Dominant device-route label across the set (records without the
    # label — pre-PR-9 files — contribute nothing).
    probes: dict[str, int] = {}
    for r in records:
        label = r.get("device_probe")
        if label:
            probes[label] = probes.get(label, 0) + 1
    if probes:
        out["device_probe"] = max(sorted(probes), key=probes.get)
    # Dominant residency label (records without it — pre-session
    # files — contribute nothing).
    warm: dict[str, int] = {}
    for r in records:
        label = r.get("warm_mode")
        if label and label != "none":
            warm[label] = warm.get(label, 0) + 1
    if warm:
        out["warm_mode"] = max(sorted(warm), key=warm.get)
    # Routing mix: how these builds reached their process — "fleet"
    # (front-door provenance present) vs "direct" — plus the dominant
    # worker among fleet-routed records. A latency swing that rides a
    # routing change (warm affinity landing elsewhere, a failover-heavy
    # run) is topology, not code; `history diff` names it like the
    # device-route and warm-mode labels.
    # Alerts fired during these builds' windows (records carry the
    # per-invocation delta of makisu_alerts_fired_total). Summed, plus
    # a per-record rate — the signal `history diff` uses to say "the
    # candidate ran under an alert storm".
    alert_counts = [int(r.get("alerts_fired", 0) or 0)
                    for r in records if "alerts_fired" in r]
    if alert_counts:
        out["alerts_fired"] = sum(alert_counts)
        out["alert_rate"] = round(
            sum(alert_counts) / len(alert_counts), 4)
    via_fleet = [r for r in records if isinstance(r.get("fleet"), dict)]
    if records:
        out["routing"] = ("fleet" if len(via_fleet) * 2 > len(records)
                          else "direct")
        out["fleet_routed"] = len(via_fleet)
    workers: dict[str, int] = {}
    for r in via_fleet:
        worker = str(r["fleet"].get("worker", ""))
        if worker:
            workers[worker] = workers.get(worker, 0) + 1
    if workers:
        out["dominant_worker"] = max(sorted(workers), key=workers.get)
    # Storage-plane snapshot: the LATEST record carrying one (records
    # gain `storage_bytes` from the cached census — cli.main attaches
    # it when a census.json exists). Latest wins because disk usage is
    # a level, not a rate: the newest record IS the current state.
    for r in reversed(records):
        planes = r.get("storage_bytes")
        if isinstance(planes, dict) and planes:
            out["storage_bytes"] = dict(planes)
            break
    return out


def diff(a: list[dict], b: list[dict],
         threshold: float = 0.25) -> dict:
    """Compare history set ``b`` (candidate) against ``a`` (baseline)
    and flag regressions beyond ``threshold`` (a fraction: 0.25 flags
    a >25% p50 latency growth or a >25% relative hit-ratio drop).
    Ratios with no samples on either side are skipped, not flagged."""
    agg_a, agg_b = aggregate(a), aggregate(b)
    regressions: list[dict] = []
    if not a or not b:
        # No records on one side = no signal, not a regression — an
        # empty candidate file must fail loudly elsewhere (the caller
        # sees records: 0 in the rendered diff), not masquerade as a
        # 100% cache drop.
        return {"baseline": agg_a, "candidate": agg_b,
                "threshold": threshold, "regressions": [],
                "ok": True, "insufficient_records": True}
    for key, direction in _GATES:
        va, vb = agg_a.get(key), agg_b.get(key)
        if va is None or vb is None:
            continue
        if va <= 0:
            # Nothing to regress from (no baseline samples, or a zero
            # ratio): a gate needs a meaningful denominator.
            continue
        change = (vb - va) / va
        flagged = (change > threshold if direction == "up"
                   else change < -threshold)
        if flagged:
            regressions.append({
                "metric": key,
                "baseline": va,
                "candidate": vb,
                "change": round(change, 4),
            })
    result: dict[str, Any] = {
        "baseline": agg_a,
        "candidate": agg_b,
        "threshold": threshold,
        "regressions": regressions,
        "ok": not regressions,
    }
    # Device-route attribution: a p50/p99 swing alongside a route-state
    # change (ok → wedged: chunk hashing degraded to whole-layer
    # caching) is environment, not code — the diff names it so the
    # gate's reader doesn't chase a phantom regression.
    da, db = agg_a.get("device_probe"), agg_b.get("device_probe")
    if da and db and da != db:
        result["device_probe_change"] = {"baseline": da,
                                         "candidate": db}
    # Residency attribution: a latency delta alongside a warm-mode
    # flip (resident → off: every rebuild re-paid the scan/re-chunk
    # floor) is residency state, not code — name it.
    wa, wb = agg_a.get("warm_mode"), agg_b.get("warm_mode")
    if wa and wb and wa != wb:
        result["warm_mode_change"] = {"baseline": wa, "candidate": wb}
    # Routing-mix attribution: direct → fleet (or a dominant-worker
    # flip) changes which machine's warm state and disks served the
    # builds — name it next to the latency gates.
    ra, rb = agg_a.get("routing"), agg_b.get("routing")
    dwa = agg_a.get("dominant_worker")
    dwb = agg_b.get("dominant_worker")
    if (ra and rb and ra != rb) or (dwa and dwb and dwa != dwb):
        result["routing_change"] = {
            "baseline": ra, "candidate": rb,
            **({"baseline_worker": dwa, "candidate_worker": dwb}
               if dwa != dwb and (dwa or dwb) else {}),
        }
    # Alert-rate attribution: a candidate whose builds fired alerts
    # where the baseline's fired none (or at a rate grown beyond the
    # threshold) ran DEGRADED — SLO breaches during the measurement
    # window explain latency swings the perf gates would otherwise
    # pin on the code change. Named like the device-route/warm-mode/
    # routing attributions; skipped when neither side carries the
    # label (pre-SLO files).
    aa = agg_a.get("alert_rate")
    ab = agg_b.get("alert_rate")
    if aa is not None or ab is not None:
        aa_v = float(aa or 0.0)
        ab_v = float(ab or 0.0)
        grew = (ab_v > 0.0 and aa_v == 0.0) or (
            aa_v > 0.0 and (ab_v - aa_v) / aa_v > threshold)
        if grew:
            result["alert_rate_change"] = {
                "baseline": aa_v, "candidate": ab_v,
                "baseline_fired": int(agg_a.get("alerts_fired", 0)),
                "candidate_fired": int(agg_b.get("alerts_fired", 0)),
            }
    # Storage-growth gate: a content plane that grew beyond the
    # threshold between baseline and candidate is a retention leak the
    # perf gates can't see (the build got no slower — the disk just
    # filled). Skipped when either side lacks the snapshot (pre-PR-16
    # files), like every other optional label.
    sa = agg_a.get("storage_bytes") or {}
    sb = agg_b.get("storage_bytes") or {}
    growth: list[dict] = []
    for plane in sorted(set(sa) | set(sb)):
        if plane == "total":
            continue
        va = int(sa.get(plane, 0) or 0)
        vb = int(sb.get(plane, 0) or 0)
        if va <= 0:
            continue
        change = (vb - va) / va
        if change > threshold:
            growth.append({"plane": plane, "baseline": va,
                           "candidate": vb,
                           "change": round(change, 4)})
    if growth:
        result["storage_growth"] = growth
        result["ok"] = False
    return result


# -- renderers -------------------------------------------------------------


def _fmt_phases(phases: dict) -> str:
    return " ".join(f"{name}={seconds:.2f}s"
                    for name, seconds in sorted(
                        phases.items(), key=lambda kv: -kv[1])[:3])


def render_trends(records: list[dict], limit: int = 20) -> str:
    """The ``makisu-tpu history PATH`` output: aggregate digest plus
    the most recent ``limit`` records, oldest first."""
    lines = [f"build history — {len(records)} records"]
    if not records:
        return lines[0] + "\n"
    agg = aggregate(records)
    lines.append(
        f"duration p50 {agg.get('duration_p50', 0.0):.3f}s  "
        f"p99 {agg.get('duration_p99', 0.0):.3f}s  "
        f"max {agg.get('duration_max', 0.0):.3f}s")
    lines.append(
        f"cache hit ratio {100.0 * agg['cache_hit_ratio']:.1f}%  "
        f"chunk dedup {100.0 * agg['chunk_dedup_ratio']:.1f}%  "
        f"failures {agg['failures']}/{agg['records']}"
        + (f"  device route {agg['device_probe']}"
           if agg.get("device_probe") else "")
        + (f"  warm mode {agg['warm_mode']}"
           if agg.get("warm_mode") else ""))
    lines.append("")
    shown = records[-limit:]
    if len(records) > limit:
        lines.append(f"(showing last {limit} of {len(records)})")
    for r in shown:
        ts = time.strftime("%Y-%m-%d %H:%M:%S",
                           time.localtime(r.get("ts", 0.0)))
        cache = r.get("cache", {})
        lookups = cache.get("hits", 0) + cache.get("misses", 0)
        cache_part = (f"cache {100.0 * cache.get('hit_ratio', 0.0):.0f}%"
                      if lookups else "cache -")
        code = int(r.get("exit_code", 0) or 0)
        lines.append(
            f"  {ts}  {r.get('command', '?'):<6s}"
            f" {r.get('duration_seconds', 0.0):8.3f}s"
            f"  {cache_part:<10s}"
            f" {'ok' if code == 0 else f'exit {code}'}"
            + (f"  [{_fmt_phases(r['phase_self_seconds'])}]"
               if r.get("phase_self_seconds") else ""))
    return "\n".join(lines) + "\n"


def render_diff(result: dict) -> str:
    """The ``makisu-tpu history diff A B`` output."""
    agg_a, agg_b = result["baseline"], result["candidate"]
    lines = [
        "build history diff — baseline vs candidate "
        f"(threshold {100.0 * result['threshold']:.0f}%)",
        f"  records: {agg_a['records']} vs {agg_b['records']}",
    ]
    for key, _direction in _GATES:
        va, vb = agg_a.get(key), agg_b.get(key)
        if va is None or vb is None:
            continue
        flagged = any(r["metric"] == key
                      for r in result["regressions"])
        delta = ""
        if va:
            delta = f"  ({100.0 * (vb - va) / va:+.1f}%)"
        lines.append(f"  {key:<18s} {va:10.4f} → {vb:10.4f}{delta}"
                     + ("  ← REGRESSION" if flagged else ""))
    change = result.get("device_probe_change")
    if change:
        lines.append(
            f"  device route: {change['baseline']} → "
            f"{change['candidate']}  (latency deltas may be "
            f"device-route state, not code)")
    warm_change = result.get("warm_mode_change")
    if warm_change:
        lines.append(
            f"  warm mode: {warm_change['baseline']} → "
            f"{warm_change['candidate']}  (latency deltas may be "
            f"residency state, not code)")
    routing_change = result.get("routing_change")
    if routing_change:
        detail = f"{routing_change['baseline']} → " \
                 f"{routing_change['candidate']}"
        if routing_change.get("baseline_worker") \
                or routing_change.get("candidate_worker"):
            detail += (f" (worker "
                       f"{routing_change.get('baseline_worker') or '-'}"
                       f" → "
                       f"{routing_change.get('candidate_worker') or '-'})")
        lines.append(
            f"  routing mix: {detail}  (latency deltas may be fleet "
            f"placement, not code)")
    alert_change = result.get("alert_rate_change")
    if alert_change:
        lines.append(
            f"  alert rate: {alert_change['baseline']:g} → "
            f"{alert_change['candidate']:g} fired/build "
            f"({alert_change['baseline_fired']} → "
            f"{alert_change['candidate_fired']} total)  (candidate "
            f"ran under SLO alerts — latency deltas may be a degraded "
            f"fleet, not code)")
    growth = result.get("storage_growth") or []
    for g in growth:
        lines.append(
            f"  storage plane {g['plane']}: {g['baseline']} → "
            f"{g['candidate']} bytes "
            f"({100.0 * g['change']:+.1f}%)  ← GROWTH")
    lines.append("")
    if result["regressions"] or growth:
        names = ", ".join(
            [r["metric"] for r in result["regressions"]]
            + [f"storage:{g['plane']}" for g in growth])
        lines.append(f"REGRESSION: {names} beyond the "
                     f"{100.0 * result['threshold']:.0f}% threshold")
        if any(r["metric"].startswith("duration")
               for r in result["regressions"]):
            lines.append(
                "  attribute it to frames: capture profiles of both "
                "builds (--profile-out) and run `makisu-tpu profile "
                "diff BASELINE CANDIDATE`")
    else:
        lines.append("ok: no regression beyond the threshold")
    return "\n".join(lines) + "\n"
