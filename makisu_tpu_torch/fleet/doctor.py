"""``makisu-tpu doctor --fleet SOCKET``: cross-worker diagnosis.

The per-process forensics (``doctor BUNDLE``)
explain one process. A fleet fails in the seams BETWEEN processes:
a worker the scheduler believes dead, a peer map a restarted worker
silently lost, a tenant pinned at its quota while the fleet idles,
a sticky placement pointing at a worker whose session evaporated.
This module reads the front door's ``/healthz`` (fleet + self
sections) and renders those seams as a diagnosis — pure functions of
the payload, so tests feed canned snapshots.

Copy of ``makisu_tpu/fleet/doctor.py``: the same findings in the same
words, so either package's ``doctor --fleet`` prints the same diagnosis
of one front door. Never imports torch.
"""

from __future__ import annotations

# Alert severity → doctor finding severity (the two vocabularies
# predate each other: alerts page/warn/info, findings error/warning/
# info). Unknown alert severities map to warning — visible, not fatal.
_ALERT_SEVERITY = {"page": "error", "warn": "warning", "info": "info"}


def alert_findings(alerts: dict | None) -> list[dict]:
    """Findings from a ``GET /alerts`` payload (worker or fleet
    shape): every active alert becomes one finding, severity mapped
    through ``_ALERT_SEVERITY``. The fleet payload's per-worker
    sections contribute worker-tagged findings."""
    if not alerts:
        return []
    findings: list[dict] = []

    def add(active, worker: str = "") -> None:
        for a in active or []:
            name = a.get("rule", "?")
            if a.get("label"):
                name = f"{name}[{a['label']}]"
            detail = (f"alert {name} firing"
                      + (f" on worker {worker}" if worker else "")
                      + f": {a.get('message') or name}")
            if a.get("value") is not None \
                    and a.get("threshold") is not None:
                detail += (f" (value {a['value']:g} vs threshold "
                           f"{a['threshold']:g})")
            findings.append({
                "severity": _ALERT_SEVERITY.get(
                    str(a.get("severity")), "warning"),
                "kind": "alert",
                "rule": a.get("rule", "?"),
                "worker": worker,
                "detail": detail,
            })

    add(alerts.get("active"))
    for wid, payload in sorted((alerts.get("workers") or {}).items()):
        if isinstance(payload, dict):
            add(payload.get("active"), wid)
    return findings


def diagnose_fleet(health: dict,
                   alerts: dict | None = None) -> list[dict]:
    """Structured findings from a fleet front door's ``/healthz``
    payload (plus, when provided, its ``/alerts`` payload). Each
    finding: ``{"severity": "error"|"warning"|"info",
    "kind": ..., "detail": ...}``, most severe first."""
    findings: list[dict] = alert_findings(alerts)
    fleet = health.get("fleet") or {}
    self_section = health.get("self") or {}
    workers = fleet.get("workers") or []
    alive = [w for w in workers if w.get("alive")]

    # 1. Dead workers: the scheduler routes around them, but an
    # operator must know capacity is gone (and why the poll failed).
    for w in workers:
        if not w.get("alive"):
            age = w.get("last_poll_age_seconds")
            findings.append({
                "severity": "error",
                "kind": "dead_worker",
                "worker": w.get("id", "?"),
                "detail": f"worker {w.get('id', '?')} is DEAD "
                          f"({w.get('last_error') or 'no poll yet'}; "
                          f"last poll "
                          f"{age if age is not None else '?'}s ago, "
                          f"{w.get('consecutive_failures', 0)} "
                          f"consecutive failures) — capacity lost, "
                          f"its resident sessions will rebuild "
                          f"elsewhere cold",
            })
    # 1b. Per-worker alert digests from /healthz (poll-captured): when
    # the full /alerts payload wasn't fetched, the counts still name
    # which worker is paging.
    if alerts is None:
        for w in alive:
            digest = w.get("alerts") or {}
            active = int(digest.get("active", 0) or 0)
            if active:
                pages = int(digest.get("page", 0) or 0)
                findings.append({
                    "severity": "error" if pages else "warning",
                    "kind": "alert",
                    "worker": w.get("id", "?"),
                    "detail": f"worker {w.get('id', '?')} reports "
                              f"{active} active alert(s)"
                              f" ({pages} page) — `makisu-tpu alerts "
                              f"<socket>` for the rules",
                })
    # 2. Draining workers: deliberate, but worth naming (drain that
    # never concludes is an operator leak).
    for w in workers:
        if w.get("alive") and w.get("draining"):
            findings.append({
                "severity": "info",
                "kind": "draining_worker",
                "worker": w.get("id", "?"),
                "detail": f"worker {w.get('id', '?')} is draining "
                          f"({w.get('active_builds', 0)} builds "
                          f"still in flight; serving peer fetches)",
            })
    # 3. Stale peer maps: a worker holding (or acked at) a version
    # behind the scheduler's current one fetches chunks from a stale
    # membership — dead peers cost timeouts, new peers go unused.
    peer_map = self_section.get("peer_map") or {}
    version = peer_map.get("version",
                           fleet.get("peer_map_version", 0))
    acked = peer_map.get("acked") or {}
    for w in alive:
        wid = w.get("id", "?")
        held = acked.get(wid)
        if held is not None and held < version:
            findings.append({
                "severity": "warning",
                "kind": "stale_peer_map",
                "worker": wid,
                "detail": f"worker {wid} last acked peer map "
                          f"v{held} but the scheduler is at "
                          f"v{version} — its chunk exchange runs on "
                          f"stale membership until the next publish "
                          f"lands",
            })
    # 4. Quota starvation: a tenant pinned at its cap while builds
    # queue at the front door — the quota is doing its job, but a
    # persistently pinned tenant is a sizing signal.
    quota = int(fleet.get("tenant_quota", 0) or 0)
    waiting = int(fleet.get("frontdoor_waiting", 0) or 0)
    if quota > 0:
        for tenant, row in sorted((fleet.get("tenants")
                                   or {}).items()):
            if int(row.get("inflight", 0)) >= quota:
                findings.append({
                    "severity": "warning" if waiting else "info",
                    "kind": "quota_pinned",
                    "tenant": tenant,
                    "detail": f"tenant {tenant} is pinned at its "
                              f"quota ({row.get('inflight')}/{quota} "
                              f"in flight"
                              + (f"; {waiting} build(s) waiting at "
                                 f"the front door" if waiting
                                 else "") + ")",
                })
    # 5. Storage-plane findings: each worker's /healthz carries a
    # census digest — cached audit/scrub finding counts and
    # the chunk-CAS LRU-seed state. A worker reporting findings has
    # inconsistent content planes (dangling refs, orphaned twins,
    # scrub corruption); an unseeded LRU map means eviction decisions
    # there would be blind.
    for w in alive:
        wid = w.get("id", "?")
        storage = w.get("storage") or {}
        if not storage:
            continue
        s_findings = storage.get("findings") or {}
        total = int(s_findings.get("total", 0) or 0)
        if total:
            kinds = ", ".join(
                f"{kind}={count}" for kind, count in sorted(
                    (s_findings.get("kinds") or {}).items()))
            findings.append({
                "severity": "warning",
                "kind": "storage_findings",
                "worker": wid,
                "detail": f"worker {wid} reports {total} storage "
                          f"finding(s) ({kinds or 'unclassified'}) — "
                          f"run `makisu-tpu doctor --storage "
                          f"<socket>` against it for the object "
                          f"list",
            })
        seed = storage.get("lru_seed") or {}
        if seed.get("state") not in (None, "seeded"):
            findings.append({
                "severity": "info",
                "kind": "storage_unseeded",
                "worker": wid,
                "detail": f"worker {wid}'s chunk-CAS LRU map is "
                          f"{seed.get('state')} "
                          f"({seed.get('seeded_entries', 0)} "
                          f"entries seeded) — eviction dry-runs "
                          f"refuse until the seed completes",
            })
        # Budget digest (the content store's): a worker far over
        # its hot-tier byte budget is one the evictor cannot keep up
        # with — routing demotes it (pressure_demoted) and the disk
        # will fill unless the budget, tiering, or load changes.
        budget = storage.get("budget") or {}
        pressure = float(budget.get("pressure", 0.0) or 0.0)
        if pressure >= 1.25:
            findings.append({
                "severity": "warning",
                "kind": "storage_pressure",
                "worker": wid,
                "detail": f"worker {wid}'s hot tier is at "
                          f"{100.0 * pressure:.0f}% of its storage "
                          f"budget ({budget.get('hot_bytes', 0)} of "
                          f"{budget.get('budget_bytes', 0)} bytes; "
                          f"{budget.get('evictions_total', 0)} "
                          f"evictions so far) — routing demotes it "
                          f"until eviction catches up",
            })
    # 5a. Continuous-profiling vitals: each worker's /healthz carries
    # its sampler digest. A sampler past its overhead budget is
    # charging builds for its own observation; dropped stacks mean the
    # bounded fold table overflowed and the profile under-reports.
    for w in alive:
        wid = w.get("id", "?")
        prof = w.get("profiler") or {}
        if not prof.get("enabled"):
            continue
        overhead = float(prof.get("overhead_fraction", 0.0) or 0.0)
        if overhead > 0.02:
            findings.append({
                "severity": "warning",
                "kind": "profiler_overhead",
                "worker": wid,
                "detail": f"worker {wid}'s profiler measures "
                          f"{100.0 * overhead:.1f}% overhead (budget "
                          f"2%) at {prof.get('hz', 0):g} Hz — lower "
                          f"MAKISU_TPU_PROFILE_HZ there",
            })
        dropped = int(prof.get("dropped", 0) or 0)
        if dropped:
            findings.append({
                "severity": "info",
                "kind": "profiler_dropped",
                "worker": wid,
                "detail": f"worker {wid}'s profiler dropped {dropped} "
                          f"sample(s) at its folded-stack cap — its "
                          f"profiles under-report the long tail",
            })
    # 5b. Session-snapshot restore failures: each worker's fleet row
    # carries the snapshot-plane digest captured from its /sessions
    # poll (write/restore tallies + the last restore failure). A
    # worker refusing restores is paying cold rebuilds the snapshot
    # plane exists to avoid — the reason names why (stale, isa_change,
    # flag_identity, chunks_unavailable, corrupt, ...).
    for w in alive:
        wid = w.get("id", "?")
        snap = w.get("session_snapshot") or {}
        failed = (int(snap.get("restore_refused", 0) or 0)
                  + int(snap.get("restore_error", 0) or 0))
        if not failed:
            continue
        last = snap.get("last_restore_failure") or {}
        reason = str(last.get("reason", "") or "unknown")
        context = str(last.get("context", "") or "")
        findings.append({
            "severity": "warning",
            "kind": "snapshot_restore_failed",
            "worker": wid,
            "detail": f"worker {wid} failed {failed} session-"
                      f"snapshot restore(s) (last: {reason}"
                      + (f" on {context}" if context else "")
                      + f"; {int(snap.get('restore', 0) or 0)} "
                      f"succeeded) — its builds rebuild cold "
                      f"instead of restoring warm",
        })
    # 6. Placement-memo drift: the sticky memo says a context lives
    # on worker X, but no alive worker — or a DIFFERENT one — reports
    # the resident session. Routing still works (the memo re-places),
    # but warm state is not where the scheduler thinks it is.
    sessions_of = {w.get("id"): set(w.get("sessions") or [])
                   for w in alive}
    for context, wid in sorted((fleet.get("placements")
                                or {}).items()):
        holders = sorted(w for w, sess in sessions_of.items()
                         if context in sess)
        if wid not in sessions_of:
            findings.append({
                "severity": "warning",
                "kind": "placement_drift",
                "worker": wid,
                "detail": f"placement memo pins {context} to "
                          f"{wid}, which is not alive"
                          + (f" (session actually resident on "
                             f"{', '.join(holders)})" if holders
                             else " (no resident session anywhere — "
                                  "next build is cold)"),
            })
        elif holders and wid not in holders:
            findings.append({
                "severity": "info",
                "kind": "placement_drift",
                "worker": wid,
                "detail": f"placement memo pins {context} to {wid} "
                          f"but the resident session is on "
                          f"{', '.join(holders)} — next build pays "
                          f"a relocation",
            })
    severity_rank = {"error": 0, "warning": 1, "info": 2}
    findings.sort(key=lambda f: severity_rank.get(f["severity"], 3))
    return findings


def render_fleet_doctor(health: dict, socket_path: str = "",
                        alerts: dict | None = None) -> str:
    """The human rendering: front-door vitals, the per-worker table,
    then the diagnosis (alert findings first when ``/alerts`` was
    fetched)."""
    fleet = health.get("fleet") or {}
    self_section = health.get("self") or {}
    workers = fleet.get("workers") or []
    lines = [
        "makisu-tpu fleet doctor"
        + (f" — {socket_path}" if socket_path else ""),
        f"front door: status {health.get('status', '?')}   "
        f"uptime {health.get('uptime_seconds', 0.0):.0f}s   "
        f"active {health.get('active_builds', 0)}   "
        f"queued {fleet.get('frontdoor_waiting', 0)}   "
        f"last progress "
        f"{health.get('last_progress_seconds', 0.0):.1f}s ago",
    ]
    peer_map = self_section.get("peer_map") or {}
    ring = self_section.get("decision_ring") or {}
    if self_section:
        oldest = self_section.get("oldest_poll_age_seconds")
        lines.append(
            f"self: poll every "
            f"{self_section.get('poll_interval_seconds', '?')}s "
            f"(oldest poll "
            f"{oldest if oldest is not None else '?'}s)   "
            f"peer map v{peer_map.get('version', '?')} "
            f"({len(peer_map.get('stale_acks') or [])} stale ack(s))"
            f"   decisions rung {ring.get('size', 0)} "
            + " ".join(f"{k}={v}" for k, v in sorted(
                (ring.get('verdicts') or {}).items()))
            + f"   watchdog "
            + ("armed" if self_section.get("watchdog_armed")
               else "off"))
    lines.append("")
    from makisu_tpu_torch.utils import traceexport
    lines.append(f"{'WORKER':<8s} {'STATE':<9s} {'ACTIVE':>6s} "
                 f"{'QUEUE':>6s} {'SESS':>5s} {'PEERMAP':>8s} "
                 f"{'STORAGE':>8s}  LAST ERROR")
    acked = peer_map.get("acked") or {}
    for w in workers:
        wid = w.get("id", "?")
        held = acked.get(wid)
        storage = w.get("storage") or {}
        stor = (traceexport.fmt_bytes(storage.get("total_bytes", 0))
                if storage else "-")
        lines.append(
            f"{wid:<8s} {w.get('state', '?'):<9s} "
            f"{w.get('active_builds', 0):>6d} "
            f"{w.get('queue_depth', 0):>6d} "
            f"{len(w.get('sessions') or []):>5d} "
            f"{('v' + str(held)) if held is not None else '-':>8s} "
            f"{stor:>8s}  "
            f"{w.get('last_error') or '-'}")
    findings = diagnose_fleet(health, alerts)
    lines.append("")
    if not findings:
        lines.append("diagnosis: fleet healthy — no findings")
    else:
        lines.append(f"diagnosis ({len(findings)} finding(s)):")
        for f in findings:
            lines.append(f"  [{f['severity']:<7s}] {f['detail']}")
    return "\n".join(lines) + "\n"
