"""``top``: live terminal view of a worker's (or a front door's) builds.

Copy of ``makisu_tpu/tools/top.py``: the same frame, character for
character, so either package's ``top`` reads either package's worker or
front door. Never imports torch.

Polls ``GET /builds`` + ``GET /healthz`` over the worker socket and
renders the operator's view of a fleet node: in-flight
builds with phase, progress-clock age, queue wait, and cache hit
rate; the admission queue's depth and latency digests; the transfer
plane's in-flight bytes. ``--once`` prints a single frame (scripts,
tests); otherwise the screen refreshes every ``--interval`` seconds
until interrupted.
"""

from __future__ import annotations

import time

_CLEAR = "\x1b[2J\x1b[H"


def _fmt_age(seconds: float) -> str:
    if seconds < 60:
        return f"{seconds:.1f}s"
    if seconds < 3600:
        return f"{int(seconds // 60)}m{int(seconds % 60):02d}s"
    return f"{int(seconds // 3600)}h{int(seconds % 3600 // 60):02d}m"


def _trunc(text: str, width: int) -> str:
    return text if len(text) <= width else text[:width - 1] + "…"


def _fleet_lines(fleet: dict, self_section: dict | None = None) -> list[str]:
    """The fleet section: one row per worker (state, load, resident
    sessions, poll age, peer-map ack, routing share) plus the
    scheduler's verdict tallies."""
    self_section = self_section or {}
    peer_map = self_section.get("peer_map", {})
    acked = peer_map.get("acked", {})
    stale = set(peer_map.get("stale_acks") or [])
    lines = [
        "",
        f"fleet — {len(fleet.get('workers', []))} workers   "
        f"front-door queued {fleet.get('frontdoor_waiting', 0)}   "
        f"tenant quota "
        f"{fleet.get('tenant_quota', 0) or 'off'}   "
        f"peer map v{fleet.get('peer_map_version', 0)}"
        + (f" ({len(stale)} stale ack(s))" if stale else ""),
        f"{'WORKER':<8s} {'STATE':<9s} {'ACTIVE':>6s} {'QUEUE':>6s} "
        f"{'SESS':>5s} {'POLL':>6s} {'PEERMAP':>8s} "
        f"{'ROUTED':>7s} {'STORAGE':>8s} {'HEALTH':>6s} "
        f"{'ALERTS':>6s}  SOCKET",
    ]
    from makisu_tpu_torch.utils.traceexport import fmt_bytes
    for w in fleet.get("workers", []):
        wid = w.get("id", "?")
        poll_age = w.get("last_poll_age_seconds")
        held = acked.get(wid)
        peermap = f"v{held}" if held is not None else "-"
        if wid in stale:
            peermap += "!"
        storage = w.get("storage") or {}
        stor = (fmt_bytes(storage.get("total_bytes", 0))
                if storage else "-")
        score = w.get("health_score")
        health_part = f"{score:.2f}" if score is not None else "-"
        digest = w.get("alerts") or {}
        active_alerts = int(digest.get("active", 0) or 0)
        # "2!" = two active alerts, at least one at page severity.
        alerts_part = "-" if not active_alerts else (
            f"{active_alerts}!" if int(digest.get("page", 0) or 0)
            else f"{active_alerts}")
        lines.append(
            f"{_trunc(wid, 8):<8s} "
            f"{w.get('state', '?'):<9s} "
            f"{w.get('active_builds', 0):>6d} "
            f"{w.get('queue_depth', 0):>6d} "
            f"{len(w.get('sessions', [])):>5d} "
            f"{_fmt_age(poll_age) if poll_age is not None else '-':>6s} "
            f"{peermap:>8s} "
            f"{w.get('routed_total', 0):>7d} "
            f"{stor:>8s} "
            f"{health_part:>6s} "
            f"{alerts_part:>6s}  "
            f"{_trunc(w.get('socket', ''), 36)}")
    totals = fleet.get("route_totals", {})
    if totals:
        lines.append("routing: " + "  ".join(
            f"{verdict} {n}" for verdict, n in sorted(totals.items())))
    return lines


def render_top(health: dict, builds: dict, socket_path: str) -> str:
    """One frame. Pure function of the two payloads, so tests (and
    any other consumer) can render canned snapshots. A fleet front
    door's payload (it carries a ``fleet`` section) gets the
    per-worker table appended and a WORKER column on build rows."""
    from makisu_tpu_torch.utils.traceexport import fmt_bytes
    queue = health.get("queue", {})
    wait = queue.get("wait_seconds", {})
    latency = queue.get("latency_seconds", {})
    cap = queue.get("max_concurrent_builds", 0)
    fleet = health.get("fleet")
    title = "fleet" if fleet else "top"
    lines = [
        f"makisu-tpu {title} — {socket_path}   "
        f"uptime {_fmt_age(health.get('uptime_seconds', 0.0))}   "
        f"active {health.get('active_builds', 0)}   "
        f"queued {builds.get('queue_depth', 0)}"
        + (f"/cap {cap}" if cap else " (no cap)"),
        f"builds ok/fail {health.get('builds_succeeded', 0)}"
        f"/{health.get('builds_failed', 0)}   "
        f"queue wait p50/p99 {wait.get('p50', 0.0):.2f}s/"
        f"{wait.get('p99', 0.0):.2f}s   "
        f"latency p50/p99 {latency.get('p50', 0.0):.2f}s/"
        f"{latency.get('p99', 0.0):.2f}s",
        f"transfer in-flight "
        f"{fmt_bytes(health.get('transfer_inflight_bytes', 0))}   "
        f"last progress "
        f"{health.get('last_progress_seconds', 0.0):.1f}s ago",
        "",
        f"{'ID':>4s} {'TENANT':<12s} {'STATE':<8s} {'PHASE':<6s} "
        f"{'QWAIT':>7s} {'AGE':>7s} {'PROG':>6s} {'CACHE':>6s}  "
        + (f"{'WORKER':<7s} " if fleet else "") + "TAG",
    ]
    rows = list(builds.get("inflight", []))
    for b in rows:
        cache = b.get("cache", {})
        consults = cache.get("kv_consults", 0)
        cache_part = (f"{100.0 * cache.get('kv_hit_ratio', 0.0):.0f}%"
                      if consults else "-")
        lines.append(
            f"{b.get('id', 0):>4d} "
            f"{_trunc(b.get('tenant') or '-', 12):<12s} "
            f"{b.get('state', '?'):<8s} "
            f"{b.get('phase') or '-':<6s} "
            f"{b.get('queue_wait_seconds', 0.0):>6.2f}s "
            f"{_fmt_age(b.get('age_seconds', 0.0)):>7s} "
            f"{_fmt_age(b.get('progress_age_seconds', 0.0)):>6s} "
            f"{cache_part:>6s}  "
            + (f"{_trunc(b.get('worker') or '-', 7):<7s} "
               if fleet else "")
            + f"{_trunc(b.get('tag') or b.get('command', ''), 28)}")
    if not rows:
        lines.append("  (no builds in flight)")
    if fleet:
        lines.extend(_fleet_lines(fleet, health.get("self")))
    recent = list(builds.get("recent", []))[:8]
    if recent:
        lines.append("")
        lines.append("recent:")
        for b in recent:
            code = b.get("exit_code")
            outcome = ("ok" if code == 0
                       else f"exit {code}" if code is not None else "?")
            lines.append(
                f"{b.get('id', 0):>4d} "
                f"{_trunc(b.get('tenant') or '-', 12):<12s} "
                f"{outcome:<8s} "
                f"wait {b.get('queue_wait_seconds', 0.0):.2f}s  "
                f"ran {b.get('elapsed_seconds', 0.0):.2f}s  "
                f"{_trunc(b.get('tag') or b.get('command', ''), 28)}")
    return "\n".join(lines) + "\n"


def run(args) -> int:
    from makisu_tpu_torch.worker import WorkerClient
    client = WorkerClient(args.socket)
    frames = 1 if args.once else args.count
    shown = 0
    while True:
        try:
            health = client.healthz()
            builds = client.builds()
        except (OSError, RuntimeError, ValueError) as e:
            print(f"worker on {args.socket} not reachable: {e}")
            return 1
        frame = render_top(health, builds, args.socket)
        if args.once or args.count:
            print(frame, end="")
        else:
            print(_CLEAR + frame, end="", flush=True)
        shown += 1
        if frames and shown >= frames:
            return 0
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0
