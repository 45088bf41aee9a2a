"""Alert lifecycle: firing/resolved state with hysteresis, and sinks.

The SLO plane (``fleet/slo.py``) decides *whether* a rule is breached;
this module owns what happens next — the state machine between
``firing`` and ``resolved``, and every surface an alert transition
must reach:

- the **event bus**: transitions ride as ``alert`` events (so they
  land in flight-recorder bundles and ``--events-out`` files for
  free, like every other structured record in the repo);
- **metrics**: ``makisu_alerts_fired_total`` / ``_resolved_total``
  counters and the ``makisu_alert_active{rule,severity}`` gauge a
  threshold rule or dashboard reads directly;
- the **active-alert ring** served at ``GET /alerts`` on worker and
  fleet servers (bounded: active alerts plus a recently-resolved
  ring, so a flapping rule can't grow the payload without bound);
- an optional **webhook**: each transition POSTed as JSON to an
  operator-supplied HTTP endpoint (``--alert-webhook``), bounded
  timeout, outcome counted — a dead receiver costs a counter bump,
  never an evaluation tick.

Flap suppression lives here as *resolve hysteresis*: a firing alert
resolves only after ``resolve_after`` consecutive clear evaluations.
(The symmetric fire-side hysteresis — ``breach_for`` consecutive
breached ticks — belongs to the rule, so it lives in the evaluator.)

Like the rest of the telemetry layer: stdlib-only, import-cycle-free,
and never able to fail the thread that calls it. Copy of
``makisu_tpu/utils/alerts.py``: the schema, events, series and render
are the reference's, so either package's ``alerts`` reads the other's
payloads with the same text.
"""

from __future__ import annotations

import collections
import json
import threading
import time
import urllib.error
import urllib.request
from typing import Any

from makisu_tpu_torch.utils import events, metrics

ALERT_EVENT_TYPE = "alert"
ALERT_SCHEMA = "makisu-tpu.alert.v1"

# Severity vocabulary, worst-first — shared by the rule defs, the
# /alerts payload ordering, doctor's finding mapping, and the CLI
# render. Unknown severities sort last (the set is open the same way
# event types are).
SEVERITY_RANK = {"page": 0, "warn": 1, "info": 2}

# Recently-resolved ring size on the /alerts payload.
_RECENT_KEEP = 64

# Webhook delivery budget. A transition is worth one bounded POST; a
# slow receiver must not stall the evaluation loop behind it.
_WEBHOOK_TIMEOUT = 3.0


def severity_rank(severity: str) -> int:
    return SEVERITY_RANK.get(str(severity), len(SEVERITY_RANK))


def sort_alerts(alerts: list[dict]) -> list[dict]:
    """Severity-major ordering (page first), newest fire first within
    a severity — the order every render surface uses."""
    return sorted(alerts, key=lambda a: (
        severity_rank(a.get("severity", "")),
        -float(a.get("fired_ts", 0.0)),
        str(a.get("rule", "")), str(a.get("label", ""))))


class _AlertState:
    """One (rule, label) pair's lifecycle state."""

    __slots__ = ("rule", "label", "severity", "firing", "value",
                 "threshold", "message", "fired_ts", "resolved_ts",
                 "clear_streak", "fire_count")

    def __init__(self, rule: str, label: str, severity: str) -> None:
        self.rule = rule
        self.label = label
        self.severity = severity
        self.firing = False
        self.value: float | None = None
        self.threshold: float | None = None
        self.message = ""
        self.fired_ts = 0.0
        self.resolved_ts = 0.0
        self.clear_streak = 0
        self.fire_count = 0

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "rule": self.rule,
            "severity": self.severity,
            "state": "firing" if self.firing else "resolved",
            "message": self.message,
            "fired_ts": round(self.fired_ts, 3),
            "fire_count": self.fire_count,
        }
        if self.label:
            out["label"] = self.label
        if self.value is not None:
            out["value"] = round(float(self.value), 6)
        if self.threshold is not None:
            out["threshold"] = round(float(self.threshold), 6)
        if not self.firing and self.resolved_ts:
            out["resolved_ts"] = round(self.resolved_ts, 3)
            out["active_seconds"] = round(
                self.resolved_ts - self.fired_ts, 3)
        return out


class AlertManager:
    """Per-(rule, label) alert state machine plus every sink.

    ``observe`` is the single entry point: the evaluator calls it once
    per rule (per label) per tick with the breach verdict. Transitions
    return ``"fired"`` / ``"resolved"`` (steady states return
    ``None``) so callers — and tests — see exactly when the machine
    moved. Thread-safe; sink fan-out happens outside the lock."""

    def __init__(self, resolve_after: int = 2, webhook: str = "",
                 source: str = "") -> None:
        # resolve_after < 1 would resolve on the first clear tick with
        # no suppression at all; clamp to the minimum meaningful value.
        self.resolve_after = max(1, int(resolve_after))
        self.webhook = webhook
        self.source = source  # "worker"/"fleet": stamped on events
        self._mu = threading.Lock()
        self._states: dict[tuple[str, str], _AlertState] = {}
        self._recent: collections.deque[dict] = collections.deque(
            maxlen=_RECENT_KEEP)
        # Optional fired-hook for page-severity transitions: the
        # worker/fleet front door attach a profile-tail dump here, so
        # the moment a page fires there is a "where was the time going"
        # artifact next to the alert. Called outside the lock;
        # exceptions are swallowed (forensics never wedges the
        # evaluator).
        self.on_fire = None

    # -- state machine ----------------------------------------------------

    def observe(self, rule: str, breached: bool, *,
                severity: str = "warn", label: str = "",
                value: float | None = None,
                threshold: float | None = None,
                message: str = "") -> str | None:
        """Feed one evaluation of one rule (one label). Fire is
        immediate on ``breached`` (the evaluator already applied any
        ``breach_for`` fire-side hysteresis); resolve waits for
        ``resolve_after`` consecutive clear observations."""
        transition: str | None = None
        with self._mu:
            key = (rule, label)
            state = self._states.get(key)
            if state is None:
                if not breached:
                    return None  # never fired; nothing to track
                state = self._states[key] = _AlertState(
                    rule, label, severity)
            state.severity = severity
            if value is not None:
                state.value = value
            if threshold is not None:
                state.threshold = threshold
            if message:
                state.message = message
            if breached:
                state.clear_streak = 0
                if not state.firing:
                    state.firing = True
                    state.fired_ts = time.time()
                    state.resolved_ts = 0.0
                    state.fire_count += 1
                    transition = "fired"
            elif state.firing:
                state.clear_streak += 1
                if state.clear_streak >= self.resolve_after:
                    state.firing = False
                    state.resolved_ts = time.time()
                    state.clear_streak = 0
                    transition = "resolved"
                    self._recent.append(state.to_dict())
            payload = state.to_dict() if transition else None
        if transition:
            self._publish(transition, payload)
        return transition

    # -- reads ------------------------------------------------------------

    def active(self) -> list[dict]:
        with self._mu:
            rows = [s.to_dict() for s in self._states.values()
                    if s.firing]
        return sort_alerts(rows)

    def recent(self) -> list[dict]:
        with self._mu:
            return list(reversed(self._recent))

    def snapshot(self) -> dict[str, Any]:
        """The ``GET /alerts`` payload body."""
        active = self.active()
        counts: dict[str, int] = {}
        for a in active:
            sev = str(a.get("severity", ""))
            counts[sev] = counts.get(sev, 0) + 1
        return {
            "schema": ALERT_SCHEMA,
            "active": active,
            "recent": self.recent(),
            "counts": {"active": len(active), **counts},
        }

    def digest(self) -> dict[str, int]:
        """Cheap active-count summary for /healthz (polled every few
        seconds — must not serialize full alert rows)."""
        with self._mu:
            active = [s for s in self._states.values() if s.firing]
            return {
                "active": len(active),
                "page": sum(1 for s in active if s.severity == "page"),
                "warn": sum(1 for s in active if s.severity == "warn"),
            }

    # -- sinks ------------------------------------------------------------

    def _publish(self, transition: str, payload: dict) -> None:
        fields = dict(payload)
        if self.source:
            fields.setdefault("source", self.source)
        events.emit(ALERT_EVENT_TYPE, **fields)
        rule = payload.get("rule", "?")
        severity = payload.get("severity", "?")
        g = metrics.global_registry()
        if transition == "fired":
            g.counter_add(metrics.ALERTS_FIRED,
                          rule=rule, severity=severity)
            g.gauge_set(metrics.ALERT_ACTIVE, 1,
                        rule=rule, severity=severity)
        else:
            g.counter_add(metrics.ALERTS_RESOLVED,
                          rule=rule, severity=severity)
            g.gauge_set(metrics.ALERT_ACTIVE, 0,
                        rule=rule, severity=severity)
        if self.webhook:
            self._post_webhook(transition, payload)
        if (transition == "fired" and severity == "page"
                and self.on_fire is not None):
            try:
                self.on_fire(payload)
            except Exception:  # noqa: BLE001 - hook never wedges alerts
                events.emit("alert_hook_error",
                            rule=payload.get("rule", "?"))

    def _post_webhook(self, transition: str, payload: dict) -> None:
        """One bounded POST per transition. Failures are counted, not
        raised — a dead receiver must never wedge the evaluator."""
        body = json.dumps({
            "schema": ALERT_SCHEMA,
            "transition": transition,
            "source": self.source,
            "alert": payload,
        }, default=str).encode()
        req = urllib.request.Request(
            self.webhook, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        g = metrics.global_registry()
        try:
            with urllib.request.urlopen(
                    req, timeout=_WEBHOOK_TIMEOUT) as resp:
                result = "ok" if 200 <= resp.status < 300 else "error"
        except (urllib.error.URLError, OSError, ValueError):
            result = "error"
        g.counter_add(metrics.ALERT_WEBHOOK, result=result)


def render_alerts(snapshot: dict, heading: str = "") -> str:
    """Human render of one /alerts payload — the ``makisu-tpu alerts``
    subcommand's output, also reused by doctor. Pure function of the
    payload, so tests feed canned snapshots."""
    lines: list[str] = []
    if heading:
        lines.append(heading)
    active = sort_alerts(list(snapshot.get("active") or []))
    if not active:
        lines.append("no active alerts")
    else:
        lines.append(f"{len(active)} active alert"
                     f"{'s' if len(active) != 1 else ''}:")
        for a in active:
            name = a.get("rule", "?")
            if a.get("label"):
                name = f"{name}[{a['label']}]"
            age = time.time() - float(a.get("fired_ts", time.time()))
            detail = a.get("message", "")
            value = a.get("value")
            threshold = a.get("threshold")
            if value is not None and threshold is not None:
                detail += (f" (value {value:g} vs threshold "
                           f"{threshold:g})")
            lines.append(f"  [{a.get('severity', '?'):4s}] {name}: "
                         f"{detail} — firing {age:.0f}s")
    recent = list(snapshot.get("recent") or [])
    if recent:
        lines.append(f"recently resolved ({len(recent)}):")
        for a in recent[:8]:
            name = a.get("rule", "?")
            if a.get("label"):
                name = f"{name}[{a['label']}]"
            lines.append(
                f"  [{a.get('severity', '?'):4s}] {name}: resolved "
                f"after {a.get('active_seconds', 0):g}s")
    return "\n".join(lines)
