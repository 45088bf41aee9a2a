"""SLO plane: declarative rules, burn rates, and canary builds.

Copy of ``makisu_tpu/fleet/slo.py``:

- **Pure burn-rate math** (:func:`window_delta`, :func:`burn_rate`,
  :func:`multi_window_breach`): multi-window rate evaluation over
  timestamped snapshots of counters the repo already keeps. An alert
  fires only when both a fast window (default 5 min) and a slow window
  (default 1 h) are at or above threshold; the exact threshold fires.
- **Declarative rules** (:class:`SloRule`): ``burn_rate`` rules name a
  numerator/denominator counter pair; ``level`` rules threshold an
  instantaneous signal with ``breach_for`` consecutive-tick fire
  hysteresis. :func:`default_worker_rules` and
  :func:`default_fleet_rules` are the built-ins per tier;
  ``--slo-config`` JSON overrides or extends them by rule name.
- **The evaluator** (:class:`SloEvaluator`): a background thread that
  samples a caller-supplied ``probe()`` (the worker's or the front
  door's vitals) into bounded timestamped rings and feeds every rule's
  verdict to a ``utils.alerts.AlertManager``.
- **Canary builds** (:class:`CanaryDriver`, front door only): each
  sweep builds one tiny generated context (loadgen's template) directly
  on every alive worker and scores each worker's health as an EWMA of
  the outcomes; the score feeds the scheduler's health-demoted routing
  and the ``worker_health`` rule. Where the reference's canary hashes on
  the CPU, this one builds with ``--hasher gpu`` unless the caller asks
  for ``cpu``: a canary that never touches the card cannot see a card
  fault on a worker. Both hashers give the same digests.
"""

from __future__ import annotations

import collections
import http.client
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Callable, Iterable

from makisu_tpu_torch.utils import alerts as alerts_mod
from makisu_tpu_torch.utils import logging as log
from makisu_tpu_torch.utils import metrics

# Default multi-window pair (seconds): fast catches an active burn,
# slow keeps a blip from paging. Rules may override per-rule; the CI
# smoke scenario shrinks both so alerts fire in test time.
FAST_WINDOW = 300.0
SLOW_WINDOW = 3600.0

# Evaluator counter-ring bound: at the default 5s interval this holds
# well past the slow window; a runaway interval cannot grow it.
_RING_KEEP = 2048

# Health score: EWMA weight of the newest canary outcome, and the
# score at/below which the scheduler demotes a worker (the "page
# threshold" — two consecutive canary failures from a healthy 1.0
# land at 0.36, one success recovers to above it).
HEALTH_ALPHA = 0.4
HEALTH_PAGE_THRESHOLD = 0.5

_VALID_KINDS = ("burn_rate", "level")
_VALID_OPS = ("ge", "le")
_VALID_SEVERITIES = tuple(alerts_mod.SEVERITY_RANK)


# -- pure burn-rate math ----------------------------------------------------


def window_delta(samples: Iterable[tuple[float, float]],
                 window_seconds: float,
                 now: float | None = None) -> float | None:
    """Delta of a cumulative counter over the trailing window.

    ``samples`` are ``(monotonic_ts, value)`` pairs in ascending time
    order. Returns ``None`` when the ring cannot support a rate at
    all — empty, or a single sample (one point has no delta). With at
    least two samples the delta is always defined: the baseline is
    the newest sample at or before the window start, falling back to
    the oldest sample when the ring doesn't yet span the window (a
    partial window reads as "since the beginning" — the behavior that
    lets a fresh process alert before an hour of history exists).
    Counter resets (worker restart) clamp to 0 instead of reporting a
    negative burn."""
    pts = list(samples)
    if len(pts) < 2:
        return None
    if now is None:
        now = pts[-1][0]
    start = now - window_seconds
    baseline = pts[0]
    for ts, value in pts:
        if ts <= start:
            baseline = (ts, value)
        else:
            break
    return max(pts[-1][1] - baseline[1], 0.0)


def burn_rate(num_samples: Iterable[tuple[float, float]],
              den_samples: Iterable[tuple[float, float]],
              window_seconds: float,
              now: float | None = None) -> float | None:
    """Numerator delta ÷ denominator delta over one window. ``None``
    when either ring can't support the window or the denominator saw
    no activity (0/0 is "no traffic", not "all bad")."""
    num = window_delta(num_samples, window_seconds, now)
    den = window_delta(den_samples, window_seconds, now)
    if num is None or den is None or den <= 0:
        return None
    return num / den


def multi_window_breach(num_samples: Iterable[tuple[float, float]],
                        den_samples: Iterable[tuple[float, float]],
                        fast_window: float, slow_window: float,
                        threshold: float,
                        now: float | None = None
                        ) -> tuple[bool, float | None, float | None]:
    """``(breached, fast_rate, slow_rate)``: breached only when BOTH
    windows burn at or above threshold (``>=`` — exact threshold
    fires). Either window undefined → not breached (no data is never
    an outage)."""
    num = list(num_samples)
    den = list(den_samples)
    fast = burn_rate(num, den, fast_window, now)
    slow = burn_rate(num, den, slow_window, now)
    breached = (fast is not None and slow is not None
                and fast >= threshold and slow >= threshold)
    return breached, fast, slow


# -- rules ------------------------------------------------------------------


class SloRule:
    """One declarative rule. Plain data + validation; evaluation lives
    in :class:`SloEvaluator` so rules stay serializable."""

    def __init__(self, name: str, kind: str, severity: str = "warn",
                 threshold: float = 1.0,
                 numerator: str = "", denominator: str = "",
                 fast_window: float = FAST_WINDOW,
                 slow_window: float = SLOW_WINDOW,
                 signal: str = "", op: str = "ge",
                 breach_for: int = 1,
                 message: str = "") -> None:
        if kind not in _VALID_KINDS:
            raise ValueError(f"rule {name!r}: kind must be one of "
                             f"{_VALID_KINDS}, got {kind!r}")
        if severity not in _VALID_SEVERITIES:
            raise ValueError(f"rule {name!r}: severity must be one of "
                             f"{_VALID_SEVERITIES}, got {severity!r}")
        if op not in _VALID_OPS:
            raise ValueError(f"rule {name!r}: op must be one of "
                             f"{_VALID_OPS}, got {op!r}")
        if kind == "burn_rate" and not (numerator and denominator):
            raise ValueError(f"rule {name!r}: burn_rate rules need "
                             "numerator and denominator counter names")
        if kind == "level" and not signal:
            raise ValueError(f"rule {name!r}: level rules need a "
                             "signal name")
        self.name = name
        self.kind = kind
        self.severity = severity
        self.threshold = float(threshold)
        self.numerator = numerator
        self.denominator = denominator
        self.fast_window = float(fast_window)
        self.slow_window = float(slow_window)
        self.signal = signal
        self.op = op
        self.breach_for = max(1, int(breach_for))
        self.message = message

    @classmethod
    def from_dict(cls, raw: dict) -> "SloRule":
        if not isinstance(raw, dict) or not raw.get("name"):
            raise ValueError(f"rule entry must be an object with a "
                             f"name, got {raw!r}")
        return cls(
            name=str(raw["name"]),
            kind=str(raw.get("kind", "level")),
            severity=str(raw.get("severity", "warn")),
            threshold=float(raw.get("threshold", 1.0)),
            numerator=str(raw.get("numerator", "")),
            denominator=str(raw.get("denominator", "")),
            fast_window=float(raw.get("fast_window_seconds",
                                      raw.get("fast_window",
                                              FAST_WINDOW))),
            slow_window=float(raw.get("slow_window_seconds",
                                      raw.get("slow_window",
                                              SLOW_WINDOW))),
            signal=str(raw.get("signal", "")),
            op=str(raw.get("op", "ge")),
            breach_for=int(raw.get("breach_for", 1)),
            message=str(raw.get("message", "")),
        )

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "name": self.name, "kind": self.kind,
            "severity": self.severity, "threshold": self.threshold,
        }
        if self.kind == "burn_rate":
            out.update(numerator=self.numerator,
                       denominator=self.denominator,
                       fast_window_seconds=self.fast_window,
                       slow_window_seconds=self.slow_window)
        else:
            out.update(signal=self.signal, op=self.op,
                       breach_for=self.breach_for)
        if self.message:
            out["message"] = self.message
        return out


def default_worker_rules() -> list[SloRule]:
    """Built-in worker-tier rules over /healthz-grade signals: every
    signal already exists (quantile rings, health counters, census
    digest, device probe, progress clock) — the probe just snapshots
    them."""
    return [
        SloRule("build_error_burn", "burn_rate", severity="page",
                threshold=0.5, numerator="builds_failed",
                denominator="builds_started",
                message="build error ratio burning"),
        SloRule("build_latency_p99", "level", severity="warn",
                threshold=120.0, signal="build_latency_p99",
                breach_for=2,
                message="p99 build latency above target"),
        SloRule("tenant_latency_p99", "level", severity="warn",
                threshold=300.0, signal="tenant_latency_p99",
                breach_for=2,
                message="per-tenant p99 latency above target"),
        SloRule("queue_wait_share", "level", severity="warn",
                threshold=0.5, signal="queue_wait_share",
                breach_for=3,
                message="queue wait dominating build latency"),
        SloRule("progress_stall", "level", severity="page",
                threshold=120.0, signal="progress_age", breach_for=2,
                message="active builds with no observable progress"),
        SloRule("device_probe", "level", severity="page",
                threshold=1.0, signal="device_probe_bad",
                message="device probe wedged or failed"),
        SloRule("storage_budget", "level", severity="warn",
                threshold=float(48 * 1024 ** 3),
                signal="storage_total_bytes",
                message="storage planes above byte budget"),
    ]


def default_fleet_rules() -> list[SloRule]:
    """Built-in front-door rules over scheduler stats + canary series."""
    return [
        SloRule("build_latency_burn", "burn_rate", severity="page",
                threshold=0.5, numerator="canary_bad",
                denominator="canary_total",
                message="canary builds slow or failing"),
        SloRule("fleet_error_burn", "burn_rate", severity="page",
                threshold=0.5, numerator="builds_failed",
                denominator="builds_started",
                message="fleet build error ratio burning"),
        SloRule("worker_health", "level", severity="page",
                threshold=HEALTH_PAGE_THRESHOLD,
                signal="canary_health_score", op="le",
                message="worker health score at/below page threshold"),
        SloRule("canary_digest", "level", severity="page",
                threshold=1.0, signal="canary_digest_mismatch",
                message="canary digests diverged across workers"),
        SloRule("peer_map_stale", "level", severity="warn",
                threshold=1.0, signal="peer_map_lag", breach_for=3,
                message="peer map not acked by all alive workers"),
        SloRule("dead_worker", "level", severity="warn",
                threshold=1.0, signal="dead_workers", breach_for=2,
                message="fleet has dead workers"),
        SloRule("frontdoor_queue", "level", severity="warn",
                threshold=8.0, signal="frontdoor_queue", breach_for=3,
                message="front-door quota queue backing up"),
    ]


def load_rules(path: str,
               defaults: list[SloRule] | None = None) -> list[SloRule]:
    """Load ``--slo-config`` JSON and merge over ``defaults`` by rule
    name: an entry with a known name replaces the built-in (or drops
    it with ``"disabled": true``); an unknown name adds a rule. The
    file is either ``{"rules": [...]}`` or a bare list. Malformed
    input raises ``ValueError`` naming the problem — a bad config
    must fail startup loudly, not silently run without alerting."""
    import json
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    entries = raw.get("rules") if isinstance(raw, dict) else raw
    if not isinstance(entries, list):
        raise ValueError(f"{path}: expected a rule list or "
                         f'{{"rules": [...]}}')
    merged = {r.name: r for r in (defaults or [])}
    for entry in entries:
        if not isinstance(entry, dict) or not entry.get("name"):
            raise ValueError(f"{path}: each rule needs a name: "
                             f"{entry!r}")
        name = str(entry["name"])
        if entry.get("disabled"):
            merged.pop(name, None)
            continue
        base = merged.get(name)
        if base is not None:
            full = dict(base.to_dict())
            full.update(entry)
            merged[name] = SloRule.from_dict(full)
        else:
            merged[name] = SloRule.from_dict(entry)
    return list(merged.values())


# -- evaluator --------------------------------------------------------------


def _iter_labeled(value) -> list[tuple[str, float]]:
    """A probe value is a float (one unlabeled series) or a dict of
    label → float (per-tenant, per-worker)."""
    if isinstance(value, dict):
        return [(str(k), float(v)) for k, v in sorted(value.items())]
    return [("", float(value))]


def slo_interval_seconds() -> float:
    try:
        return float(os.environ.get(
            "MAKISU_TPU_SLO_INTERVAL_SECONDS", "5"))
    except ValueError:
        return 5.0


class SloEvaluator:
    """Background rule evaluation over a caller-supplied probe.

    ``probe()`` returns ``{"counters": {...}, "levels": {...}}`` —
    cumulative counters get sampled into timestamped rings for the
    burn-rate rules; levels are thresholded directly. Each value may
    be a float or a label→float dict (per-tenant, per-worker); a
    labeled series evaluates per label and alerts carry the label.

    ``tick`` is callable directly (tests, and the loadgen scenario's
    deterministic stepping); ``start`` runs it on a daemon thread."""

    def __init__(self, probe: Callable[[], dict],
                 rules: list[SloRule],
                 manager: alerts_mod.AlertManager | None = None,
                 interval: float | None = None,
                 webhook: str = "", source: str = "") -> None:
        self.probe = probe
        self.rules = list(rules)
        self.manager = manager or alerts_mod.AlertManager(
            webhook=webhook, source=source)
        self.interval = (slo_interval_seconds()
                         if interval is None else float(interval))
        self._rings: dict[tuple[str, str],
                          collections.deque] = {}
        self._streaks: dict[tuple[str, str], int] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- evaluation -------------------------------------------------------

    def tick(self, now: float | None = None) -> None:
        """One evaluation pass: sample the probe, feed every rule."""
        if now is None:
            now = time.monotonic()
        try:
            sample = self.probe() or {}
        except Exception as exc:  # noqa: BLE001 - never kills the loop
            log.debug("slo probe failed: %s", exc)
            return
        counters = sample.get("counters") or {}
        levels = sample.get("levels") or {}
        for name, value in counters.items():
            for label, v in _iter_labeled(value):
                ring = self._rings.setdefault(
                    (name, label),
                    collections.deque(maxlen=_RING_KEEP))
                ring.append((now, v))
        for rule in self.rules:
            try:
                if rule.kind == "burn_rate":
                    self._eval_burn(rule, now)
                else:
                    self._eval_level(rule, levels)
            except Exception as exc:  # noqa: BLE001 - rule isolation
                log.debug("slo rule %s failed: %s", rule.name, exc)

    def _eval_burn(self, rule: SloRule, now: float) -> None:
        labels = sorted({lbl for (name, lbl) in self._rings
                         if name == rule.numerator})
        for label in labels:
            num = self._rings.get((rule.numerator, label), ())
            den = self._rings.get((rule.denominator, label), ())
            breached, fast, slow = multi_window_breach(
                num, den, rule.fast_window, rule.slow_window,
                rule.threshold, now)
            message = rule.message
            if fast is not None and slow is not None:
                message += (f" [burn fast={fast:.3f} "
                            f"slow={slow:.3f}]")
            self.manager.observe(
                rule.name, breached, severity=rule.severity,
                label=label,
                value=fast if fast is not None else 0.0,
                threshold=rule.threshold, message=message)

    def _eval_level(self, rule: SloRule, levels: dict) -> None:
        raw = levels.get(rule.signal)
        seen: set[str] = set()
        if raw is not None:
            for label, value in _iter_labeled(raw):
                seen.add(label)
                breached_now = (value >= rule.threshold
                                if rule.op == "ge"
                                else value <= rule.threshold)
                key = (rule.name, label)
                streak = self._streaks.get(key, 0) + 1 \
                    if breached_now else 0
                self._streaks[key] = streak
                self.manager.observe(
                    rule.name, streak >= rule.breach_for,
                    severity=rule.severity, label=label,
                    value=value, threshold=rule.threshold,
                    message=rule.message)
        # A label that vanished from the probe (tenant aged out of the
        # ring, worker removed) reads as cleared — a firing alert must
        # not be immortal just because its subject disappeared.
        for key in [k for k in self._streaks
                    if k[0] == rule.name and k[1] not in seen]:
            self._streaks[key] = 0
            self.manager.observe(rule.name, False,
                                 severity=rule.severity,
                                 label=key[1], message=rule.message)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "SloEvaluator":
        if self.interval <= 0 or self._thread is not None:
            return self
        # Process-level evaluation thread: must not pin any build's
        # registry/log context.  # check: allow(ctx-propagation)
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="slo-evaluator")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.tick()

    def stop(self) -> None:
        self._stop.set()


# -- synthetic canary builds ------------------------------------------------


# -- synthetic canary builds ------------------------------------------------


def _canary_layer_digests(storage: str, tag: str) -> list[str]:
    """Layer digests of a built canary tag, read from the serving
    worker's storage — the same byte-identity oracle loadgen's fleet
    report uses."""
    from makisu_tpu_torch.docker.image import ImageName
    from makisu_tpu_torch.storage import ImageStore
    with ImageStore(storage) as store:
        manifest = store.manifests.load(ImageName.parse(tag))
        return [layer.digest.hex() for layer in manifest.layers]


class CanaryDriver:
    """Periodic synthetic builds through every alive worker.

    Each sweep builds one tiny generated context (reusing loadgen's
    template generator, so the content exercises the same base/src
    cache-node split real contexts do) directly against each alive
    worker with cooperative no-wait admission — a saturated or wedged
    worker answers with an immediate refusal instead of silently
    queueing canaries behind the fault, and a worker that accepts but
    stalls mid-build trips the bounded read timeout. Outcomes feed:

    - ``makisu_canary_builds_total{worker,result}`` and
      ``makisu_canary_latency_seconds{worker}``;
    - per-worker cumulative ``canary_total``/``canary_bad`` counters
      (a canary is *bad* when it fails OR exceeds ``slow_seconds``) —
      the ``build_latency_burn`` rule's inputs;
    - the EWMA health score pushed into the scheduler
      (``set_health_score``) for health-demoted routing;
    - cross-worker digest identity (healthy workers building the same
      context must produce byte-identical layers).
    """

    def __init__(self, scheduler, interval: float = 0.0,
                 timeout: float = 30.0, slow_seconds: float = 10.0,
                 work_dir: str = "", tenant: str = "_canary",
                 hasher: str = "gpu",
                 alpha: float = HEALTH_ALPHA) -> None:
        self.scheduler = scheduler
        self.interval = float(interval)
        self.timeout = float(timeout)
        self.slow_seconds = float(slow_seconds)
        self.tenant = tenant
        self.hasher = hasher
        self.alpha = float(alpha)
        self._cleanup = not work_dir
        self.work_dir = work_dir or tempfile.mkdtemp(
            prefix="makisu-canary-")
        self._ctx = os.path.join(self.work_dir, "ctx")
        self._mu = threading.Lock()
        self._totals: dict[str, int] = {}
        self._bads: dict[str, int] = {}
        self._scores: dict[str, float] = {}
        self._last: dict[str, dict] = {}
        self._digest_mismatch = False
        self._sweeps = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _ensure_context(self) -> None:
        if not os.path.isdir(os.path.join(self._ctx, "src")):
            from makisu_tpu_torch.tools import loadgen
            os.makedirs(self._ctx, exist_ok=True)
            # Tiny and fixed-seed: 2 files × 1 KiB — enough to walk
            # the full path (context scan, chunking, layer commit,
            # manifest) without becoming load.
            loadgen._make_template(self._ctx, 0, files=2, file_kb=1)

    def sweep(self) -> None:
        """One canary round across every alive worker, in parallel —
        a wedged worker's bounded failure must not delay a healthy
        sibling's probe."""
        self._ensure_context()
        targets = self.scheduler.canary_targets()
        threads = []
        for worker_id, socket_path, storage in targets:
            # check: allow(ctx-propagation)
            t = threading.Thread(
                target=self._probe_worker,
                args=(worker_id, socket_path, storage),
                daemon=True, name=f"canary-{worker_id}")
            t.start()
            threads.append(t)
        deadline = time.monotonic() + self.timeout + 5.0
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0.1))
        self._check_digests()
        with self._mu:
            self._sweeps += 1

    def _probe_worker(self, worker_id: str, socket_path: str,
                      storage: str | None) -> None:
        from makisu_tpu_torch.worker.client import WorkerClient
        root = os.path.join(self.work_dir, f"root-{worker_id}")
        os.makedirs(root, exist_ok=True)
        tag = f"makisu-canary/{worker_id}:latest"
        argv = ["--log-level", "error", "build", self._ctx,
                "-t", tag, "--hasher", self.hasher, "--root", root]
        if storage:
            argv += ["--storage", storage]
        client = WorkerClient(socket_path, timeout=self.timeout,
                              connect_timeout=min(self.timeout, 5.0),
                              retries=0)
        t0 = time.monotonic()
        ok = False
        error = ""
        try:
            code = client.build(argv, tenant=self.tenant,
                                no_wait=True)
            ok = code == 0
            if not ok:
                error = f"exit {code}"
        except (OSError, RuntimeError,
                http.client.HTTPException) as exc:
            error = f"{type(exc).__name__}: {exc}"
        elapsed = time.monotonic() - t0
        digests: list[str] = []
        if ok and storage:
            try:
                digests = _canary_layer_digests(storage, tag)
            except Exception as exc:  # noqa: BLE001 - telemetry only
                log.debug("canary digest read failed for %s: %s",
                          worker_id, exc)
        bad = (not ok) or elapsed >= self.slow_seconds
        g = metrics.global_registry()
        g.counter_add(metrics.CANARY_BUILDS, worker=worker_id,
                      result="ok" if ok else "error")
        g.observe(metrics.CANARY_LATENCY, elapsed, worker=worker_id)
        with self._mu:
            self._totals[worker_id] = \
                self._totals.get(worker_id, 0) + 1
            self._bads[worker_id] = \
                self._bads.get(worker_id, 0) + (1 if bad else 0)
            prev = self._scores.get(worker_id, 1.0)
            score = ((1.0 - self.alpha) * prev
                     + self.alpha * (0.0 if bad else 1.0))
            self._scores[worker_id] = score
            self._last[worker_id] = {
                "ok": ok, "bad": bad,
                "latency_seconds": round(elapsed, 3),
                "error": error, "digests": digests,
                "ts": round(time.time(), 3),
            }
        # set_health_score also publishes makisu_worker_health_score.
        self.scheduler.set_health_score(worker_id, score)

    def _check_digests(self) -> None:
        """Healthy workers building the identical context must land on
        identical layer digests — divergence is a worker with corrupt
        cache/storage state, the exact failure canaries exist to
        catch."""
        with self._mu:
            digest_sets = {tuple(row["digests"])
                           for row in self._last.values()
                           if row.get("ok") and row.get("digests")}
            self._digest_mismatch = len(digest_sets) > 1

    # -- probe surfaces ---------------------------------------------------

    def counters(self) -> dict[str, dict[str, float]]:
        with self._mu:
            return {
                "canary_total": {k: float(v) for k, v
                                 in self._totals.items()},
                "canary_bad": {k: float(v) for k, v
                               in self._bads.items()},
            }

    def levels(self) -> dict[str, Any]:
        with self._mu:
            return {
                "canary_health_score": dict(self._scores),
                "canary_digest_mismatch":
                    1.0 if self._digest_mismatch else 0.0,
            }

    def status(self) -> dict[str, Any]:
        """Per-worker canary state for /alerts and the fleet vitals."""
        with self._mu:
            return {
                "sweeps": self._sweeps,
                "digest_mismatch": self._digest_mismatch,
                "workers": {
                    wid: {
                        "score": round(self._scores.get(wid, 1.0), 4),
                        "total": self._totals.get(wid, 0),
                        "bad": self._bads.get(wid, 0),
                        **self._last.get(wid, {}),
                    }
                    for wid in sorted(self._totals)
                },
            }

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "CanaryDriver":
        if self.interval <= 0 or self._thread is not None:
            return self
        # check: allow(ctx-propagation)
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="canary-sweeps")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sweep()
            except Exception as exc:  # noqa: BLE001 - never dies
                log.debug("canary sweep failed: %s", exc)

    def stop(self) -> None:
        self._stop.set()
        if self._cleanup:
            shutil.rmtree(self.work_dir, ignore_errors=True)
