"""Fleet scheduler core: worker registry + routing decisions.

Copy of ``makisu_tpu/fleet/scheduler.py``: the same policy, the same
consistent-hash ring (SHA-256 of ``"{worker id}#{v}"`` and of the context
key), so a port front door and a makisu_tpu front door place one context
on the same worker, and the same decision rows. ``build_identity``
resolves a build's context with this package's own parser.

The policy, in priority order (every decision lands on the event bus /
decision ledger as ``source=fleet`` and in ``makisu_fleet_route_total``):

1. **affinity** — the worker holding a resident build session for the
   build's context identity (polled from each worker's ``/sessions``,
   seeded by the scheduler's own sticky placement memo before the poll
   catches up). Landing on the session holder replays its resident
   session; landing anywhere else pays the cold path.
2. **spillover** — no session anywhere: consistent-hash placement over
   the alive workers (so future builds of the same context converge on
   one owner even across scheduler restarts), degrading to least-loaded
   when the hash owner is saturated past ``spillover_queue_depth``.
3. **failover** — the chosen worker was unreachable, refused admission
   (the ``X-Makisu-No-Wait`` 503), or died mid-stream: the next-best
   worker is chosen with the failed one excluded.
4. **quota_denied** — the tenant is at its in-flight quota: the build
   waits in the front door's FIFO (:class:`_SlotGate` — the worker
   admission queue's slot-transfer mechanics over front-door slots;
   strict arrival order, no barging) and the wait is recorded.

The scheduler also publishes the peer map (``POST /peers``) to every
live worker, so their chunk CASes consult each other before the
registry (``fleet/peers.py``).
"""

from __future__ import annotations

import collections
import hashlib
import json
import threading
import time

from makisu_tpu_torch.utils import ledger
from makisu_tpu_torch.utils import logging as log
from makisu_tpu_torch.utils import metrics

# Metric names: the shared set in utils/metrics.py (one definition for
# the scheduler, peers, the worker's /chunks endpoint, loadgen's report
# reads).
FLEET_ROUTE_TOTAL = metrics.FLEET_ROUTE_TOTAL
FLEET_WORKERS = metrics.FLEET_WORKERS
FLEET_FRONTDOOR_QUEUE = metrics.FLEET_FRONTDOOR_QUEUE
FLEET_TENANT_INFLIGHT = metrics.FLEET_TENANT_INFLIGHT
FLEET_QUOTA_WAIT = metrics.FLEET_QUOTA_WAIT
FLEET_RETRIES = metrics.FLEET_RETRIES

# Virtual nodes per worker on the consistent-hash ring: enough that a
# 3-worker fleet spreads new contexts near-evenly, cheap enough that
# ring rebuilds are free.
_VIRTUAL_NODES = 64

# Hot-tier occupancy/budget ratio past which spillover/failover skip a
# worker (pressure_demoted). 1.25 = 25% over budget: transiently over
# is the evictor's normal operating point right after a build lands —
# only a worker the evictor visibly cannot keep up with is demoted.
STORAGE_PRESSURE_THRESHOLD = 1.25

# Distinct tenants tracked with their own quota budget; overflow
# tenants share one "other" budget (same cardinality discipline as the
# worker's latency rings).
_TENANT_BUDGETS_KEEP = 64
_TENANT_OVERFLOW = "other"

# Recent routing decisions kept for GET /fleet.
_DECISIONS_KEEP = 128


class NoWorkersError(RuntimeError):
    """No eligible worker is alive (routing cannot proceed)."""


class _SlotGate:
    """FIFO admission gate over N slots — the worker admission queue's
    mechanics (a released slot transfers to the OLDEST waiter) applied
    to front-door quota/backpressure slots. A semaphore or condition
    wait would let new arrivals barge past already-blocked builds and
    starve them under a steady stream; strict arrival order is the
    fairness the quota exists to provide. (The transfer engine's
    MemoryBudget stays deliberately barging — small parts must pass a
    blocked oversized reservation — which is why it is not reused
    here.)"""

    def __init__(self, limit: int) -> None:
        self.limit = max(int(limit), 1)
        self._mu = threading.Lock()
        self._running = 0
        self._waiters: collections.deque[threading.Event] = \
            collections.deque()

    @property
    def inflight(self) -> int:
        with self._mu:
            return self._running

    def try_acquire(self) -> bool:
        """Take a slot iff one is free AND nobody is queued ahead."""
        with self._mu:
            if self._running < self.limit and not self._waiters:
                self._running += 1
                return True
            return False

    def acquire(self) -> None:
        with self._mu:
            if self._running < self.limit and not self._waiters:
                self._running += 1
                return
            gate = threading.Event()
            self._waiters.append(gate)
        gate.wait()

    def release(self) -> None:
        with self._mu:
            if self._waiters:
                # The slot transfers: _running stays constant.
                self._waiters.popleft().set()
            else:
                self._running = max(self._running - 1, 0)


class WorkerSpec:
    """Static description of one fleet member.

    ``storage`` is an optional per-worker storage override: when set,
    the front door rewrites each forwarded build's ``--storage`` to it
    — how an in-process fleet (loadgen, tests) models N machines that
    each have their own local disk. Real deployments with one worker
    per host leave it unset."""

    def __init__(self, worker_id: str, socket_path: str,
                 storage: str | None = None) -> None:
        self.id = worker_id
        self.socket_path = socket_path
        self.storage = storage

    @classmethod
    def parse(cls, flag: str, index: int) -> "WorkerSpec":
        """``SOCKET[=STORAGE]`` (the ``--worker`` CLI flag form)."""
        socket_path, _, storage = flag.partition("=")
        return cls(f"w{index}", socket_path, storage or None)


class WorkerState:
    """One worker's live view: poll results + local routing state.
    Mutated only under the scheduler lock."""

    def __init__(self, spec: WorkerSpec) -> None:
        self.spec = spec
        self.alive = False
        self.draining = False
        self.last_error = ""
        self.consecutive_failures = 0
        self.last_poll_mono = 0.0
        # From /healthz + /sessions:
        self.queue_depth = 0
        self.active_builds = 0
        self.max_concurrent = 0
        self.sessions: set[str] = set()
        self.session_hits = 0
        # Session-snapshot digest from /sessions (write/restore
        # tallies + last restore failure) — what `doctor --fleet`'s
        # snapshot_restore_failed finding reads from the fleet row.
        self.session_snapshot: dict = {}
        # Distribution-plane digest from /healthz: what the worker can
        # serve (recipes/packs its builds published) and how much it
        # has served — the peer plane's capacity signal per worker.
        self.serve: dict = {}
        # Storage-plane digest from /healthz: per-plane census totals,
        # LRU-seed state, and cached audit/scrub finding counts — the
        # front door's view of how full (and how consistent) each
        # worker's content planes are.
        self.storage: dict = {}
        self.builds_succeeded = 0
        self.builds_failed = 0
        # Canary-derived health score (EWMA in [0, 1], 1.0 = healthy).
        # Written by the CanaryDriver via set_health_score; a worker
        # that has never been canaried keeps the benefit of the doubt.
        self.health_score = 1.0
        # Active-alert digest from the worker's own /healthz
        # ({"active": n, "page": n, "warn": n}) — what `top`'s ALERTS
        # column and doctor's fleet view read without a /alerts fan-out.
        self.alerts: dict = {}
        # Continuous-profiling digest from /healthz ({"enabled", "hz",
        # "samples_total", "dropped", "overhead_fraction", ...}) — lets
        # doctor --fleet flag a sampler past its overhead budget or
        # dropping stacks without a per-worker /profile fan-out.
        self.profiler: dict = {}
        # Local estimate: builds this front door currently has open
        # against the worker (fresher than any poll).
        self.local_inflight = 0
        self.routed_total = 0

    @property
    def eligible(self) -> bool:
        return self.alive and not self.draining

    @property
    def storage_pressure(self) -> float:
        """Hot-tier occupancy over budget from the worker's /healthz
        storage digest (0.0 when unbudgeted/unknown). Routing demotes
        a worker whose disk is far past its budget — its next build
        pays eviction churn and refetch latency."""
        try:
            budget = self.storage.get("budget") or {}
            return float(budget.get("pressure", 0.0) or 0.0)
        except (TypeError, ValueError, AttributeError):
            return 0.0

    def load(self) -> int:
        """Routing load score: what's queued there plus what we have
        in flight ourselves."""
        return self.queue_depth + max(self.active_builds,
                                      self.local_inflight)

    def snapshot(self) -> dict:
        return {
            "id": self.spec.id,
            "socket": self.spec.socket_path,
            "state": ("draining" if self.draining and self.alive
                      else "alive" if self.alive else "dead"),
            "alive": self.alive,
            "draining": self.draining,
            "queue_depth": self.queue_depth,
            "active_builds": self.active_builds,
            "local_inflight": self.local_inflight,
            "max_concurrent_builds": self.max_concurrent,
            "sessions": sorted(self.sessions),
            "session_hits": self.session_hits,
            "session_snapshot": dict(self.session_snapshot),
            "serve": dict(self.serve),
            "storage": dict(self.storage),
            "builds_succeeded": self.builds_succeeded,
            "builds_failed": self.builds_failed,
            "health_score": round(self.health_score, 4),
            "storage_pressure": round(self.storage_pressure, 4),
            "alerts": dict(self.alerts),
            "profiler": dict(self.profiler),
            "routed_total": self.routed_total,
            "consecutive_failures": self.consecutive_failures,
            "last_error": self.last_error,
            "last_poll_age_seconds": (
                round(time.monotonic() - self.last_poll_mono, 3)
                if self.last_poll_mono else None),
        }


def build_identity(argv: list[str]) -> tuple[str, str]:
    """(context key, command) for one submission, resolved through the
    real CLI parser (hand-rolled argv scanning would miss equals forms
    and abbreviations — the same reason the worker's _effective_flags
    does this). The context key is the realpath of a build's context
    directory; non-build commands have no affinity identity and route
    by load alone."""
    import os

    from makisu_tpu_torch import cli
    try:
        args, _ = cli.make_parser().parse_known_args(argv)
    except SystemExit:
        return "", ""
    command = getattr(args, "command", "") or ""
    context = getattr(args, "context", "") if command == "build" else ""
    if context:
        context = os.path.realpath(os.path.abspath(context))
    return context, command


class FleetScheduler:
    """Worker registry + routing core. Thread-safe; the poll thread
    refreshes worker state, handler threads route against it."""

    def __init__(self, specs: list[WorkerSpec],
                 poll_interval: float = 1.0,
                 tenant_quota: int = 0,
                 max_inflight: int = 0,
                 spillover_queue_depth: int = 2,
                 health_page_threshold: float | None = None) -> None:
        if not specs:
            raise ValueError("a fleet needs at least one worker")
        if health_page_threshold is None:
            # Lazy: scheduler is imported by fleet/__init__ before
            # fleet.slo; resolving the default here keeps one source
            # of truth without an import-time cycle.
            from makisu_tpu_torch.fleet import slo as _slo
            health_page_threshold = _slo.HEALTH_PAGE_THRESHOLD
        # Workers whose canary health score sits at/below this are
        # demoted: spillover/failover prefer healthier peers, and
        # every skip lands in the decision ledger as health_demoted.
        # Affinity still wins — a resident session is worth more than
        # a flaky canary, and demotion must not shed the warm state
        # that makes the worker worth routing to once it recovers.
        self.health_page_threshold = float(health_page_threshold)
        # Disk-pressure demotion threshold: hot-tier bytes over budget
        # past which a worker is skipped by spillover/failover (its
        # next build pays eviction churn while a sibling has headroom).
        # 1.0 is "exactly at budget" — demote only meaningfully past
        # it; affinity still wins for the same reason as health.
        self.storage_pressure_threshold = STORAGE_PRESSURE_THRESHOLD
        self._mu = threading.Lock()
        self.workers: dict[str, WorkerState] = {
            spec.id: WorkerState(spec) for spec in specs}
        self.poll_interval = poll_interval
        self.tenant_quota = max(int(tenant_quota), 0)
        self.spillover_queue_depth = max(int(spillover_queue_depth), 1)
        # Sticky placement memo: context -> worker id the last build
        # was routed to. Seeds affinity before /sessions reflects a
        # freshly-minted session, and keeps convergence across the
        # session TTL.
        self._placements: dict[str, str] = {}
        self._decisions: collections.deque[dict] = collections.deque(
            maxlen=_DECISIONS_KEEP)
        self._ring = self._build_ring([s.id for s in specs])
        # Front-door admission: a global in-flight cap (0 = unlimited)
        # and per-tenant quotas, both strict-FIFO slot gates (arrival
        # order — see _SlotGate).
        self._inflight_budget = (_SlotGate(max_inflight)
                                 if max_inflight > 0 else None)
        self._tenant_budgets: dict[str, _SlotGate] = {}
        self._tenant_labels: set[str] = set()
        self._frontdoor_waiting = 0
        self._peer_version = 0
        self._peer_posted: dict[str, int] = {}
        self._poll_halt = threading.Event()
        self._poll_thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetScheduler":
        """Poll every worker once synchronously (so routing has a
        live view immediately), then keep polling in the background."""
        self.poll_once()
        self._poll_thread = threading.Thread(
            target=self._poll_loop, daemon=True, name="fleet-poll")
        self._poll_thread.start()
        return self

    def stop(self) -> None:
        self._poll_halt.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5)
            self._poll_thread = None

    def _poll_loop(self) -> None:
        while not self._poll_halt.wait(self.poll_interval):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 - the poll must survive
                log.error("fleet poll failed: %s", e)

    # -- polling -----------------------------------------------------------

    def poll_once(self) -> None:
        """Refresh every worker's health + session set, then publish
        the peer map to any worker that hasn't seen the current
        version."""
        from makisu_tpu_torch.worker.client import WorkerClient
        for state in list(self.workers.values()):
            client = WorkerClient(state.spec.socket_path,
                                  connect_timeout=2.0,
                                  control_timeout=5.0, retries=0)
            try:
                health = client.healthz()
                sessions = client.sessions()
            except (OSError, RuntimeError, ValueError) as e:
                self._note_poll_failure(state, str(e))
                continue
            with self._mu:
                was_alive = state.alive
                state.alive = True
                state.consecutive_failures = 0
                state.last_error = ""
                state.last_poll_mono = time.monotonic()
                state.queue_depth = health.queue_depth
                state.active_builds = health.active_builds
                state.max_concurrent = health.max_concurrent_builds
                state.builds_succeeded = health.builds_succeeded
                state.builds_failed = health.builds_failed
                state.sessions = {
                    row.get("context", "")
                    for row in sessions.get("sessions", [])}
                state.session_hits = int(sessions.get("hits", 0))
                state.session_snapshot = dict(
                    sessions.get("snapshot") or {})
                state.serve = dict(health.get("serve") or {})
                state.storage = dict(health.get("storage") or {})
                state.alerts = dict(health.get("alerts") or {})
                state.profiler = dict(health.get("profiler") or {})
                if not was_alive:
                    self._peer_version += 1  # membership changed
                else:
                    # A worker that restarted BETWEEN polls (never
                    # observed dead) comes back holding no peer map —
                    # its /healthz reports a version behind what we
                    # believe it acked. Forget the ack so the normal
                    # publish path re-sends.
                    held = health.get("peer_map_version")
                    posted = self._peer_posted.get(state.spec.id)
                    if held is not None and posted is not None \
                            and int(held) < posted:
                        del self._peer_posted[state.spec.id]
        self._publish_worker_gauges()
        self._publish_peer_map()

    def _note_poll_failure(self, state: WorkerState, error: str) -> None:
        with self._mu:
            state.consecutive_failures += 1
            state.last_error = error
            state.last_poll_mono = time.monotonic()
            if state.alive:
                state.alive = False
                state.sessions = set()
                self._peer_version += 1
                log.warning("fleet: worker %s unreachable: %s",
                            state.spec.id, error)

    def _publish_worker_gauges(self) -> None:
        with self._mu:
            counts = {"alive": 0, "dead": 0, "draining": 0}
            for state in self.workers.values():
                if state.draining and state.alive:
                    counts["draining"] += 1
                elif state.alive:
                    counts["alive"] += 1
                else:
                    counts["dead"] += 1
        g = metrics.global_registry()
        for key, n in counts.items():
            g.gauge_set(FLEET_WORKERS, n, state=key)

    def _publish_peer_map(self) -> None:
        """POST the current peer map to every live worker that hasn't
        acknowledged this version. Draining workers stay in the map —
        they are alive and their chunks are exactly what a drained
        context's next host wants to fetch."""
        with self._mu:
            version = self._peer_version
            sockets = [s.spec.socket_path
                       for s in self.workers.values() if s.alive]
            targets = [s for s in self.workers.values()
                       if s.alive
                       and self._peer_posted.get(s.spec.id) != version]
        if not targets:
            return
        from makisu_tpu_torch.worker.client import _UnixHTTPConnection
        body = json.dumps({"version": version,
                           "peers": sockets}).encode()
        for state in targets:
            conn = _UnixHTTPConnection(state.spec.socket_path, 5.0,
                                       connect_timeout=2.0)
            try:
                conn.request("POST", "/peers", body=body, headers={
                    "Content-Type": "application/json"})
                resp = conn.getresponse()
                payload = json.loads(resp.read() or b"{}")
                if resp.status != 200:
                    continue
                if payload.get("applied"):
                    with self._mu:
                        self._peer_posted[state.spec.id] = version
                else:
                    # The worker holds a HIGHER version (a previous
                    # front door published it before we restarted and
                    # our counter started over). Adopt it: jump past
                    # the worker's version so the next publish wins
                    # everywhere — otherwise this worker would keep a
                    # stale peer map forever while we believed it
                    # up to date.
                    worker_version = int(payload.get("version", 0))
                    with self._mu:
                        self._peer_version = max(self._peer_version,
                                                 worker_version + 1)
                    log.info("fleet: worker %s holds peer map v%d > "
                             "our v%d; republishing as v%d",
                             state.spec.id, worker_version, version,
                             self._peer_version)
            except (OSError, ValueError) as e:
                log.debug("peer map post to %s failed: %s",
                          state.spec.id, e)
            finally:
                conn.close()

    # -- routing -----------------------------------------------------------

    @staticmethod
    def _build_ring(worker_ids: list[str]) -> list[tuple[int, str]]:
        ring = []
        for wid in worker_ids:
            for v in range(_VIRTUAL_NODES):
                h = hashlib.sha256(f"{wid}#{v}".encode()).digest()
                ring.append((int.from_bytes(h[:8], "big"), wid))
        ring.sort()
        return ring

    def _ring_owner(self, key: str,
                    eligible: set[str]) -> str | None:
        """First eligible worker clockwise of the key's ring point —
        stable under membership churn (only keys owned by a
        dead/drained worker move)."""
        if not self._ring or not eligible:
            return None
        point = int.from_bytes(
            hashlib.sha256(key.encode()).digest()[:8], "big")
        import bisect
        start = bisect.bisect_left(self._ring, (point, ""))
        for i in range(len(self._ring)):
            _, wid = self._ring[(start + i) % len(self._ring)]
            if wid in eligible:
                return wid
        return None

    def route(self, context_key: str, tenant: str = "",
              exclude: frozenset[str] | set[str] = frozenset(),
              attempt: int = 0) -> tuple[WorkerState, str, str]:
        """Pick the worker for one build. Returns ``(worker, verdict,
        reason)`` with verdict ``affinity`` | ``spillover`` |
        ``failover`` and the decision recorded. Raises
        :class:`NoWorkersError` when nothing is eligible."""
        with self._mu:
            candidates = {wid: w for wid, w in self.workers.items()
                          if w.eligible and wid not in exclude}
            if not candidates:
                raise NoWorkersError(
                    "no eligible fleet worker (all dead, draining, "
                    "or excluded after failover)")
            chosen = None
            verdict = "spillover"
            reason = ""
            if context_key:
                # 1. Session affinity: a worker that reports a
                # resident session for this context, else the sticky
                # placement memo (a session just minted there hasn't
                # hit a poll yet).
                holders = [w for w in candidates.values()
                           if context_key in w.sessions]
                if holders:
                    chosen = min(holders, key=lambda w: w.load())
                    verdict, reason = "affinity", "session"
                else:
                    memo = self._placements.get(context_key)
                    if memo in candidates:
                        chosen = candidates[memo]
                        verdict, reason = "affinity", "sticky"
            demoted: list[tuple[str, float]] = []
            pressure_demoted: list[tuple[str, float]] = []
            pool = candidates
            if chosen is None:
                # Health demotion (spillover/failover only — a worker
                # holding this context's session was already chosen
                # above regardless of score): drop workers whose
                # canary health score is at/below the page threshold,
                # unless that would empty the pool — a degraded worker
                # beats NoWorkersError.
                healthy = {
                    wid: w for wid, w in candidates.items()
                    if w.health_score > self.health_page_threshold}
                if healthy and len(healthy) < len(candidates):
                    demoted = sorted(
                        (wid, w.health_score)
                        for wid, w in candidates.items()
                        if wid not in healthy)
                    pool = healthy
                # Disk-pressure demotion, same never-strand shape:
                # skip workers far over their storage budget while
                # any peer with headroom remains.
                unpressured = {
                    wid: w for wid, w in pool.items()
                    if w.storage_pressure
                    < self.storage_pressure_threshold}
                if unpressured and len(unpressured) < len(pool):
                    pressure_demoted = sorted(
                        (wid, w.storage_pressure)
                        for wid, w in pool.items()
                        if wid not in unpressured)
                    pool = unpressured
            if chosen is None and context_key:
                # 2. Consistent-hash placement for new contexts.
                owner_id = self._ring_owner(context_key,
                                            set(pool))
                owner = pool.get(owner_id)
                if owner is not None and owner.load() \
                        < self.spillover_queue_depth:
                    chosen, reason = owner, "placed"
                else:
                    reason = "overloaded"
            if chosen is None:
                # 3. Least-loaded (no context identity, or the hash
                # owner is saturated).
                chosen = min(pool.values(),
                             key=lambda w: (w.load(), w.spec.id))
                reason = reason or "no_context"
            if attempt > 0:
                verdict = "failover"
            chosen.local_inflight += 1
            chosen.routed_total += 1
            if context_key:
                self._placements[context_key] = chosen.spec.id
        # Every worker skipped for health gets its own ledgered
        # decision — the routing shift away from a degraded worker is
        # auditable from the same surface as every other verdict.
        for wid, score in demoted:
            self._record_decision(
                context_key or "<no-context>", "health_demoted",
                reason="canary_health", tenant=tenant, worker=wid,
                score=round(score, 4),
                threshold=self.health_page_threshold)
        for wid, pressure in pressure_demoted:
            self._record_decision(
                context_key or "<no-context>", "pressure_demoted",
                reason="storage_pressure", tenant=tenant, worker=wid,
                pressure=round(pressure, 4),
                threshold=self.storage_pressure_threshold)
        self._record_decision(context_key or "<no-context>", verdict,
                              reason=reason, tenant=tenant,
                              worker=chosen.spec.id, attempt=attempt)
        return chosen, verdict, reason

    def eligible_count(self,
                       exclude: frozenset[str] | set[str] = frozenset(),
                       ) -> int:
        """How many workers could take a build right now (alive, not
        draining, not excluded) — what the front door's no-wait
        decision must count: dead or drained workers are not
        'somewhere else to go'."""
        with self._mu:
            return sum(1 for wid, w in self.workers.items()
                       if w.eligible and wid not in exclude)

    def set_health_score(self, worker_id: str, score: float) -> None:
        """Record a worker's canary-derived health score (the canary
        sweep calls this after it ends). Clamped to [0, 1]."""
        with self._mu:
            state = self.workers.get(worker_id)
            if state is not None:
                state.health_score = min(max(float(score), 0.0), 1.0)
        metrics.global_registry().gauge_set(
            metrics.WORKER_HEALTH_SCORE, score, worker=worker_id)

    def canary_targets(self) -> list[tuple[str, str, str]]:
        """``(worker_id, socket_path, storage)`` for every worker a
        canary sweep should probe. Dead workers are skipped (the poll
        already tells the story); DRAINING workers are probed — they
        still serve peer fetches and their health matters for when
        they come back."""
        with self._mu:
            return [(w.spec.id, w.spec.socket_path,
                     w.spec.storage or "")
                    for w in sorted(self.workers.values(),
                                    key=lambda w: w.spec.id)
                    if w.alive]

    def health_scores(self) -> dict[str, float]:
        """Current health score per worker — the fleet SLO probe's
        ``canary_health_score`` level signal."""
        with self._mu:
            return {wid: w.health_score
                    for wid, w in self.workers.items()}

    def snapshot_sources(self, context_key: str,
                         exclude: frozenset[str] | set[str] =
                         frozenset()) -> list[tuple[str, str]]:
        """``(worker_id, socket)`` candidates that may hold a session
        snapshot for ``context_key``, best-first: workers reporting a
        resident session, then the sticky placement memo's worker,
        then every other ALIVE worker (draining included — a draining
        worker's snapshot is exactly what its contexts' next host
        wants to pull). The prewarm path walks this list."""
        with self._mu:
            rows = [(w, context_key in w.sessions,
                     self._placements.get(context_key) == wid)
                    for wid, w in self.workers.items()
                    if w.alive and wid not in exclude]
        rows.sort(key=lambda r: (not r[1], not r[2], r[0].spec.id))
        return [(w.spec.id, w.spec.socket_path) for w, _, _ in rows]

    def note_prewarm(self, context_key: str, worker_id: str,
                     ok: bool, reason: str, source: str = "") -> None:
        """Ledger one prewarm attempt (verdict ``prewarm`` /
        ``prewarm_failed``) so routing-shift warmth is auditable from
        the same decision surface as every route verdict."""
        # Field name is from_worker, not source: the decision row is
        # re-recorded on the cache ledger whose own first argument is
        # the ledger source ("fleet").
        self._record_decision(
            context_key or "<no-context>",
            "prewarm" if ok else "prewarm_failed",
            reason=reason, tenant="", worker=worker_id,
            from_worker=source)

    def note_build_done(self, worker_id: str) -> None:
        """A forwarded build finished (success or failure — outcome
        counts come from the worker's own /healthz poll); drop it from
        the local in-flight estimate."""
        with self._mu:
            state = self.workers.get(worker_id)
            if state is not None:
                state.local_inflight = max(state.local_inflight - 1, 0)

    def note_worker_failure(self, worker_id: str, reason: str) -> None:
        """A forward attempt failed (unreachable / mid-stream death):
        mark the worker dead immediately — the next poll revives it if
        it was a blip — and count the retry."""
        metrics.global_registry().counter_add(FLEET_RETRIES,
                                              reason=reason)
        with self._mu:
            state = self.workers.get(worker_id)
            if state is None:
                return
            state.local_inflight = max(state.local_inflight - 1, 0)
            if reason == "refused":
                # Admission refusal is load, not death.
                return
            if state.alive:
                state.alive = False
                state.sessions = set()
                state.last_error = reason
                self._peer_version += 1
                log.warning("fleet: worker %s failed mid-build (%s); "
                            "marked dead pending next poll",
                            worker_id, reason)

    # -- tenant quotas / front-door admission ------------------------------

    def tenant_label(self, tenant: str) -> str:
        """Bounded metric label for a CLIENT-supplied tenant string:
        past the cap, new tenants aggregate under "other" in every
        fleet series (the same cardinality discipline the worker's
        latency rings apply) — quota budgets use the same key, so the
        label always names the budget that actually gated the build."""
        key = tenant or "default"
        with self._mu:
            if key in self._tenant_labels \
                    or len(self._tenant_labels) < _TENANT_BUDGETS_KEEP:
                self._tenant_labels.add(key)
                return key
        return _TENANT_OVERFLOW

    def _tenant_budget(self, tenant: str) -> "_SlotGate | None":
        if self.tenant_quota <= 0:
            return None
        key = self.tenant_label(tenant)
        with self._mu:
            budget = self._tenant_budgets.get(key)
            if budget is None:
                budget = _SlotGate(self.tenant_quota)
                self._tenant_budgets[key] = budget
            return budget

    def admit(self, tenant: str, context_key: str = "") -> float:
        """Front-door admission: block until the tenant is under its
        in-flight quota (and the global cap, when set) — strict FIFO
        per gate. Returns the seconds waited; a nonzero wait is
        recorded as a ``quota_denied`` decision."""
        t0 = time.monotonic()
        for gate, kind in ((self._tenant_budget(tenant),
                            "tenant_quota"),
                           (self._inflight_budget, "fleet_inflight")):
            if gate is None:
                continue
            if not gate.try_acquire():
                self._note_waiting(+1)
                self._record_decision(
                    context_key or "<no-context>", "quota_denied",
                    reason=kind, tenant=tenant, worker="")
                try:
                    gate.acquire()
                finally:
                    self._note_waiting(-1)
        waited = time.monotonic() - t0
        if waited > 0.000_5:
            metrics.global_registry().observe(
                FLEET_QUOTA_WAIT, waited,
                tenant=self.tenant_label(tenant))
        self._publish_admission_gauges(tenant)
        return waited

    def release(self, tenant: str) -> None:
        budget = self._tenant_budget(tenant)
        if budget is not None:
            budget.release()
        if self._inflight_budget is not None:
            self._inflight_budget.release()
        self._publish_admission_gauges(tenant)

    def _publish_admission_gauges(self, tenant: str) -> None:
        budget = self._tenant_budget(tenant)
        g = metrics.global_registry()
        if budget is not None:
            g.gauge_set(FLEET_TENANT_INFLIGHT, budget.inflight,
                        tenant=self.tenant_label(tenant))
        if self._inflight_budget is not None:
            g.gauge_set(metrics.FLEET_INFLIGHT_BUILDS,
                        self._inflight_budget.inflight)

    def _note_waiting(self, delta: int) -> None:
        with self._mu:
            self._frontdoor_waiting = max(
                self._frontdoor_waiting + delta, 0)
            depth = self._frontdoor_waiting
        metrics.global_registry().gauge_set(FLEET_FRONTDOOR_QUEUE,
                                            depth)

    def frontdoor_waiting(self) -> int:
        with self._mu:
            return self._frontdoor_waiting

    # -- drain -------------------------------------------------------------

    def drain(self, worker_id: str, draining: bool = True) -> bool:
        """Graceful drain: new builds stop routing to the worker, but
        it stays alive — serving peer chunk fetches, finishing its
        in-flight builds — until the operator stops it."""
        with self._mu:
            state = self.workers.get(worker_id)
            if state is None:
                return False
            state.draining = draining
            # Sticky placements toward a draining worker must not pin
            # affinity there (route() re-places on next build).
            if draining:
                self._placements = {
                    ctx: wid for ctx, wid in self._placements.items()
                    if wid != worker_id}
        self._publish_worker_gauges()
        log.info("fleet: worker %s %s", worker_id,
                 "draining" if draining else "undrained")
        return True

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        g = metrics.global_registry()
        with self._mu:
            workers = [w.snapshot()
                       for w in sorted(self.workers.values(),
                                       key=lambda w: w.spec.id)]
            decisions = list(self._decisions)
            tenants = {
                tenant: {"inflight": budget.inflight,
                         "quota": self.tenant_quota}
                for tenant, budget in sorted(
                    self._tenant_budgets.items())}
            placements = dict(self._placements)
            waiting = self._frontdoor_waiting
            peer_version = self._peer_version
            peer_acked = dict(self._peer_posted)
        return {
            "workers": workers,
            "tenant_quota": self.tenant_quota,
            "tenants": tenants,
            "placements": placements,
            "frontdoor_waiting": waiting,
            "peer_map_version": peer_version,
            # Which peer-map version each worker last acknowledged —
            # the fan-out the /healthz self section and `doctor
            # --fleet` read to spot a worker stuck on a stale map.
            "peer_acked": peer_acked,
            "route_totals": {
                verdict: int(n) for verdict, n in sorted(
                    g.counter_by_label(FLEET_ROUTE_TOTAL,
                                       "verdict").items())},
            "recent_decisions": decisions,
        }

    # -- decision recording ------------------------------------------------

    def _record_decision(self, key: str, verdict: str, reason: str,
                         tenant: str, worker: str,
                         **fields) -> None:
        metrics.global_registry().counter_add(FLEET_ROUTE_TOTAL,
                                              verdict=verdict)
        row = {"ts": round(time.time(), 3), "key": key,
               "verdict": verdict, "reason": reason,
               "tenant": tenant, "worker": worker}
        row.update(fields)
        with self._mu:
            self._decisions.append(row)
        record = dict(fields)
        if worker:
            record["worker"] = worker
        if tenant:
            record["tenant"] = tenant
        # Handler/poll threads carry no bound context; the decision
        # reaches --events-out/--explain-out because `makisu-tpu
        # fleet` promotes the invocation's sinks process-wide
        # (events.promote_context_sinks in cmd_fleet).
        ledger.record("fleet", key, verdict, reason, **record)
