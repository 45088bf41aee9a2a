"""Worker client: submit builds to a long-lived worker.

Reference: lib/client/client.go (MakisuClient{Ready,Build,Exit}:36-61,
context copy into the shared mount prepareContext:141, log streaming +
build_code extraction readLines:160-191).

Copy of ``makisu_tpu/worker/client.py``: the wire format is the
reference's, so this client drives either package's worker. It never
imports torch. ``storage()`` reads either worker's ``GET /storage``.
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import time

from makisu_tpu_torch.utils import fileio
from makisu_tpu_torch.utils import logging as log

# Transient transport failures a control-plane GET may retry: the
# socket vanished/refused (worker restarting), the connection died
# mid-exchange, or the worker sat past the timeout. Deliberately NOT
# retried: HTTP-level errors (the worker answered; retrying won't
# change its mind) and anything on POST /build (failover across
# workers is the scheduler's job, not the client's).
_TRANSIENT_ERRORS = (ConnectionError, FileNotFoundError, socket.timeout,
                     http.client.RemoteDisconnected,
                     http.client.NotConnected)


class _UnixHTTPConnection(http.client.HTTPConnection):
    """HTTP over a unix socket with a SEPARATE connect timeout: an
    unreachable worker (dead socket, full backlog) must fail the
    caller in ``connect_timeout`` seconds, while reads keep the long
    ``timeout`` a multi-minute build stream legitimately needs. The
    fleet scheduler's failover path depends on the former being
    prompt."""

    def __init__(self, path: str, timeout: float,
                 connect_timeout: float | None = None) -> None:
        super().__init__("localhost", timeout=timeout)
        self._path = path
        self._connect_timeout = (connect_timeout
                                 if connect_timeout is not None
                                 else timeout)

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self._connect_timeout)
        sock.connect(self._path)
        sock.settimeout(self.timeout)
        self.sock = sock


def iter_stream_lines(resp, chunk_size: int = 4096):
    """Complete NDJSON lines (bytes, blank lines skipped) from a
    streamed HTTP response — the ONE framing loop shared by
    ``WorkerClient.build`` and the fleet forwarder, so the /build wire
    format has a single parser. Stops at EOF; a truncated trailing
    fragment (no newline) is dropped — exactly the mid-stream-death
    signal both consumers read as "no terminal frame arrived"."""
    buf = b""
    while True:
        chunk = resp.read(chunk_size)
        if not chunk:
            return
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            if line.strip():
                yield line


def terminal_exit_code(payload: dict) -> int:
    """Exit code from a /build terminal frame: ``exit_code`` (data)
    first, the stringly legacy ``build_code`` second."""
    code = payload.get("exit_code")
    try:
        return int(payload["build_code"]) if code is None \
            else int(code)
    except (KeyError, TypeError, ValueError):
        return 1


class PercentileStats(dict):
    """A ``metrics.percentile_stats`` digest with typed accessors.
    Still a dict (wire-format compatible); missing fields read as 0."""

    @property
    def count(self) -> int:
        return int(self.get("count", 0))

    @property
    def p50(self) -> float:
        return float(self.get("p50", 0.0))

    @property
    def p90(self) -> float:
        return float(self.get("p90", 0.0))

    @property
    def p99(self) -> float:
        return float(self.get("p99", 0.0))


class WorkerHealth(dict):
    """``GET /healthz`` payload with typed queue/latency fields —
    callers stop re-parsing raw dicts for the fields every dashboard
    needs. Still a plain dict underneath, so existing subscript
    consumers keep working unchanged."""

    @property
    def active_builds(self) -> int:
        return int(self.get("active_builds", 0))

    @property
    def builds_started(self) -> int:
        return int(self.get("builds_started", 0))

    @property
    def builds_succeeded(self) -> int:
        return int(self.get("builds_succeeded", 0))

    @property
    def builds_failed(self) -> int:
        return int(self.get("builds_failed", 0))

    @property
    def uptime_seconds(self) -> float:
        return float(self.get("uptime_seconds", 0.0))

    @property
    def queue_depth(self) -> int:
        return int(self.get("queue", {}).get("depth", 0))

    @property
    def max_concurrent_builds(self) -> int:
        return int(self.get("queue", {}).get(
            "max_concurrent_builds", 0))

    @property
    def queue_wait(self) -> PercentileStats:
        return PercentileStats(
            self.get("queue", {}).get("wait_seconds", {}))

    @property
    def build_latency(self) -> PercentileStats:
        return PercentileStats(
            self.get("queue", {}).get("latency_seconds", {}))

    @property
    def tenant_latency(self) -> dict[str, PercentileStats]:
        return {tenant: PercentileStats(stats)
                for tenant, stats in self.get("queue", {}).get(
                    "tenant_latency_seconds", {}).items()}

    @property
    def last_progress_seconds(self) -> float:
        return float(self.get("last_progress_seconds", 0.0))

    @property
    def transfer_inflight_bytes(self) -> int:
        return int(self.get("transfer_inflight_bytes", 0))

    @property
    def device(self) -> dict:
        """The ``device`` section: probe state + dispatch digests."""
        return dict(self.get("device", {}))

    @property
    def sessions(self) -> dict:
        """The ``sessions`` section: resident build-session digest
        (count, resident bytes vs budget, hits, invalidations)."""
        return dict(self.get("sessions", {}))

    @property
    def session_resident_bytes(self) -> int:
        return int(self.get("sessions", {}).get("resident_bytes", 0))

    @property
    def storage(self) -> dict:
        """The ``storage`` section: per-plane census digest, total
        bytes, the chunk CAS LRU seed state, and finding counts."""
        return dict(self.get("storage", {}))

    @property
    def storage_total_bytes(self) -> int:
        return int(self.get("storage", {}).get("total_bytes", 0))

    @property
    def device_probe_state(self) -> str:
        """Probe verdict: ok|pending|wedged|failed|absent|disabled."""
        return str(self.get("device", {}).get("probe", {})
                   .get("state", ""))


class BuildInfo(dict):
    """One row of ``GET /builds`` with typed accessors."""

    @property
    def id(self) -> int:
        return int(self.get("id", 0))

    @property
    def tenant(self) -> str:
        return str(self.get("tenant", ""))

    @property
    def state(self) -> str:
        return str(self.get("state", ""))

    @property
    def phase(self) -> str:
        return str(self.get("phase", ""))

    @property
    def trace_id(self) -> str:
        return str(self.get("trace_id", ""))

    @property
    def queue_wait_seconds(self) -> float:
        return float(self.get("queue_wait_seconds", 0.0))

    @property
    def age_seconds(self) -> float:
        return float(self.get("age_seconds", 0.0))

    @property
    def progress_age_seconds(self) -> float:
        return float(self.get("progress_age_seconds", 0.0))

    @property
    def exit_code(self) -> int | None:
        code = self.get("exit_code")
        return None if code is None else int(code)

    @property
    def cache_hit_ratio(self) -> float:
        return float(self.get("cache", {}).get("kv_hit_ratio", 0.0))


class WorkerBuilds(dict):
    """``GET /builds`` payload: queue state + typed build rows."""

    @property
    def queue_depth(self) -> int:
        return int(self.get("queue_depth", 0))

    @property
    def max_concurrent_builds(self) -> int:
        return int(self.get("max_concurrent_builds", 0))

    @property
    def inflight(self) -> list[BuildInfo]:
        return [BuildInfo(b) for b in self.get("inflight", [])]

    @property
    def recent(self) -> list[BuildInfo]:
        return [BuildInfo(b) for b in self.get("recent", [])]


class WorkerClient:
    def __init__(self, socket_path: str,
                 local_shared_path: str = "",
                 worker_shared_path: str = "",
                 timeout: float = 3600.0,
                 connect_timeout: float = 5.0,
                 control_timeout: float = 15.0,
                 retries: int = 2) -> None:
        self.socket_path = socket_path
        self.local_shared_path = local_shared_path
        self.worker_shared_path = worker_shared_path
        # `timeout` is the read timeout for the /build stream (a slow
        # build's frames may be minutes apart); control-plane GETs
        # (/healthz, /builds, /metrics, ...) use the much shorter
        # `control_timeout` — a dashboard poll or a scheduler health
        # probe hanging for an hour against a wedged worker is exactly
        # the failure mode the fleet needs surfaced promptly.
        self.timeout = timeout
        self.connect_timeout = connect_timeout
        self.control_timeout = control_timeout
        # Bounded retry budget for transient socket errors on
        # idempotent control-plane requests (0 disables).
        self.retries = max(int(retries), 0)
        # Terminal payload of the last build() call: exit_code and
        # elapsed_seconds as data, no log-text parsing needed.
        self.last_build: dict = {}
        # Build events (span open/close, steps, cache outcomes) streamed
        # by the last build() call, in arrival order.
        self.last_events: list[dict] = []

    def _request(self, method: str, path: str, body: bytes | None = None,
                 tenant: str = "", headers: dict | None = None,
                 timeout: float | None = None, retry: bool = False):
        hdrs = dict(headers or {})
        if body:
            hdrs.setdefault("Content-Type", "application/json")
        if tenant:
            hdrs["X-Makisu-Tenant"] = tenant
        attempts = 1 + (self.retries if retry else 0)
        for attempt in range(attempts):
            conn = _UnixHTTPConnection(
                self.socket_path,
                self.timeout if timeout is None else timeout,
                connect_timeout=self.connect_timeout)
            try:
                conn.request(method, path, body=body, headers=hdrs)
                return conn, conn.getresponse()
            except _TRANSIENT_ERRORS:
                conn.close()
                if attempt + 1 >= attempts:
                    raise
                time.sleep(0.05 * (attempt + 1))

    def _control(self, path: str):
        """Idempotent control-plane GET: short timeout, bounded
        retry on transient socket errors."""
        return self._request("GET", path,
                             timeout=self.control_timeout, retry=True)

    def ready(self) -> bool:
        try:
            # No retry: ready() is the poll primitive — each call must
            # answer promptly so spin-wait loops keep their cadence.
            conn, resp = self._request("GET", "/ready",
                                       timeout=self.control_timeout)
            try:
                resp.read()
                return resp.status == 200
            finally:
                conn.close()
        except (OSError, http.client.HTTPException):
            return False

    def metrics(self) -> str:
        """The worker's Prometheus text exposition (``GET /metrics``)."""
        conn, resp = self._control("/metrics")
        try:
            if resp.status != 200:
                raise RuntimeError(
                    f"worker /metrics returned {resp.status}")
            return resp.read().decode()
        finally:
            conn.close()

    def exit(self) -> None:
        try:
            conn, resp = self._request("GET", "/exit")
            try:
                resp.read()
            finally:
                conn.close()
        except (OSError, http.client.HTTPException):
            pass  # the worker may shut down before the response lands

    def prepare_context(self, context_dir: str) -> str:
        """Copy the build context into the shared mount and return the
        path the worker sees (reference: prepareContext:141)."""
        if not self.local_shared_path:
            return context_dir
        name = os.path.basename(os.path.normpath(context_dir)) or "context"
        local_dst = os.path.join(self.local_shared_path, name)
        fileio.Copier([]).copy_dir(context_dir, local_dst)
        return os.path.join(self.worker_shared_path or
                            self.local_shared_path, name)

    def healthz(self) -> WorkerHealth:
        """The worker's ``GET /healthz`` payload: uptime, build
        outcome counts, and the admission queue's depth/latency
        digests — typed via :class:`WorkerHealth` (still a dict)."""
        conn, resp = self._control("/healthz")
        try:
            if resp.status != 200:
                raise RuntimeError(
                    f"worker /healthz returned {resp.status}")
            return WorkerHealth(json.loads(resp.read()))
        finally:
            conn.close()

    def sessions(self) -> dict:
        """The worker's ``GET /sessions`` payload: per-context
        resident build sessions (builds served, hits, resident bytes,
        dirty-tracker mode) plus invalidation tallies."""
        conn, resp = self._control("/sessions")
        try:
            if resp.status != 200:
                raise RuntimeError(
                    f"worker /sessions returned {resp.status}")
            return json.loads(resp.read())
        finally:
            conn.close()

    def storage(self, eviction_budget: int | None = None) -> dict:
        """The worker's ``GET /storage`` payload: per-storage-dir
        census + reference audit (+ eviction dry-run when a budget is
        given) and the latest scrub cycle — the full document behind
        /healthz's cached ``storage`` digest."""
        path = "/storage"
        if eviction_budget is not None:
            path += f"?eviction_budget={int(eviction_budget)}"
        conn, resp = self._control(path)
        try:
            if resp.status != 200:
                raise RuntimeError(
                    f"worker /storage returned {resp.status}")
            return json.loads(resp.read())
        finally:
            conn.close()

    def invalidate_sessions(self, context: str = "") -> int:
        """Drop the named context's resident session (or every idle
        session when ``context`` is empty); returns the dropped
        count (``POST /sessions/invalidate``)."""
        body = json.dumps({"context": context}).encode()
        conn, resp = self._request("POST", "/sessions/invalidate",
                                   body)
        try:
            if resp.status != 200:
                raise RuntimeError(
                    f"worker /sessions/invalidate returned "
                    f"{resp.status}")
            return int(json.loads(resp.read()).get("invalidated", 0))
        finally:
            conn.close()

    def session_snapshot(self, context: str) -> dict:
        """Fetch the named context's session-snapshot recipe
        (``GET /sessions/snapshot?context=``) — the chunk-plan
        document the fleet prewarm path pushes at a target worker.
        404 (no snapshot on disk) raises like every other non-200."""
        from urllib.parse import quote
        conn, resp = self._control(
            f"/sessions/snapshot?context={quote(context, safe='')}")
        try:
            if resp.status != 200:
                raise RuntimeError(
                    f"worker /sessions/snapshot returned {resp.status}")
            return json.loads(resp.read())
        finally:
            conn.close()

    def snapshot_sessions(self, context: str = "") -> dict:
        """Checkpoint resident session state into the chunk-addressed
        snapshot plane (``POST /sessions/snapshot``): the named
        context's session, or every idle session when ``context`` is
        empty. Returns ``{"snapshotted": N}``."""
        body = json.dumps({"context": context}).encode()
        conn, resp = self._request("POST", "/sessions/snapshot", body,
                                   timeout=self.control_timeout)
        try:
            if resp.status != 200:
                raise RuntimeError(
                    f"worker /sessions/snapshot returned {resp.status}")
            return json.loads(resp.read())
        finally:
            conn.close()

    def restore_session(self, payload: dict) -> dict:
        """Stage a session snapshot onto this worker
        (``POST /sessions/restore``) so the NEXT build on the context
        restores warm. ``payload`` is ``{"recipe": {...}}`` (prewarm
        push: chunks are fetched over the peer wire before the recipe
        lands) or ``{"context": dir}`` (re-validate a recipe already
        on this worker's storage). Returns ``{"ok": bool, "reason"}``;
        refusals are data, not HTTP errors."""
        body = json.dumps(payload).encode()
        conn, resp = self._request("POST", "/sessions/restore", body,
                                   timeout=self.control_timeout)
        try:
            if resp.status != 200:
                raise RuntimeError(
                    f"worker /sessions/restore returned {resp.status}")
            return json.loads(resp.read())
        finally:
            conn.close()

    def builds(self) -> WorkerBuilds:
        """The worker's ``GET /builds`` payload: in-flight + recently
        finished builds (tenant, phase, queue wait, progress age,
        cache economics) plus queue depth/cap."""
        conn, resp = self._control("/builds")
        try:
            if resp.status != 200:
                raise RuntimeError(
                    f"worker /builds returned {resp.status}")
            return WorkerBuilds(json.loads(resp.read()))
        finally:
            conn.close()

    def profile(self, seconds: float = 5.0) -> dict:
        """An on-demand profile capture (``GET /profile?seconds=N``):
        the worker — or, through the front door, every alive worker
        merged — samples for ``seconds`` and answers with a
        ``makisu-tpu.profile.v1`` window. No retry (a timed-out
        capture must not silently run twice), and the socket timeout
        stretches past the window the server is deliberately
        holding the request for."""
        conn, resp = self._request(
            "GET", f"/profile?seconds={float(seconds):g}",
            timeout=self.control_timeout + float(seconds))
        try:
            if resp.status != 200:
                raise RuntimeError(
                    f"worker /profile returned {resp.status}")
            return json.loads(resp.read())
        finally:
            conn.close()

    def alerts(self) -> dict:
        """The ``GET /alerts`` payload: active + recently-resolved
        SLO alerts (worker or fleet server — both speak the same
        ``makisu-tpu.alert.v1`` shape)."""
        conn, resp = self._control("/alerts")
        try:
            if resp.status != 200:
                raise RuntimeError(
                    f"worker /alerts returned {resp.status}")
            return json.loads(resp.read())
        finally:
            conn.close()

    def build(self, argv: list[str],
              context_dir: str | None = None,
              on_line=None, on_event=None,
              tenant: str = "", no_wait: bool = False) -> int:
        """Submit a build; stream log lines to the local logger (and
        ``on_line(payload)`` when given); return the worker's build exit
        code.

        The response stream carries three frame types, all NDJSON:
        log lines, build events (``{"event": {...}}`` — collected into
        ``last_events`` and forwarded to ``on_event`` when given), and
        the terminal outcome (``{"build_code": ...}`` — also carrying
        ``queue_wait_seconds`` + ``tenant``, see ``last_build``).

        ``tenant`` labels this build in the worker's queue/latency
        telemetry (sent as the ``X-Makisu-Tenant`` header).
        ``no_wait`` asks for cooperative admission refusal (the fleet
        forwarder's ``X-Makisu-No-Wait``): a saturated worker answers
        503 immediately — surfaced here as the ``RuntimeError`` the
        non-200 path already raises — instead of queueing the build.
        The canary driver probes with it so a wedged worker reads as
        an instant failure, not a piled-up queue."""
        if context_dir is not None:
            worker_ctx = self.prepare_context(context_dir)
            argv = list(argv) + [worker_ctx]
        self.last_build = {}  # stale outcome must not survive a retry
        self.last_events = []
        # The caller's current trace context rides along so the
        # worker-side build ADOPTS it (one trace id across client and
        # worker — loadgen/bench/fleet stitch for free). Only when the
        # caller HAS an explicit context (bound registry or open
        # span): attaching the process-global fallback id would merge
        # every build a bare process submits into one trace.
        from makisu_tpu_torch.utils import metrics
        headers = {}
        if metrics.has_trace_context():
            headers["traceparent"] = metrics.current_traceparent()
        if no_wait:
            headers["X-Makisu-No-Wait"] = "1"
        conn, resp = self._request(
            "POST", "/build", json.dumps(argv).encode(),
            tenant=tenant, headers=headers)
        build_code = 1
        try:
            if resp.status != 200:
                raise RuntimeError(
                    f"worker /build returned {resp.status}")
            for line in iter_stream_lines(resp):
                try:
                    payload = json.loads(line)
                except ValueError:
                    log.info(line.decode(errors="replace"))
                    continue
                if "build_code" in payload:
                    build_code = terminal_exit_code(payload)
                    self.last_build = payload
                elif "event" in payload:
                    self.last_events.append(payload["event"])
                    if on_event is not None:
                        on_event(payload["event"])
                else:
                    if on_line is not None:
                        on_line(payload)
                    log.info("[worker] %s", payload.get("msg", line))
        finally:
            conn.close()
        return build_code
