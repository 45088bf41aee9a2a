"""Fleet front door: the worker protocol, fronting N workers.

The server speaks the same unix-socket HTTP surface as a single worker
(``/ready``, ``/build``, ``/healthz``, ``/builds``, ``/metrics``,
``/exit``), so every existing consumer — :class:`WorkerClient`,
``makisu-tpu top``, loadgen, CI scripts — points at the fleet socket
unchanged. On top of that it adds the fleet-only surface:

- ``GET /fleet`` — the scheduler's full routing table: per-worker
  state, sticky placements, tenant quotas, recent decisions.
- ``GET /peers`` — the current peer map (also pushed to workers).
- ``POST /drain`` — ``{"worker": ID[, "undrain": true]}``: graceful
  drain (new builds route elsewhere; the worker stays up serving its
  in-flight builds and peer chunk fetches).

``POST /build`` is the routing path: admission (tenant quota +
fleet-wide cap) at the front door, then route → forward → stream the
worker's NDJSON frames through verbatim. The terminal frame is
augmented with ``worker``, ``fleet_verdict``, ``fleet_attempts`` and
``quota_wait_seconds`` so clients (and loadgen's fleet report) never
parse logs for routing outcomes. A worker that is unreachable, refuses
admission (the no-wait 503), or dies mid-stream is excluded and the
build retries on the next-best worker — log frames already forwarded
are not un-sent (duplicated lines are the documented cost of a
mid-stream failover; the terminal frame is emitted exactly once).

Copy of ``makisu_tpu/fleet/server.py``. Two differences: the listen
backlog is 128 (the reference keeps socketserver's 5, and a wave of
simultaneous submissions is refused at connect), and the canary builds
take ``--hasher gpu`` unless ``canary_hasher="cpu"`` is asked for, so a
canary reaches the card on each worker. The front door routes and
forwards only: it never imports torch.
"""

from __future__ import annotations

import collections
import json
import os
import socketserver
import threading
import time
from http.server import BaseHTTPRequestHandler

from makisu_tpu_torch.fleet import slo as slo_mod
from makisu_tpu_torch.fleet.scheduler import (
    FleetScheduler,
    NoWorkersError,
    WorkerSpec,
    build_identity,
)
from makisu_tpu_torch.utils import events
from makisu_tpu_torch.utils import logging as log
from makisu_tpu_torch.utils import metrics

# Attempts per build across distinct workers (initial + failovers).
MAX_ATTEMPTS = 3

# Read timeout for one worker's build stream: frames are heartbeat-ish
# (logs, events); a worker silent this long is wedged and the build is
# better restarted elsewhere. Generous — a 100k-file commit can be
# quiet for a while between frames.
STREAM_READ_TIMEOUT = 900.0

_LATENCY_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                    120.0, 300.0, 600.0, 1800.0)


def rewrite_storage(argv: list[str], storage: str) -> list[str]:
    """Rewrite/append ``--storage`` so the build lands on the routed
    worker's own storage (the per-worker override an in-process fleet
    uses to model per-machine disks). Handles both ``--storage PATH``
    and ``--storage=PATH`` spellings."""
    out = list(argv)
    for i, arg in enumerate(out):
        if arg == "--storage" and i + 1 < len(out):
            out[i + 1] = storage
            return out
        if arg.startswith("--storage="):
            out[i] = f"--storage={storage}"
            return out
    return out + ["--storage", storage]


class _FleetHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args) -> None:  # quiet
        pass

    # -- GET ---------------------------------------------------------------

    def do_GET(self) -> None:
        server: FleetServer = self.server
        if self.path == "/ready":
            ok = any(w.alive for w in
                     server.scheduler.workers.values())
            self._respond(200 if ok else 503,
                          b"ok" if ok else b"no workers alive")
        elif self.path == "/metrics":
            # Aggregated scrape: the front door's own series plus every
            # alive worker's re-exported under a worker="wN" label —
            # one Prometheus target sees the whole fleet.
            self._respond(
                200, server.aggregated_metrics().encode(),
                content_type="text/plain; version=0.0.4; "
                             "charset=utf-8")
        elif self.path == "/healthz":
            self._respond(200, json.dumps(server.health()).encode(),
                          content_type="application/json")
        elif self.path == "/builds":
            self._respond(200, json.dumps(server.builds()).encode(),
                          content_type="application/json")
        elif self.path == "/fleet":
            self._respond(200,
                          json.dumps(server.scheduler.stats()).encode(),
                          content_type="application/json")
        elif self.path == "/peers":
            stats = server.scheduler.stats()
            self._respond(200, json.dumps({
                "version": stats["peer_map_version"],
                "peers": [w["socket"] for w in stats["workers"]
                          if w["alive"]],
            }).encode(), content_type="application/json")
        elif self.path == "/alerts":
            self._respond(200, json.dumps(server.alerts()).encode(),
                          content_type="application/json")
        elif self.path == "/profile" or self.path.startswith("/profile?"):
            # Fleet-wide on-demand profiling: every alive worker
            # captures a ?seconds=N window in parallel and the merged
            # makisu-tpu.profile.v1 comes back — one request answers
            # "where is the FLEET's time going right now".
            from urllib.parse import parse_qs, urlsplit
            query = parse_qs(urlsplit(self.path).query)
            try:
                seconds = float((query.get("seconds") or ["5"])[0])
            except ValueError:
                self._respond(400, b"bad seconds")
                return
            self._respond(200,
                          json.dumps(server.profile(seconds)).encode(),
                          content_type="application/json")
        elif self.path == "/exit":
            threading.Thread(target=server.shutdown,
                             daemon=True).start()
            self._respond(200, b"bye")
        else:
            self._respond(404, b"not found")

    # -- POST --------------------------------------------------------------

    def do_POST(self) -> None:
        if self.path == "/drain":
            self._handle_drain()
        elif self.path == "/build":
            self._handle_build()
        else:
            self._respond(404, b"not found")

    def _handle_drain(self) -> None:
        length = int(self.headers.get("Content-Length", "0"))
        try:
            body = json.loads(self.rfile.read(length)) or {}
            worker_id = str(body["worker"])
            draining = not body.get("undrain", False)
        except (ValueError, KeyError, TypeError):
            self._respond(400, b'bad drain json (need {"worker": ID})')
            return
        if not self.server.scheduler.drain(worker_id, draining):
            self._respond(404, b"unknown worker")
            return
        snapshotted = 0
        if draining:
            # Checkpoint the draining worker's resident sessions into
            # the snapshot plane NOW: its contexts re-route on the next
            # build, and the prewarm path needs recipes to pull. Best-
            # effort — a worker that can't answer is already the case
            # drain exists for.
            snapshotted = self.server.checkpoint_worker(worker_id)
        self._respond(200, json.dumps(
            {"worker": worker_id, "draining": draining,
             "sessions_snapshotted": snapshotted}).encode(),
            content_type="application/json")

    def _handle_build(self) -> None:
        server: FleetServer = self.server
        length = int(self.headers.get("Content-Length", "0"))
        try:
            body = json.loads(self.rfile.read(length))
        except ValueError:
            self._respond(400, b"bad argv json")
            return
        tenant = ""
        traceparent = ""
        if isinstance(body, dict):
            argv = body.get("argv") or []
            tenant = str(body.get("tenant") or "")
            traceparent = str(body.get("traceparent") or "")
        else:
            argv = body
        tenant = self.headers.get("X-Makisu-Tenant") or tenant
        # The submitting client's trace context (header wins, like the
        # tenant): the front door ADOPTS it for this build's admit/
        # route/forward spans and hands its forward span down to the
        # worker — one trace id, front door to chunk wire.
        traceparent = self.headers.get("traceparent") or traceparent
        if not isinstance(argv, list) or not all(
                isinstance(a, str) for a in argv):
            self._respond(400, b"bad argv json")
            return

        self.send_response(200)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        emit_lock = threading.Lock()
        finished = threading.Event()

        def emit(line: str) -> None:
            data = (line.rstrip("\n") + "\n").encode()
            frame = f"{len(data):x}\r\n".encode() + data + b"\r\n"
            with emit_lock:
                if finished.is_set():
                    return
                try:
                    self.wfile.write(frame)
                except (BrokenPipeError, ConnectionResetError):
                    finished.set()  # client gone; keep the build going

        try:
            server.route_build(argv, tenant, emit,
                               traceparent=traceparent)
        finally:
            with emit_lock:
                if not finished.is_set():
                    finished.set()
                    try:
                        self.wfile.write(b"0\r\n\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass

    def _respond(self, status: int, body: bytes,
                 content_type: str | None = None) -> None:
        try:
            self.send_response(status)
            if content_type:
                self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass


class FleetServer(socketserver.ThreadingMixIn,
                  socketserver.UnixStreamServer):
    """The front door process: HTTP surface + scheduler + forwarder."""

    allow_reuse_address = True
    daemon_threads = True
    # A build farm's clients submit in waves: socketserver's default
    # backlog of 5 refuses most of a wave at connect (the worker's
    # server keeps 128 for the same reason).
    request_queue_size = 128

    def __init__(self, socket_path: str, specs: list[WorkerSpec],
                 poll_interval: float = 1.0,
                 tenant_quota: int = 0,
                 max_inflight: int = 0,
                 spillover_queue_depth: int = 2,
                 max_attempts: int = MAX_ATTEMPTS,
                 stall_window: float | None = None,
                 diag_out: str = "",
                 slo_config: str = "",
                 alert_webhook: str = "",
                 slo_interval: float | None = None,
                 canary_interval: float = 0.0,
                 canary_slow_seconds: float = 10.0,
                 canary_hasher: str = "gpu") -> None:
        if os.path.exists(socket_path):
            os.unlink(socket_path)
        super().__init__(socket_path, _FleetHandler)
        self.socket_path = socket_path
        self.max_attempts = max(int(max_attempts), 1)
        self.scheduler = FleetScheduler(
            specs, poll_interval=poll_interval,
            tenant_quota=tenant_quota, max_inflight=max_inflight,
            spillover_queue_depth=spillover_queue_depth)
        self._started_mono = time.monotonic()
        self._mu = threading.Lock()
        self._seq = 0
        self._pending: dict[int, dict] = {}
        self._done_ok = 0
        self._done_failed = 0
        self._latencies: collections.deque[float] = collections.deque(
            maxlen=512)
        # Failure forensics, at parity with WorkerServer: a process
        # flight recorder sees every routed build's spans and every
        # teed worker event (global sink), and an optional stall
        # watchdog — gated on in-flight forwarded builds — dumps a
        # bundle when the front door stops making progress mid-route.
        from makisu_tpu_torch.utils import flightrecorder, resources
        resources.ensure_started()
        self.recorder = flightrecorder.FlightRecorder()
        self._recorder_sink = self.recorder.record_event
        events.add_global_sink(self._recorder_sink)
        # Merged-trace collector: every event this process sees — the
        # front door's own admit/route/forward spans AND the worker
        # build events the forwarder tees back in — in one bounded
        # ring, the input `--trace-out` assembles into the merged
        # Perfetto export at shutdown.
        self._trace_events: collections.deque[dict] = \
            collections.deque(maxlen=65536)
        self._collector_sink = self._trace_events.append
        events.add_global_sink(self._collector_sink)
        self._watchdog = None
        if stall_window is None:
            stall_window = flightrecorder.stall_timeout_from_env()
        if stall_window > 0:
            self._watchdog = flightrecorder.StallWatchdog(
                stall_window, self.recorder,
                flightrecorder.forced_bundle_path(diag_out, "stall"),
                registry=metrics.global_registry(),
                active_fn=lambda: self.active_builds() > 0).start()
        self.scheduler.start()
        # SLO plane: the CanaryDriver (synthetic builds through each
        # alive worker; off by default — `makisu-tpu fleet` turns it
        # on) and the rule evaluator over the front door's own vitals
        # plus the canary series. Constructed after scheduler.start()
        # so the first tick sees a live worker view.
        self.canary = slo_mod.CanaryDriver(
            self.scheduler, interval=canary_interval,
            slow_seconds=canary_slow_seconds, hasher=canary_hasher)
        rules = slo_mod.default_fleet_rules()
        if slo_config:
            rules = slo_mod.load_rules(slo_config, rules)
        self.slo = slo_mod.SloEvaluator(
            self._slo_probe, rules, interval=slo_interval,
            webhook=alert_webhook, source="fleet")
        self.canary.start()
        self.slo.start()
        # Continuous profiling: the front door samples its own process
        # too (routing, forwarding, canaries), ownership-gated exactly
        # like the worker — in an in-process fleet the first server
        # armed the sampler and everyone shares it. A firing
        # page-severity fleet alert snapshots it next to the bundles.
        from makisu_tpu_torch.utils import profiler as profiler_mod
        self._diag_out = diag_out
        self._profiler_owner = False
        self.profiler = profiler_mod.process_profiler()
        profile_hz = profiler_mod.resolve_hz()
        if self.profiler is None and profile_hz > 0:
            self.profiler = profiler_mod.SamplingProfiler(
                hz=profile_hz).start()
            profiler_mod.set_process_profiler(self.profiler)
            self._profiler_owner = True
        self.slo.manager.on_fire = self._profile_on_page

    def get_request(self):
        request, _ = super().get_request()
        return request, ("fleet", 0)

    def handle_error(self, request, client_address) -> None:
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError)):
            return  # client hung up; normal churn
        super().handle_error(request, client_address)

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def server_close(self) -> None:
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        from makisu_tpu_torch.utils import profiler as profiler_mod
        if self._profiler_owner and self.profiler is not None:
            self.profiler.stop()
            if profiler_mod.process_profiler() is self.profiler:
                profiler_mod.set_process_profiler(None)
        self.slo.stop()
        self.canary.stop()
        events.remove_global_sink(self._collector_sink)
        events.remove_global_sink(self._recorder_sink)
        self.scheduler.stop()
        super().server_close()

    def active_builds(self) -> int:
        with self._mu:
            return len(self._pending)

    def trace_events(self) -> list[dict]:
        """Snapshot of the merged-trace collector ring (lock-free,
        retried on concurrent mutation)."""
        return metrics.snapshot_concurrent(self._trace_events)

    def collect_serve_access(self) -> list[dict]:
        """Fetch every alive worker's ``/serve/access`` ledger and
        return the rows as worker-tagged ``serve_access`` events. In
        a REAL fleet the workers are separate processes, so their
        access rows (the bytes-on-wire input to the merged trace)
        never reach this process's sinks on their own — the shutdown
        merge pulls them here. Rows keep the ledger's own timestamps,
        identical to the worker's direct emission, so in-process
        fleets (which see both copies) dedupe in the assembler."""
        from makisu_tpu_torch.worker.client import WorkerClient
        stats = self.scheduler.stats()
        out: list[dict] = []
        for w in stats["workers"]:
            if not w["alive"]:
                continue
            client = WorkerClient(w["socket"], connect_timeout=2.0,
                                  control_timeout=5.0, retries=0)
            try:
                conn, resp = client._control("/serve/access")
                try:
                    if resp.status != 200:
                        continue
                    entries = json.loads(resp.read()).get("entries",
                                                          [])
                finally:
                    conn.close()
            except (OSError, RuntimeError, ValueError):
                continue
            for entry in entries:
                ev = dict(entry)
                ev["type"] = "serve_access"
                ev["worker"] = w["id"]
                out.append(ev)
        return out

    # -- the routing/forwarding path ---------------------------------------

    def route_build(self, argv: list[str], tenant: str, emit,
                    traceparent: str = "") -> int:
        """Admit, route, forward, failover. ``emit(line)`` streams
        NDJSON frames to the submitting client; the terminal frame is
        always emitted exactly once (a synthesized failure frame when
        every attempt is exhausted).

        Every build gets its own trace registry here — ADOPTED from
        the submitter's ``traceparent`` when one arrived (malformed
        values mint fresh ids, counted) — so the front door's
        admit/route/forward spans, the worker's build (which adopts
        the forward span's context), and the peer/serve fetches it
        issues all share ONE trace id. The spans leave the process as
        events (global sinks: the flight recorder, the promoted
        ``--events-out`` writer, the merged-trace collector)."""
        t0 = time.monotonic()
        context_key, command = build_identity(argv)
        registry = metrics.MetricsRegistry()
        metrics.adopt_inbound(registry, traceparent)
        reg_token = metrics.set_build_registry(registry)
        with self._mu:
            self._seq += 1
            seq = self._seq
            self._pending[seq] = {
                "id": seq, "tenant": tenant, "state": "admitting",
                "context": context_key, "command": command,
                "worker": "", "enqueued_mono": t0,
                "trace_id": registry.trace_id,
            }
        scheduler = self.scheduler
        quota_wait = 0.0
        exclude: set[str] = set()
        exit_code = 1
        terminal_sent = False
        events.emit("build_start", trace_id=registry.trace_id,
                    command="fleet_build", role="frontdoor",
                    tenant=tenant or "")
        try:
            with metrics.span("fleet_build", tenant=tenant or "",
                              context=os.path.basename(context_key)
                              if context_key else command or "?"):
                with metrics.span("fleet_admit", tenant=tenant or ""):
                    quota_wait = scheduler.admit(tenant, context_key)
                for attempt in range(self.max_attempts):
                    try:
                        with metrics.span("fleet_route",
                                          attempt=attempt):
                            worker, verdict, reason = scheduler.route(
                                context_key, tenant, exclude=exclude,
                                attempt=attempt)
                    except NoWorkersError as e:
                        emit(json.dumps({"level": "error",
                                         "msg": str(e)}))
                        break
                    with self._mu:
                        row = self._pending.get(seq)
                        if row is not None:
                            row.update(state="forwarded",
                                       worker=worker.spec.id,
                                       verdict=verdict)
                    forward_argv = argv
                    if worker.spec.storage:
                        forward_argv = rewrite_storage(
                            argv, worker.spec.storage)
                    # Prewarm: a context-keyed build routed AWAY from
                    # its session holder (placement change, drain,
                    # health demotion, failover) pushes the session
                    # snapshot's chunk plan at the target over the
                    # peer wire first, so the build lands on a warm
                    # restore instead of a cold rebuild. Best-effort
                    # and bounded; affinity routes skip it — the
                    # session is already there.
                    if context_key and verdict != "affinity":
                        with metrics.span("fleet_prewarm",
                                          worker=worker.spec.id):
                            self._prewarm(context_key, worker)
                    # No-wait admission only when a refusal still has
                    # somewhere ELIGIBLE to go (dead/draining workers
                    # are not alternatives), never for an affinity
                    # route — waiting at the session holder (a warm
                    # replay) beats a cold build elsewhere — and never
                    # on the LAST attempt: a fully
                    # saturated fleet must end with the build queueing
                    # somewhere, not with every worker having politely
                    # refused it.
                    no_wait = (verdict != "affinity"
                               and attempt + 1 < self.max_attempts
                               and scheduler.eligible_count(
                                   exclude | {worker.spec.id}) >= 1)
                    # One forward span per attempt: failover attempts
                    # land as SIBLING subtrees under fleet_build, each
                    # carrying its worker/verdict — and the worker
                    # adopts THIS span's context, so its whole build
                    # tree nests under the attempt that ran it.
                    with metrics.span("fleet_forward",
                                      worker=worker.spec.id,
                                      verdict=verdict,
                                      attempt=attempt):
                        outcome, code = self._forward(
                            worker, forward_argv, tenant, emit,
                            no_wait,
                            terminal_extra={
                                "worker": worker.spec.id,
                                "fleet_verdict": verdict,
                                "fleet_reason": reason,
                                "fleet_attempts": attempt + 1,
                                "quota_wait_seconds": round(
                                    quota_wait, 3),
                                "trace_id": registry.trace_id,
                            })
                    if outcome == "done":
                        scheduler.note_build_done(worker.spec.id)
                        exit_code = code
                        terminal_sent = True
                        return code
                    scheduler.note_worker_failure(worker.spec.id,
                                                  outcome)
                    exclude.add(worker.spec.id)
                    log.warning("fleet: build attempt %d on %s failed "
                                "(%s); failing over", attempt + 1,
                                worker.spec.id, outcome)
                return exit_code
        finally:
            if not terminal_sent:
                emit(json.dumps({
                    "build_code": str(exit_code),
                    "exit_code": exit_code,
                    "error": "fleet: no worker could run this build",
                    "elapsed_seconds": round(time.monotonic() - t0, 3),
                    "quota_wait_seconds": round(quota_wait, 3),
                    "tenant": tenant,
                    "trace_id": registry.trace_id,
                }))
            scheduler.release(tenant)
            latency = time.monotonic() - t0
            with self._mu:
                self._pending.pop(seq, None)
                if exit_code == 0:
                    self._done_ok += 1
                else:
                    self._done_failed += 1
                self._latencies.append(latency)
            metrics.global_registry().observe(
                metrics.FLEET_BUILD_LATENCY, latency,
                buckets=_LATENCY_BUCKETS,
                tenant=scheduler.tenant_label(tenant))
            events.emit("build_end", trace_id=registry.trace_id,
                        exit_code=exit_code)
            metrics.reset_build_registry(reg_token)

    def _prewarm(self, context_key: str, worker) -> bool:
        """Best-effort session-snapshot push: pull the context's
        recipe from the best source worker (session holders first),
        POST it at the routed-to target, let the target fetch the
        chunks over the existing peer wire. Every failure is swallowed
        — the build proceeds cold, exactly as before prewarm existed —
        but the attempt lands in the decision ledger either way."""
        from makisu_tpu_torch.worker.client import WorkerClient
        scheduler = self.scheduler
        target_id = worker.spec.id
        recipe = None
        source_id = ""
        for wid, socket_path in scheduler.snapshot_sources(
                context_key, exclude={target_id}):
            client = WorkerClient(socket_path, connect_timeout=2.0,
                                  control_timeout=10.0, retries=0)
            try:
                recipe = client.session_snapshot(context_key)
                source_id = wid
                break
            except (OSError, RuntimeError, ValueError):
                continue
        if recipe is None:
            # Nothing to push: no snapshot exists anywhere (a cold
            # context) — not a failure worth ledger noise.
            return False
        target = WorkerClient(worker.spec.socket_path,
                              connect_timeout=2.0,
                              control_timeout=30.0, retries=0)
        payload: dict = {"recipe": recipe}
        if worker.spec.storage:
            payload["storage"] = worker.spec.storage
        try:
            result = target.restore_session(payload)
            ok = bool(result.get("ok"))
            reason = str(result.get("reason", ""))
        except (OSError, RuntimeError, ValueError) as e:
            ok, reason = False, f"push_failed:{type(e).__name__}"
        scheduler.note_prewarm(context_key, target_id, ok,
                               reason or "staged", source=source_id)
        return ok

    def checkpoint_worker(self, worker_id: str) -> int:
        """POST /sessions/snapshot at one worker (the drain hand-off);
        returns the number of sessions checkpointed (0 on any
        failure)."""
        from makisu_tpu_torch.worker.client import WorkerClient
        with self.scheduler._mu:
            state = self.scheduler.workers.get(worker_id)
            socket_path = state.spec.socket_path if state else ""
        if not socket_path:
            return 0
        client = WorkerClient(socket_path, connect_timeout=2.0,
                              control_timeout=30.0, retries=0)
        try:
            return int(client.snapshot_sessions().get(
                "snapshotted", 0))
        except (OSError, RuntimeError, ValueError) as e:
            log.warning("fleet: drain checkpoint of %s failed: %s",
                        worker_id, e)
            return 0

    def _forward(self, worker, argv: list[str], tenant: str, emit,
                 no_wait: bool, terminal_extra: dict,
                 ) -> tuple[str, int]:
        """One attempt against one worker. Returns ``(outcome, code)``
        where outcome is ``done`` (terminal frame relayed), or the
        failover reason: ``unreachable`` | ``refused`` |
        ``midstream``."""
        import http.client as http_client

        from makisu_tpu_torch.worker.client import _UnixHTTPConnection
        headers = {"Content-Type": "application/json"}
        if tenant:
            headers["X-Makisu-Tenant"] = tenant
        if no_wait:
            headers["X-Makisu-No-Wait"] = "1"
        # The worker adopts the current span's context — the
        # fleet_forward span this attempt runs under — so its whole
        # build tree nests under this attempt in the merged trace.
        # Fleet provenance rides the body into the build's history
        # record (worker, verdict, attempts, quota wait).
        headers["traceparent"] = metrics.current_traceparent()
        body = json.dumps({
            "argv": argv,
            "fleet": {
                # The scheduler-assigned id ("w0"), not the socket
                # path: the worker records this as its history
                # provenance, and every other surface (terminal
                # frames, top, doctor, report --fleet) names workers
                # by id — the history record must cross-reference.
                "worker": terminal_extra.get("worker", ""),
                "verdict": terminal_extra.get("fleet_verdict", ""),
                "attempts": terminal_extra.get("fleet_attempts", 1),
                "quota_wait_seconds": terminal_extra.get(
                    "quota_wait_seconds", 0.0),
            },
        }).encode()
        conn = _UnixHTTPConnection(worker.spec.socket_path,
                                   STREAM_READ_TIMEOUT,
                                   connect_timeout=5.0)
        try:
            try:
                conn.request("POST", "/build", body=body,
                             headers=headers)
                resp = conn.getresponse()
            except (OSError, http_client.HTTPException):
                return "unreachable", 1
            if resp.status == 503:
                resp.read()
                return "refused", 1
            if resp.status != 200:
                # The worker answered but can't run this (bad argv
                # would 400 on every worker): relay as a failure, no
                # failover churn.
                emit(json.dumps({
                    "level": "error",
                    "msg": f"worker {worker.spec.id} rejected build: "
                           f"HTTP {resp.status}"}))
                emit(json.dumps({"build_code": "1", "exit_code": 1,
                                 **terminal_extra}))
                return "done", 1
            from makisu_tpu_torch.worker.client import (
                iter_stream_lines,
                terminal_exit_code,
            )
            try:
                # One framing loop shared with WorkerClient.build
                # (iter_stream_lines) — the forwarder only json-parses
                # candidate TERMINAL lines; everything else passes
                # through verbatim.
                for line in iter_stream_lines(resp):
                    payload = None
                    if b'"build_code"' in line:
                        try:
                            payload = json.loads(line)
                        except ValueError:
                            payload = None
                    if payload is not None \
                            and "build_code" in payload:
                        payload.update(terminal_extra)
                        emit(json.dumps(payload))
                        return "done", terminal_exit_code(payload)
                    # Tee worker build events into the front door's
                    # own sinks (worker-tagged, original timestamps)
                    # — this is what makes the fleet's --events-out /
                    # merged trace CROSS-process: the worker's span
                    # events land beside the forward span that owns
                    # them. The frame still forwards to the client
                    # verbatim.
                    if b'"event"' in line:
                        try:
                            frame = json.loads(line)
                        except ValueError:
                            frame = None
                        if isinstance(frame, dict) \
                                and isinstance(frame.get("event"),
                                               dict):
                            teed = dict(frame["event"])
                            teed.setdefault("worker", worker.spec.id)
                            events.deliver(teed)
                    emit(line.decode(errors="replace"))
                # EOF without a terminal frame: the worker died.
                return "midstream", 1
            except (OSError, http_client.HTTPException):
                # A SIGKILLed worker surfaces as IncompleteRead (an
                # HTTPException, not an OSError) on a chunked stream.
                return "midstream", 1
        finally:
            conn.close()

    # -- introspection -----------------------------------------------------

    def aggregated_metrics(self) -> str:
        """The fleet ``GET /metrics`` payload: the front door's own
        process series plus every ALIVE worker's scrape re-exported
        under a ``worker="wN"`` label, merged into one valid
        exposition (one family group per metric) — a single Prometheus
        target covers the whole fleet. A worker whose scrape fails
        costs its own timeout and a counted error, never the whole
        response. The scrapes fan out in parallel, like /builds."""
        from concurrent.futures import ThreadPoolExecutor

        from makisu_tpu_torch.worker.client import WorkerClient
        stats = self.scheduler.stats()
        alive = [w for w in stats["workers"] if w["alive"]]
        g = metrics.global_registry()

        def scrape(w):
            client = WorkerClient(w["socket"], connect_timeout=2.0,
                                  control_timeout=5.0, retries=0)
            try:
                text = client.metrics()
            except (OSError, RuntimeError, ValueError):
                g.counter_add(metrics.FLEET_AGGREGATED_SCRAPES,
                              result="error")
                return w, None
            g.counter_add(metrics.FLEET_AGGREGATED_SCRAPES,
                          result="ok")
            return w, text

        if alive:
            with ThreadPoolExecutor(min(8, len(alive))) as pool:
                fetched = list(pool.map(scrape, alive))
        else:
            fetched = []
        # makisu_worker_up: 1 iff this scrape round actually reached
        # the worker — dead workers (never scraped) and alive-but-
        # failed scrapes both read 0. Rendered from a throwaway
        # registry so the gauge reflects THIS response, not a stale
        # process-global value for a worker that vanished.
        reachable = {w["id"] for w, text in fetched if text is not None}
        up = metrics.MetricsRegistry()
        for w in stats["workers"]:
            up.gauge_set(metrics.WORKER_UP,
                         1 if w["id"] in reachable else 0,
                         worker=w["id"])
        parts = [metrics.render_prometheus(),
                 metrics.render_prometheus(up)]
        for w, text in fetched:
            if text is not None:
                parts.append(metrics.relabel_prometheus(
                    text, worker=w["id"]))
        return metrics.merge_prometheus(parts)

    def _slo_probe(self) -> dict:
        """The fleet evaluator's sample: front-door build counters,
        canary series, and scheduler-derived level signals. Every
        input already exists — this just snapshots it."""
        with self._mu:
            ok, failed = self._done_ok, self._done_failed
        counters: dict = {
            "builds_started": float(ok + failed),
            "builds_failed": float(failed),
        }
        counters.update(self.canary.counters())
        stats = self.scheduler.stats()
        alive = [w for w in stats["workers"] if w["alive"]]
        version = stats["peer_map_version"]
        acked = stats.get("peer_acked", {})
        levels: dict = {
            # Alive workers that have not acked the current peer map.
            "peer_map_lag": float(sum(
                1 for w in alive if acked.get(w["id"]) != version)),
            "dead_workers": float(
                len(stats["workers"]) - len(alive)),
            "frontdoor_queue": float(stats["frontdoor_waiting"]),
        }
        levels.update(self.canary.levels())
        return {"counters": counters, "levels": levels}

    def alerts(self) -> dict:
        """``GET /alerts``: the front door's own alert snapshot plus
        every alive worker's, fanned out in parallel (same discipline
        as /builds — one slow worker costs its own timeout)."""
        from concurrent.futures import ThreadPoolExecutor

        from makisu_tpu_torch.worker.client import WorkerClient
        out = self.slo.manager.snapshot()
        out["source"] = "fleet"
        out["rules"] = [r.name for r in self.slo.rules]
        out["canary"] = self.canary.status()
        stats = self.scheduler.stats()
        alive = [w for w in stats["workers"] if w["alive"]]

        def fetch(w):
            client = WorkerClient(w["socket"], connect_timeout=2.0,
                                  control_timeout=5.0, retries=0)
            try:
                return w, client.alerts()
            except (OSError, RuntimeError, ValueError):
                return w, None

        if alive:
            with ThreadPoolExecutor(min(8, len(alive))) as pool:
                fetched = list(pool.map(fetch, alive))
        else:
            fetched = []
        workers: dict = {}
        for w, payload in fetched:
            workers[w["id"]] = (payload if payload is not None
                                else {"error": "unreachable"})
        for w in stats["workers"]:
            if not w["alive"]:
                workers[w["id"]] = {"error": "dead"}
        out["workers"] = workers
        return out

    def profile(self, seconds: float) -> dict:
        """``GET /profile?seconds=N``: ask every alive worker for an
        on-demand capture window in parallel (same fan-out discipline
        as /metrics — a dead worker costs its own timeout, never the
        round) and merge the answers into one fleet-wide
        ``makisu-tpu.profile.v1`` document with per-worker vitals."""
        from concurrent.futures import ThreadPoolExecutor

        from makisu_tpu_torch.utils import profiler as profiler_mod
        from makisu_tpu_torch.worker.client import WorkerClient
        seconds = min(max(float(seconds), 0.1), 30.0)
        stats = self.scheduler.stats()
        alive = [w for w in stats["workers"] if w["alive"]]

        def capture(w):
            client = WorkerClient(w["socket"], connect_timeout=2.0,
                                  control_timeout=10.0, retries=0)
            try:
                return w, client.profile(seconds=seconds)
            except (OSError, RuntimeError, ValueError):
                return w, None

        if alive:
            with ThreadPoolExecutor(min(8, len(alive))) as pool:
                fetched = list(pool.map(capture, alive))
        else:
            fetched = []
        docs = {w["id"]: doc for w, doc in fetched if doc is not None}
        merged = profiler_mod.merge_profiles(docs)
        merged["unreachable"] = sorted(
            w["id"] for w, doc in fetched if doc is None)
        return merged

    def profiler_health(self) -> dict:
        if self.profiler is None:
            return {"enabled": False, "hz": 0.0, "samples_total": 0,
                    "dropped": 0, "throttled": 0, "distinct_stacks": 0,
                    "overhead_fraction": 0.0}
        return self.profiler.stats()

    def _profile_on_page(self, payload: dict) -> None:
        """AlertManager ``on_fire`` hook: a page-severity fleet alert
        writes the front door's sampler snapshot beside the bundles."""
        from makisu_tpu_torch.utils import flightrecorder
        from makisu_tpu_torch.utils import profiler as profiler_mod
        sampler = self.profiler
        if sampler is None or not sampler.samples_total:
            return
        rule = str(payload.get("rule", "page")).replace("/", "_")
        profiler_mod.write_artifact(
            flightrecorder.forced_profile_path(
                self._diag_out, f"alert-{rule}"),
            sampler.snapshot(command=f"alert-{rule}"))

    def health(self) -> dict:
        """Worker-shaped ``/healthz`` (so ``top`` and WorkerClient
        work against the fleet socket) plus the ``fleet`` section and
        a ``self`` section — the front door's OWN vitals: poll ages,
        peer-map version fan-out, decision-ring stats, progress
        clock, forensics armament."""
        from makisu_tpu_torch.utils import flightrecorder
        stats = self.scheduler.stats()
        with self._mu:
            pending = len(self._pending)
            ok, failed = self._done_ok, self._done_failed
            latencies = list(self._latencies)
        alive = [w for w in stats["workers"] if w["alive"]]
        poll_ages = [w["last_poll_age_seconds"]
                     for w in stats["workers"]
                     if w["last_poll_age_seconds"] is not None]
        decisions = stats.get("recent_decisions", [])
        ring_verdicts: dict[str, int] = {}
        for row in decisions:
            v = row.get("verdict", "?")
            ring_verdicts[v] = ring_verdicts.get(v, 0) + 1
        version = stats["peer_map_version"]
        acked = stats.get("peer_acked", {})
        stale_acks = sorted(
            w["id"] for w in alive
            if acked.get(w["id"]) is not None
            and acked[w["id"]] < version)
        g = metrics.global_registry()
        self_section = {
            "poll_interval_seconds": self.scheduler.poll_interval,
            "oldest_poll_age_seconds": (round(max(poll_ages), 3)
                                        if poll_ages else None),
            "peer_map": {
                "version": version,
                "acked": acked,
                "stale_acks": stale_acks,
            },
            "decision_ring": {
                "size": len(decisions),
                "verdicts": ring_verdicts,
            },
            "last_progress_seconds": round(
                flightrecorder.last_progress_seconds(), 3),
            "events_dropped": int(g.counter_total(
                "makisu_events_dropped_total")),
            "watchdog_armed": self._watchdog is not None,
        }
        return {
            "status": "ok" if alive else "degraded",
            "role": "fleet",
            "uptime_seconds": round(
                time.monotonic() - self._started_mono, 3),
            "builds_started": ok + failed + pending,
            "builds_succeeded": ok,
            "builds_failed": failed,
            "active_builds": pending,
            "last_progress_seconds": round(
                flightrecorder.last_progress_seconds(), 3),
            "queue": {
                "depth": stats["frontdoor_waiting"],
                "max_concurrent_builds": 0,
                "wait_seconds": {},
                "latency_seconds": metrics.percentile_stats(latencies),
                "tenant_latency_seconds": {},
            },
            "fleet": stats,
            "alerts": self.slo.manager.digest(),
            "profiler": self.profiler_health(),
            "self": self_section,
        }

    def builds(self) -> dict:
        """Aggregated ``GET /builds``: every alive worker's view, rows
        tagged with the worker id, plus the front door's own pending
        (admitting/forwarded) rows. The per-worker GETs fan out in
        parallel: one slow-but-connectable worker must cost the
        aggregate its OWN timeout, not a serial sum that freezes every
        ``top`` poller."""
        from concurrent.futures import ThreadPoolExecutor

        from makisu_tpu_torch.worker.client import WorkerClient
        stats = self.scheduler.stats()
        alive = [w for w in stats["workers"] if w["alive"]]
        inflight: list[dict] = []
        recent: list[dict] = []

        def fetch(w):
            client = WorkerClient(w["socket"], connect_timeout=2.0,
                                  control_timeout=5.0, retries=0)
            try:
                return w, client.builds()
            except (OSError, RuntimeError, ValueError):
                return w, None

        if alive:
            with ThreadPoolExecutor(min(8, len(alive))) as pool:
                fetched = list(pool.map(fetch, alive))
        else:
            fetched = []
        for w, payload in fetched:
            if payload is None:
                continue
            for row in payload.get("inflight", []):
                row = dict(row)
                row["worker"] = w["id"]
                inflight.append(row)
            for row in payload.get("recent", []):
                row = dict(row)
                row["worker"] = w["id"]
                recent.append(row)
        now = time.monotonic()
        with self._mu:
            pending_rows = [
                {"id": -row["id"], "worker": row["worker"] or "-",
                 "tenant": row["tenant"], "state": row["state"],
                 "command": row["command"],
                 "tag": os.path.basename(row["context"] or ""),
                 "queue_wait_seconds": round(
                     now - row["enqueued_mono"], 3),
                 "age_seconds": round(now - row["enqueued_mono"], 3),
                 "progress_age_seconds": 0.0, "cache": {}}
                for row in self._pending.values()
                if row["state"] == "admitting"]
        # Workers already serve `recent` newest-first; keep their
        # relative order under the merge (no cross-worker clock to
        # sort by).
        return {
            "queue_depth": stats["frontdoor_waiting"],
            "max_concurrent_builds": 0,
            "inflight": pending_rows + inflight,
            "recent": recent[:32],
        }
