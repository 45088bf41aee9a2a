"""Worker server: accept build requests over a unix socket.

Copy of ``makisu_tpu/worker/server.py``. Protocol (reference:
lib/client/client.go):

- GET  /ready  -> 200 when accepting builds
- POST /build  -> body is a JSON argv list for the command (or
  ``{"argv": [...], "tenant": "..."}``; the ``X-Makisu-Tenant`` header
  also names the tenant); the response streams newline-delimited JSON
  frames: log lines, build events (``{"event": {...}}``) and the
  terminal ``{"build_code": "<exit code>", ...}``
- GET  /metrics -> Prometheus text of the process registry
- GET  /healthz -> uptime, builds started/succeeded/failed/active, the
  admission queue's depth and wait/latency percentiles, the cache's
  economics, the device plane, the sessions, alerts and the profiler
- GET  /builds -> in-flight and recently finished builds as JSON
- GET  /sessions, POST /sessions/invalidate, GET and POST
  /sessions/snapshot, POST /sessions/restore -> the resident build
  sessions and their snapshot plane
- GET  /alerts -> the SLO evaluator's active and resolved alerts
- GET  /profile?seconds=N -> a sampled profile window
- GET  /chunks/<fp>, /recipes/<layer>, /packs/<pack> (Range),
  /zpacks/<pack> (Range) -> the chunk bytes, signed layer recipes and
  pack spans of the storages this worker's builds used: what peers and
  delta pullers fetch (``serve/server.py``); /serve/access -> the ring of
  those requests with each one's inbound trace id
- GET  /peers, POST /peers -> the peer map (``fleet/peers.py``) its
  builds ask for missing chunks before the registry
- GET  /storage[?eviction_budget=N] -> per storage dir: a fresh census,
  the reference audit, the content store's tiers and budget, the latest
  scrub cycle, and (with a budget) the eviction dry run
- GET  /exit   -> 200, then the server shuts down

Every build runs in this process through ``cli.main(argv, device=...)``
on a handler thread of its own, so concurrent builds share one process
and, with ``MAKISU_TPU_SHARED_HASH=1`` (set here), one hash service: the
ring passes of concurrent builds go to the card in shared S1 launches
(``chunker/service.py``), each build's session on a CUDA stream of its
own thread. ``device`` is the card unless the caller passes
``device="cpu"`` (the tests); a worker on the card refuses to start on a
host without CUDA, then starts the device plane's probe in the
background (``backend.warm_probe``: context, kernels, G1 against its
plain version and S1 against hashlib) and accepts connections at once,
so a wedged card still answers ``/healthz``, its ``device.probe`` naming
the phase, and builds wait only the rest of the probe's budget
(``MAKISU_TPU_WORKER_WARM_PROBE=0`` skips the probe, ``=1`` forces it).

Admission: ``max_concurrent_builds`` caps concurrently executing builds;
arrivals beyond the cap wait in a FIFO queue in front of execution, with
its depth gauge and wait/latency histograms labelled per tenant.

A worker serves: its builds publish each indexed layer's recipe and
pack tables (``serve/``), and ``/healthz`` carries the ``serve`` digest
of its storages and its ``peer_map_version``.

Storage governance: ``/healthz`` carries a ``storage`` digest of the
storage dirs its builds used (a census cached for
``MAKISU_TPU_CENSUS_TTL_SECONDS``, the chunk CAS's LRU seed state, the
content store's budget, pressure and eviction counters, and finding
counts). At build end a tenant's layers join the census's attribution
sidecar, and the content store enforces its byte budget
(``--storage-budget``); a background scrub (every
``MAKISU_TPU_STORAGE_SCRUB_SECONDS``, 0 = off) re-hashes sampled
chunks and zpack frames and enforces the budget on the same cadence.
A ``/build`` body's ``fleet`` object (the front door's routing outcome:
worker id, verdict, attempts, quota wait) rides into the build's
history record.
"""

from __future__ import annotations

import collections
import json
import os
import socketserver
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler

# Prometheus text exposition content type (format 0.0.4).
_METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Histogram buckets for queue wait / build latency: builds span four
# orders of magnitude (sub-second scratch builds to multi-minute
# 100k-file trees), so the default millisecond ladder is too fine.
_LATENCY_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                    120.0, 300.0, 600.0, 1800.0)

# Finished-build ring size for GET /builds "recent": one wave of
# BASELINE.md config 5's 64 concurrent build jobs.
_RECENT_BUILDS_KEEP = 64

# Cap on distinct tenant label values in the latency rings and the
# process registry's histograms. The tenant string is client-supplied;
# past the cap, tenants aggregate under "other", so a client stamping
# unique strings cannot grow a long-lived worker's memory or /metrics
# without bound.
_TENANT_LABELS_KEEP = 32
_TENANT_OVERFLOW = "other"


# Storage knobs: the census TTL bounds how often a /healthz poll may
# walk a storage dir; the scrub interval paces the background integrity
# cycle (0 disables it). Scrub findings kept for /healthz and /storage:
_SCRUB_FINDINGS_KEEP = 64


def _census_ttl_seconds() -> float:
    try:
        return float(os.environ.get(
            "MAKISU_TPU_CENSUS_TTL_SECONDS", "60"))
    except ValueError:
        return 60.0


def _scrub_interval_seconds() -> float:
    try:
        return float(os.environ.get(
            "MAKISU_TPU_STORAGE_SCRUB_SECONDS", "300"))
    except ValueError:
        return 300.0


class _QuantileRing:
    """Bounded ring of raw observations with exact percentile export:
    what ``/healthz`` serves (exact p50/p90/p99 over the last N builds,
    no bucket interpolation)."""

    def __init__(self, cap: int = 512) -> None:
        self._vals: collections.deque[float] = collections.deque(
            maxlen=cap)
        self._mu = threading.Lock()

    def add(self, value: float) -> None:
        with self._mu:
            self._vals.append(value)

    def stats(self) -> dict:
        from makisu_tpu_torch.utils import metrics
        with self._mu:
            vals = list(self._vals)
        return metrics.percentile_stats(vals)


class _AdmissionQueue:
    """FIFO admission in front of build execution. ``limit <= 0`` means
    unlimited (acquire never blocks). A released slot transfers straight
    to the oldest waiter, so admission order is arrival order."""

    def __init__(self, limit: int) -> None:
        self.limit = limit
        self._mu = threading.Lock()
        self._waiters: collections.deque[threading.Event] = \
            collections.deque()
        self._running = 0

    def _publish_depth(self) -> None:
        # The process registry: admission runs on handler threads before
        # and after any build's registry is bound.
        from makisu_tpu_torch.utils import metrics
        metrics.global_registry().gauge_set(
            "makisu_worker_queue_depth", len(self._waiters))

    def acquire(self) -> float:
        """Block until a slot frees (FIFO); returns seconds waited."""
        if self.limit <= 0:
            return 0.0
        t0 = time.monotonic()
        with self._mu:
            if self._running < self.limit and not self._waiters:
                self._running += 1
                return 0.0
            gate = threading.Event()
            self._waiters.append(gate)
            self._publish_depth()
        gate.wait()
        return time.monotonic() - t0

    def release(self) -> None:
        if self.limit <= 0:
            return
        with self._mu:
            if self._waiters:
                # The slot transfers: _running stays constant.
                self._waiters.popleft().set()
                self._publish_depth()
            else:
                self._running -= 1

    def depth(self) -> int:
        with self._mu:
            return len(self._waiters)

    def would_block(self) -> bool:
        """Whether an acquire right now would wait (advisory: the answer
        can go stale before the build acquires)."""
        if self.limit <= 0:
            return False
        with self._mu:
            return self._running >= self.limit or bool(self._waiters)


class _BuildRecord:
    """One build's row in ``GET /builds``: identity, queue state, and a
    live digest fed by the build's own event stream (trace id from
    ``build_start``, phase from ``span_start``, progress age from any
    event, cache economics from ``cache_decision`` events)."""

    def __init__(self, seq: int, tenant: str, argv: list[str]) -> None:
        from makisu_tpu_torch.utils import ledger
        self.seq = seq
        self.tenant = tenant
        self.command = next(
            (a for a in argv if not a.startswith("-")), "")
        self.tag = self._tag_of(argv)
        self.state = "queued"
        self.trace_id = ""
        self.phase = ""
        self.exit_code: int | None = None
        self.queue_wait_seconds = 0.0
        self.enqueued_mono = time.monotonic()
        self.started_mono: float | None = None
        self.finished_mono: float | None = None
        self._last_event_mono = self.enqueued_mono
        self._mu = threading.Lock()
        self._ledger = ledger.LedgerSummary()
        # Layer hexes this build's cache decisions named (the key and
        # layer fields): the rows of the census's tenant attribution.
        self._layer_hexes: set[str] = set()

    @staticmethod
    def _tag_of(argv: list[str]) -> str:
        for i, arg in enumerate(argv):
            if arg in ("-t", "--tag") and i + 1 < len(argv):
                return argv[i + 1]
            if arg.startswith("--tag="):
                return arg.split("=", 1)[1]
        return ""

    def note_event(self, event: dict) -> None:
        """Event-bus sink: field updates under the record's lock (the
        build's own threads emit concurrently)."""
        from makisu_tpu_torch.utils import ledger as ledger_mod
        from makisu_tpu_torch.utils import traceexport
        etype = event.get("type")
        with self._mu:
            self._last_event_mono = time.monotonic()
            if etype == "build_start":
                self.trace_id = event.get("trace_id", "")
            elif etype == "span_start":
                phase = traceexport.phase_of(event.get("name", ""))
                if phase != "other":
                    self.phase = phase
            elif etype == ledger_mod.EVENT_TYPE:
                self._ledger.add(event)
                for value in (event.get("key"), event.get("layer")):
                    value = str(value or "")
                    if len(value) == 64 and all(
                            c in "0123456789abcdef" for c in value):
                        self._layer_hexes.add(value)

    def layer_hexes(self) -> set[str]:
        with self._mu:
            return set(self._layer_hexes)

    def start_running(self, queue_wait: float) -> None:
        with self._mu:
            self.state = "running"
            self.queue_wait_seconds = queue_wait
            self.started_mono = time.monotonic()
            self._last_event_mono = self.started_mono

    def finish(self, exit_code: int) -> None:
        with self._mu:
            self.state = "finished"
            self.exit_code = exit_code
            self.finished_mono = time.monotonic()

    def latency_seconds(self) -> float:
        """Queue wait + execution: arrival to completion."""
        end = self.finished_mono or time.monotonic()
        return end - self.enqueued_mono

    def to_dict(self) -> dict:
        now = time.monotonic()
        with self._mu:
            kv = self._ledger.by_source.get("kv", {})
            hits = kv.get("hit", 0)
            consults = sum(kv.values())
            out = {
                "id": self.seq,
                "tenant": self.tenant,
                "state": self.state,
                "command": self.command,
                "tag": self.tag,
                "trace_id": self.trace_id,
                "phase": self.phase,
                "queue_wait_seconds": round(
                    self.queue_wait_seconds
                    if self.started_mono is not None
                    else now - self.enqueued_mono, 3),
                "age_seconds": round(
                    (self.finished_mono or now) - self.enqueued_mono, 3),
                # Seconds since the build's own event stream last moved:
                # the per-build progress clock.
                "progress_age_seconds": round(
                    (self.finished_mono or now)
                    - self._last_event_mono, 3),
                "cache": {
                    "kv_hits": hits,
                    "kv_consults": consults,
                    "kv_hit_ratio": round(hits / consults, 4)
                    if consults else 0.0,
                    "bytes_added": self._ledger.bytes_added,
                    "bytes_reused": self._ledger.bytes_reused,
                    "dedup_ratio": round(self._ledger.dedup_ratio(), 4),
                },
            }
            if self.exit_code is not None:
                out["exit_code"] = self.exit_code
            if self.finished_mono is not None \
                    and self.started_mono is not None:
                out["elapsed_seconds"] = round(
                    self.finished_mono - self.started_mono, 3)
            return out


def _read_body(handler) -> bytes:
    return handler.rfile.read(int(handler.headers.get("Content-Length",
                                                      "0")))


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args) -> None:  # quiet
        pass

    def do_GET(self) -> None:
        from urllib.parse import parse_qs, urlsplit
        if self.path == "/ready":
            self._respond(200, b"ok")
        elif self.path == "/metrics":
            # Process-wide totals across every build this worker served.
            from makisu_tpu_torch.utils import metrics
            self._respond(200, metrics.render_prometheus().encode(),
                          content_type=_METRICS_CONTENT_TYPE)
        elif self.path == "/healthz":
            self._json(self.server.health())
        elif self.path == "/builds":
            self._json(self.server.builds())
        elif self.path == "/sessions":
            # This server's own manager: its residency, not a sibling's.
            self._json(self.server.session_mgr.stats())
        elif self.path.startswith("/sessions/snapshot"):
            query = parse_qs(urlsplit(self.path).query)
            context = (query.get("context") or [""])[0]
            if not context:
                self._respond(400, b"context query param required")
                return
            recipe = self.server.find_session_snapshot(context)
            if recipe is None:
                self._respond(404, b"no snapshot for context")
                return
            self._json(recipe)
        elif self.path == "/alerts":
            self._json(self.server.alerts())
        elif self.path == "/profile" or self.path.startswith("/profile?"):
            # Samples for ?seconds=N on this handler thread only.
            query = parse_qs(urlsplit(self.path).query)
            try:
                seconds = float((query.get("seconds") or ["5"])[0])
            except ValueError:
                self._respond(400, b"bad seconds")
                return
            self._json(self.server.profile(seconds))
        elif self.path.startswith("/chunks/"):
            # Peer chunk exchange, serving side: chunk bytes out of the
            # local CAS(es), never a proxied fetch; the fallback of peers
            # that find no recipe here.
            self._serve_chunk(self.path[len("/chunks/"):])
        elif self.path.startswith(("/recipes/", "/packs/", "/zpacks/")):
            # The distribution plane, embedded: recipes, raw pack spans
            # and their seekable-zstd twins, for the storages this
            # server's builds used only.
            from makisu_tpu_torch.serve import server as serve_server
            kind, _, name = self.path[1:].partition("/")
            handler = {"recipes": serve_server.handle_recipe,
                       "packs": serve_server.handle_pack,
                       "zpacks": serve_server.handle_zpack}[kind]
            handler(self, name, roots=self.server.served_chunk_roots(),
                    access=self.server.serve_access)
        elif self.path == "/storage" or self.path.startswith("/storage?"):
            # The full storage document ``doctor --storage SOCKET``
            # renders; /healthz carries the cached digest.
            query = parse_qs(urlsplit(self.path).query)
            budget = None
            raw = (query.get("eviction_budget") or [None])[0]
            if raw is not None:
                try:
                    budget = int(raw)
                except ValueError:
                    self._respond(400, b"bad eviction_budget")
                    return
            self._respond(
                200,
                json.dumps(self.server.storage_report(
                    eviction_budget=budget), default=str).encode(),
                content_type="application/json")
        elif self.path == "/serve/access":
            # Every peer or delta fetch this worker answered, with the
            # requesting build's trace id.
            self._json({"entries": self.server.serve_access.snapshot()})
        elif self.path == "/peers":
            from makisu_tpu_torch.fleet import peers as fleet_peers
            self._json({"version": fleet_peers.map_version(),
                        "peers": list(fleet_peers.peers())})
        elif self.path == "/exit":
            # Shut down whether or not the response lands (clients may
            # hang up as soon as the status line arrives).
            threading.Thread(target=self.server.shutdown,
                             daemon=True).start()
            self._respond(200, b"bye")
        else:
            self._respond(404, b"not found")

    def _serve_chunk(self, name: str) -> None:
        """``GET /chunks/<fingerprint>``: one chunk's bytes. The name is
        checked as a full lowercase-hex sha256 before it reaches any path
        machinery: the CAS's keys are file names."""
        from makisu_tpu_torch.cache import chunks as chunks_mod
        from makisu_tpu_torch.serve import server as serve_server
        from makisu_tpu_torch.serve.recipe import is_hex_digest
        from makisu_tpu_torch.utils import metrics
        if not is_hex_digest(name):
            self._respond(400, b"bad chunk fingerprint")
            return
        access = self.server.serve_access
        g = metrics.global_registry()
        fh = chunks_mod.open_served_chunk(
            name, roots=self.server.served_chunk_roots())
        if fh is None:
            g.counter_add(metrics.FLEET_CHUNK_SERVES, result="miss")
            access.record("chunk", name, 404, 0,
                          serve_server.inbound_trace_id(self))
            self._respond(404, b"chunk not held here")
            return
        try:
            with fh:
                data = fh.read()
        except OSError:
            # Evicted between the open and the read: a miss.
            self._respond(404, b"chunk not held here")
            return
        g.counter_add(metrics.FLEET_CHUNK_SERVES, result="hit")
        g.counter_add(metrics.FLEET_CHUNK_SERVE_BYTES, len(data))
        access.record("chunk", name, 200, len(data),
                      serve_server.inbound_trace_id(self))
        self._respond(200, data, content_type="application/octet-stream")

    def _context_body(self) -> str | None:
        """``{"context": PATH}`` (or no body) -> PATH ("" for all);
        None after answering 400 to a malformed body."""
        raw = _read_body(self)
        if not raw:
            return ""
        try:
            return str((json.loads(raw) or {}).get("context", ""))
        except (ValueError, AttributeError):
            self._respond(400, b"bad json body")
            return None

    def do_POST(self) -> None:
        if self.path == "/peers":
            # The peer map, {"peers": [SOCKET, ...], "version": N}: this
            # worker's builds ask those sockets for missing chunks before
            # the registry. A version older than the one held is not
            # applied ({"applied": false} and the version held).
            from makisu_tpu_torch.fleet import peers as fleet_peers
            try:
                body = json.loads(_read_body(self)) or {}
                peer_list = list(body.get("peers") or [])
                version = body.get("version")
                version = int(version) if version is not None else None
            except (ValueError, TypeError, AttributeError):
                self._respond(400, b"bad peers json")
                return
            applied = fleet_peers.set_peers(peer_list, version)
            self._json({"applied": applied,
                        "version": fleet_peers.map_version()})
            return
        if self.path == "/sessions/invalidate":
            # {"context": PATH} drops that context's session, {} every
            # idle one; busy sessions stay (their build owns them).
            context = self._context_body()
            if context is not None:
                self._json({"invalidated":
                            self.server.session_mgr.invalidate(context)})
            return
        if self.path == "/sessions/snapshot":
            # Checkpoint resident sessions into the snapshot plane now.
            context = self._context_body()
            if context is not None:
                self._json({"snapshotted":
                            self.server.session_mgr.snapshot_all(context)})
            return
        if self.path == "/sessions/restore":
            # Stage a snapshot on this worker so the next build of the
            # context restores warm: {"recipe": {...}} or {"context":
            # PATH}. Refusals are data ({"ok": false, "reason"}).
            try:
                body = json.loads(_read_body(self)) or {}
                if not isinstance(body, dict):
                    raise ValueError("body must be an object")
            except (ValueError, AttributeError):
                self._respond(400, b"bad json body")
                return
            ok, reason = self.server.stage_session_snapshot(body)
            self._json({"ok": ok, "reason": reason})
            return
        if self.path != "/build":
            self._respond(404, b"not found")
            return
        try:
            body = json.loads(_read_body(self))
        except ValueError:
            self._respond(400, b"bad argv json")
            return
        # Two body shapes: the bare argv list, and {"argv": [...],
        # "tenant": "..."}. The header wins when both name a tenant.
        tenant = ""
        traceparent = ""
        fleet_info = None
        if isinstance(body, dict):
            argv = body.get("argv") or []
            tenant = str(body.get("tenant") or "")
            traceparent = str(body.get("traceparent") or "")
            if isinstance(body.get("fleet"), dict):
                fleet_info = body["fleet"]
        else:
            argv = body
        tenant = self.headers.get("X-Makisu-Tenant") or tenant
        traceparent = self.headers.get("traceparent") or traceparent
        if not isinstance(argv, list) or not all(
                isinstance(a, str) for a in argv):
            self._respond(400, b"bad argv json")
            return
        # Cooperative admission refusal: with X-Makisu-No-Wait a
        # saturated worker answers 503 now instead of queueing.
        if (self.headers.get("X-Makisu-No-Wait")
                and self.server._admission.would_block()):
            self._json({
                "error": "admission_refused",
                "queue_depth": self.server._admission.depth(),
                "max_concurrent_builds":
                    self.server.max_concurrent_builds,
            }, status=503)
            return
        self.send_response(200)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        # The build's threads emit concurrently, so chunk framing is
        # atomic; once the terminal chunk is written, late frames (a
        # push thread outliving the build) are dropped.
        emit_lock = threading.Lock()
        finished = threading.Event()

        def emit(line: str) -> None:
            data = (line.rstrip("\n") + "\n").encode()
            frame = f"{len(data):x}\r\n".encode() + data + b"\r\n"
            with emit_lock:
                if finished.is_set():
                    return
                self.wfile.write(frame)

        start = time.monotonic()
        record = self.server.register_build(argv, tenant)
        code = self.server.run_build(argv, emit, record,
                                     traceparent=traceparent,
                                     fleet_info=fleet_info)
        # The terminal line carries the outcome as data ("build_code",
        # stringly, kept for older clients).
        emit(json.dumps({
            "build_code": str(code),
            "exit_code": code,
            "elapsed_seconds": round(time.monotonic() - start, 3),
            "queue_wait_seconds": round(record.queue_wait_seconds, 3),
            "tenant": tenant,
        }))
        with emit_lock:
            finished.set()
            self.wfile.write(b"0\r\n\r\n")

    def _json(self, doc, status: int = 200) -> None:
        self._respond(status, json.dumps(doc).encode(),
                      content_type="application/json")

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
            pass  # the client hung up


def _effective_flags(argv: list[str]) -> dict:
    """The flags the worker cares about, resolved through the real CLI
    parser (argparse's equals form, abbreviations and defaults)."""
    from makisu_tpu_torch import cli
    out = {"root": None, "storage": None, "log_level": "info"}
    try:
        args, _ = cli.make_parser().parse_known_args(argv)
    except SystemExit:
        return out  # malformed argv: cli.main reports the error
    out["log_level"] = getattr(args, "log_level", "info")
    root = getattr(args, "root", None)
    if root is not None:
        out["root"] = root
    storage = getattr(args, "storage", None)
    if storage is not None:
        # "" is the default storage dir; resolved so an explicit
        # --storage of the same path shares the lock.
        out["storage"] = cli._storage_dir(storage)
    return out


def _warm_probe_wanted(device) -> bool:
    """MAKISU_TPU_WORKER_WARM_PROBE=1/0 forces the startup probe on or
    off; by default a worker on the card probes."""
    forced = os.environ.get("MAKISU_TPU_WORKER_WARM_PROBE")
    if forced is not None:
        return forced == "1"
    return device is None or str(device).startswith("cuda")


# Shared-path serialisation across every WorkerServer in the process.
_PATH_LOCKS: dict[str, threading.Lock] = {}
_PATH_LOCKS_MU = threading.Lock()


class WorkerServer(socketserver.ThreadingMixIn,
                   socketserver.UnixStreamServer):
    allow_reuse_address = True
    daemon_threads = True
    # The listen backlog: a wave of build jobs connects at once (64 in
    # BASELINE.md config 5). socketserver's default of 5 refuses the
    # rest of such a wave with EAGAIN on a unix socket.
    request_queue_size = 128

    def __init__(self, socket_path: str,
                 stall_window: float | None = None,
                 diag_out: str = "",
                 max_concurrent_builds: int = 0,
                 slo_config: str = "",
                 alert_webhook: str = "",
                 slo_interval: float | None = None,
                 device=None) -> None:
        # A worker on the card needs CUDA to start; its probe then runs
        # in the background, so a wedged card still answers /healthz.
        self.device = device
        if _warm_probe_wanted(device):
            from makisu_tpu_torch.ops import backend
            backend.warm_probe(source="worker",
                               device=backend.resolve_device(device))
        if os.path.exists(socket_path):
            os.unlink(socket_path)
        super().__init__(socket_path, _Handler)
        self.socket_path = socket_path
        # /healthz vital signs under one lock.
        self._started_mono = time.monotonic()
        self._health_mu = threading.Lock()
        self._builds_started = 0
        self._builds_succeeded = 0
        self._builds_failed = 0
        # Admission: cap concurrently executing builds, FIFO beyond it;
        # 0 = unlimited (env MAKISU_TPU_MAX_CONCURRENT_BUILDS).
        if max_concurrent_builds <= 0:
            try:
                max_concurrent_builds = int(os.environ.get(
                    "MAKISU_TPU_MAX_CONCURRENT_BUILDS", "0") or 0)
            except ValueError:
                max_concurrent_builds = 0
        self.max_concurrent_builds = max_concurrent_builds
        self._admission = _AdmissionQueue(max_concurrent_builds)
        # GET /builds: a record per accepted build, in flight until it
        # finishes, then in the bounded recent ring.
        self._builds_mu = threading.Lock()
        self._build_seq = 0
        self._inflight: dict[int, _BuildRecord] = {}
        self._recent: collections.deque[_BuildRecord] = \
            collections.deque(maxlen=_RECENT_BUILDS_KEEP)
        self._queue_wait_ring = _QuantileRing()
        self._latency_ring = _QuantileRing()
        self._tenant_latency: dict[str, _QuantileRing] = {}
        # Builds from every connection share this process, so their ring
        # passes share the hash service's S1 launches.
        os.environ["MAKISU_TPU_SHARED_HASH"] = "1"
        # Each server owns its session manager (bound per build), so its
        # sessions and /sessions describe this worker only.
        from makisu_tpu_torch.worker import session as session_mod
        self.session_mgr = session_mod.SessionManager()
        # Storage dirs this server's builds used (the snapshot endpoints
        # look for recipes there; the census, the scrub and the budget
        # evictor walk them), a TTL census cache per dir, and the
        # background scrub thread, armed by the first dir.
        self._storage_mu = threading.Lock()
        self._storage_dirs: set[str] = set()
        self._storage_state: dict[str, dict] = {}
        self._scrub_thread: threading.Thread | None = None
        self._scrub_stop = threading.Event()
        # A worker serves: its builds publish layer recipes at index time
        # (MAKISU_TPU_SERVE=0 still wins), so its /recipes and /packs
        # answer peers and delta pullers; the access ring is this
        # server's own, never an in-process sibling's.
        from makisu_tpu_torch.serve import server as serve_server
        serve_server.enable_publishing()
        self.serve_access = serve_server.AccessLog()
        # Chunk CAS roots this server's builds used: the serving routes
        # answer for these only (the process-wide registries also hold
        # in-process siblings' stores, whose bytes would fake the
        # cross-host exchange).
        self._served_chunk_roots: set[str] = set()
        # Builds sharing a --root or --storage directory serialise on a
        # process-wide lock per path.
        self._path_locks = _PATH_LOCKS
        self._path_locks_mu = _PATH_LOCKS_MU
        # Failure forensics: a process flight recorder sees every build's
        # events (a global sink), the resource sampler runs, and an
        # optional stall watchdog dumps a bundle when in-flight builds
        # stop making progress.
        from makisu_tpu_torch.utils import events, flightrecorder, metrics
        from makisu_tpu_torch.utils import resources
        resources.ensure_started()
        self.recorder = flightrecorder.FlightRecorder()
        self._recorder_sink = self.recorder.record_event
        events.add_global_sink(self._recorder_sink)
        self._watchdog = None
        if stall_window is None:
            stall_window = flightrecorder.stall_timeout_from_env()
        if stall_window > 0:
            self._watchdog = flightrecorder.StallWatchdog(
                stall_window, self.recorder,
                flightrecorder.forced_bundle_path(diag_out, "stall"),
                # The process registry: this thread's context may carry
                # the worker command's own registry.
                registry=metrics.global_registry(),
                active_fn=lambda: self._active_builds() > 0).start()
        # SLO plane: a rule evaluator over this worker's vitals; alerts
        # ride the event bus and GET /alerts.
        from makisu_tpu_torch.fleet import slo as slo_mod
        rules = slo_mod.default_worker_rules()
        if slo_config:
            rules = slo_mod.load_rules(slo_config, rules)
        self.slo = slo_mod.SloEvaluator(
            self._slo_probe, rules, interval=slo_interval,
            webhook=alert_webhook, source="worker")
        self.slo.start()
        # Continuous profiling: one process sampler for the worker's
        # lifetime (MAKISU_TPU_PROFILE_HZ; 0 = off), owned by the first
        # server that starts it.
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
        # A firing page-severity alert writes a profile beside the
        # bundles.
        self.slo.manager.on_fire = self._profile_on_page

    # UnixStreamServer's client_address is a path; BaseHTTPRequestHandler
    # wants a (host, port) tuple for logging.
    def get_request(self):
        request, _ = super().get_request()
        return request, ("worker", 0)

    def handle_error(self, request, client_address) -> None:
        # A poller dropping its keep-alive connection is normal churn.
        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError)):
            return
        super().handle_error(request, client_address)

    def _add_storage_dir(self, storage_dir: str) -> None:
        with self._storage_mu:
            self._storage_dirs.add(os.path.realpath(storage_dir))
            if self._scrub_thread is None:
                interval = _scrub_interval_seconds()
                if interval > 0:
                    # A process-level maintenance thread: it outlives
                    # any one build and binds no build's sinks.
                    self._scrub_thread = threading.Thread(
                        target=self._scrub_loop, args=(interval,),
                        daemon=True, name="storage-scrub")
                    self._scrub_thread.start()

    def storage_dirs(self) -> list[str]:
        with self._storage_mu:
            return sorted(self._storage_dirs)

    def add_served_chunk_root(self, storage_dir: str) -> None:
        """Serve a storage's chunk CAS, recipes and packs from this
        worker (``run_build`` adds every build's storage; tests may add
        one directly: the storage dir holding ``chunks/``, or that
        ``chunks/`` dir itself). A ``chunks``-named dir registers its
        parent's serve store unless it holds a ``serve/`` of its own:
        the publisher writes recipes at ``<storage>/serve``, and a store
        rooted at the CAS dir would 404 every recipe and leave peers to
        the per-chunk route."""
        from makisu_tpu_torch.serve import server as serve_server
        root = os.path.realpath(storage_dir)
        chunk_root = os.path.realpath(os.path.join(storage_dir, "chunks"))
        storage = root
        if os.path.basename(root) == "chunks" \
                and not os.path.isdir(os.path.join(root, "serve")):
            storage = os.path.dirname(root)
        serve_server.register_store(storage)
        with self._builds_mu:
            self._served_chunk_roots.update((root, chunk_root))
        self._add_storage_dir(storage)

    def served_chunk_roots(self) -> set[str]:
        with self._builds_mu:
            return set(self._served_chunk_roots)

    # -- storage governance (census, audit, scrub, budget) ----------------

    def _census_for(self, storage_dir: str,
                    max_age: float | None = None) -> dict:
        """This dir's census through the TTL cache: /healthz polls come
        every few seconds and must not each pay for a walk."""
        from makisu_tpu_torch.cache import census as census_mod
        if max_age is None:
            max_age = _census_ttl_seconds()
        now = time.monotonic()
        with self._storage_mu:
            state = self._storage_state.setdefault(storage_dir, {})
            doc = state.get("census")
            if doc is not None \
                    and now - state.get("census_mono", 0.0) < max_age:
                return doc
        doc = census_mod.StorageCensus(storage_dir).census()
        with self._storage_mu:
            state = self._storage_state.setdefault(storage_dir, {})
            state["census"] = doc
            state["census_mono"] = time.monotonic()
        return doc

    def storage_health(self) -> dict:
        """The /healthz ``storage`` digest: per-plane totals summed over
        this worker's storage dirs, the chunk CAS LRU seed state (the
        worst dir wins), the content store's budget digest, and the
        latest audit and scrub finding counts."""
        from makisu_tpu_torch.cache import census as census_mod
        from makisu_tpu_torch.storage import contentstore
        dirs = self.storage_dirs()
        planes: dict[str, dict] = {}
        total_bytes = 0
        total_objects = 0
        seed = {"state": "seeded", "seeded_entries": 0}
        seed_rank = {"unseeded": 0, "seeding": 1, "seeded": 2}
        finding_kinds: dict[str, int] = {}
        for storage_dir in dirs:
            try:
                doc = self._census_for(storage_dir)
            except OSError:
                continue
            total_bytes += int(doc.get("total_bytes", 0) or 0)
            total_objects += int(doc.get("total_objects", 0) or 0)
            for plane, row in (doc.get("planes") or {}).items():
                agg = planes.setdefault(plane, {"objects": 0, "bytes": 0})
                agg["objects"] += int(row.get("objects", 0) or 0)
                agg["bytes"] += int(row.get("bytes", 0) or 0)
            state = census_mod.seed_states(storage_dir)
            if state:
                if seed_rank.get(state.get("state"), 0) \
                        < seed_rank.get(seed["state"], 2):
                    seed["state"] = state.get("state", "unseeded")
                seed["seeded_entries"] += int(
                    state.get("seeded_entries", 0) or 0)
            with self._storage_mu:
                cached = self._storage_state.get(storage_dir, {})
                for f in (cached.get("findings") or []):
                    kind = str(f.get("kind", "?"))
                    finding_kinds[kind] = finding_kinds.get(kind, 0) + 1
        # The budget digest: budget, hot-tier occupancy and their ratio
        # ("pressure"; 0.0 when unbudgeted).
        budget_total = 0
        hot_total = 0
        for storage_dir in dirs:
            try:
                store = contentstore.store_for(storage_dir)
                budget_total += store.budget_bytes
                hot_total += store.tier_bytes(publish=False)["hot"]
            except OSError:
                continue
        counters = contentstore.counters()
        return {
            "dirs": len(dirs),
            "planes": planes,
            "total_bytes": total_bytes,
            "total_objects": total_objects,
            "lru_seed": seed,
            "budget": {
                "budget_bytes": budget_total,
                "hot_bytes": hot_total,
                "pressure": (round(hot_total / budget_total, 4)
                             if budget_total > 0 else 0.0),
                "evictions_total": counters["evictions"],
                "evicted_bytes": counters["evicted_bytes"],
                "refetch_bytes": counters["refetch_bytes"],
            },
            "findings": {
                "total": sum(finding_kinds.values()),
                "kinds": dict(sorted(finding_kinds.items())),
            },
        }

    def storage_report(self, eviction_budget: int | None = None) -> dict:
        """The ``GET /storage`` payload: a fresh census and reference
        audit (and the eviction dry run, when a budget is asked for) per
        storage dir, the content store's description and the latest
        scrub cycle. The dry run reads the live chunk CAS's seed state
        and refuses on partial recency data."""
        from makisu_tpu_torch.cache import census as census_mod
        from makisu_tpu_torch.storage import contentstore
        reports = []
        for storage_dir in self.storage_dirs():
            engine = census_mod.StorageCensus(storage_dir)
            doc = engine.census()
            audit = engine.audit()
            entry: dict = {"storage_dir": storage_dir,
                           "census": doc, "audit": audit}
            seed = census_mod.seed_states(storage_dir)
            if seed is not None:
                entry["lru_seed"] = seed
            if eviction_budget is not None:
                entry["eviction_dry_run"] = engine.eviction_dry_run(
                    eviction_budget, seed_state=seed)
            try:
                entry["contentstore"] = contentstore.store_for(
                    storage_dir).describe()
            except OSError:
                pass
            with self._storage_mu:
                state = self._storage_state.setdefault(storage_dir, {})
                state["census"] = doc
                state["census_mono"] = time.monotonic()
                state["findings"] = list(audit["findings"])
                entry["scrub"] = dict(state.get("scrub") or {})
            reports.append(entry)
        return {"storage": reports}

    def _scrub_loop(self, interval: float) -> None:
        """The background integrity scrub: a cycle per ``interval`` over
        every storage dir (``_scrub_once``)."""
        while not self._scrub_stop.wait(interval):
            for storage_dir in self.storage_dirs():
                self._scrub_once(storage_dir)

    def _scrub_once(self, storage_dir: str) -> None:
        """One scrub cycle of a storage dir: enforce its byte budget,
        refresh its census gauges, re-hash a few random chunks and one
        zpack frame under the IO budget, and park the findings where
        /healthz and /storage show them. A cycle that fails is logged
        and the next one runs.

        The budget pass runs only while no build holds the dir's path
        lock (builds on one storage dir serialise on it): a blob is no
        pin, and evicting one that a running build's cache hit is about
        to read fails that build. A build's own pass runs at its end."""
        from makisu_tpu_torch.cache import census as census_mod
        from makisu_tpu_torch.storage import contentstore
        from makisu_tpu_torch.utils import logging as log
        lock = self._path_lock(f"--storage={storage_dir}")
        try:
            if lock.acquire(blocking=False):
                try:
                    # An idle worker still converges to its budget (a
                    # no-op unbudgeted).
                    contentstore.store_for(storage_dir).maybe_evict()
                finally:
                    lock.release()
            engine = census_mod.StorageCensus(storage_dir)
            doc = engine.census()
            result = engine.scrub()
        except Exception as exc:  # noqa: BLE001 - host upkeep
            log.debug("storage scrub cycle failed for %s: %s",
                      storage_dir, exc)
            return
        with self._storage_mu:
            state = self._storage_state.setdefault(storage_dir, {})
            state["census"] = doc
            state["census_mono"] = time.monotonic()
            state["scrub"] = {
                "chunks_checked": result["chunks_checked"],
                "packs_checked": result["packs_checked"],
                "bytes_read": result["bytes_read"],
                "corrupt": len(result["findings"]),
            }
            if result["findings"]:
                state.setdefault("findings", [])
                state["findings"].extend(result["findings"])
                del state["findings"][:-_SCRUB_FINDINGS_KEEP]

    # -- session-snapshot plane (worker/snapshots.py) ----------------------

    def find_session_snapshot(self, context: str) -> dict | None:
        """The newest snapshot recipe of ``context`` across this worker's
        storage dirs, the resident session's own dir first."""
        from makisu_tpu_torch.worker import snapshots as snapshots_mod
        dirs: list[str] = []
        session_dir = self.session_mgr.storage_dir_for(context)
        if session_dir:
            dirs.append(session_dir)
        dirs.extend(d for d in self.storage_dirs() if d not in dirs)
        for storage_dir in dirs:
            recipe = snapshots_mod.SnapshotStore(
                storage_dir).load_for_context(context)
            if recipe is not None:
                return recipe
        return None

    def stage_session_snapshot(self, body: dict) -> tuple[bool, str]:
        """POST /sessions/restore: land a recipe on this worker's storage
        so the next build's ``SessionManager.acquire`` restores warm.
        Refusals count into the manager's snapshot tallies."""
        from makisu_tpu_torch.worker import snapshots as snapshots_mod
        recipe = body.get("recipe")
        context = str(body.get("context", ""))
        storage = str(body.get("storage", ""))
        if recipe is None and context:
            recipe = self.find_session_snapshot(context)
            if recipe is None:
                return False, "no_snapshot"
        if not isinstance(recipe, dict):
            return False, "no_recipe"
        context = str(recipe.get("context", "")) or context
        if not storage:
            dirs = self.storage_dirs()
            if len(dirs) == 1:
                storage = dirs[0]
            elif not dirs:
                return False, "no_storage"
            else:
                storage = self.session_mgr.storage_dir_for(context) \
                    or dirs[0]
        try:
            ok, reason = snapshots_mod.SnapshotStore(storage).stage(recipe)
        except Exception as e:  # noqa: BLE001 - answered and counted
            ok, reason = False, f"error:{type(e).__name__}"
        if not ok:
            self.session_mgr.note_snapshot("restore_refused",
                                           context=context, reason=reason)
        return ok, reason

    # -- builds ------------------------------------------------------------

    def register_build(self, argv: list[str],
                       tenant: str = "") -> _BuildRecord:
        """This build's ``/builds`` record (state queued), made before
        admission so a waiting build shows with a growing queue wait."""
        with self._builds_mu:
            self._build_seq += 1
            record = _BuildRecord(self._build_seq, tenant, argv)
            self._inflight[record.seq] = record
        return record

    def _retire_build(self, record: _BuildRecord, code: int) -> None:
        record.finish(code)
        latency = record.latency_seconds()
        self._queue_wait_ring.add(record.queue_wait_seconds)
        self._latency_ring.add(latency)
        with self._builds_mu:
            self._inflight.pop(record.seq, None)
            self._recent.append(record)
            tenant = record.tenant
            if (tenant not in self._tenant_latency
                    and len(self._tenant_latency) >= _TENANT_LABELS_KEEP):
                tenant = _TENANT_OVERFLOW
            ring = self._tenant_latency.setdefault(tenant, _QuantileRing())
        ring.add(latency)
        from makisu_tpu_torch.utils import metrics
        g = metrics.global_registry()
        g.observe("makisu_build_queue_wait_seconds",
                  record.queue_wait_seconds, buckets=_LATENCY_BUCKETS,
                  tenant=tenant)
        g.observe("makisu_build_latency_seconds", latency,
                  buckets=_LATENCY_BUCKETS, tenant=tenant)

    def builds(self) -> dict:
        """The ``GET /builds`` payload."""
        with self._builds_mu:
            inflight = sorted(self._inflight.values(), key=lambda r: r.seq)
            recent = list(self._recent)
        return {
            "queue_depth": self._admission.depth(),
            "max_concurrent_builds": self.max_concurrent_builds,
            "inflight": [r.to_dict() for r in inflight],
            "recent": [r.to_dict() for r in reversed(recent)],
        }

    def run_build(self, argv: list[str], emit,
                  record: _BuildRecord | None = None,
                  traceparent: str = "",
                  fleet_info: dict | None = None) -> int:
        """Run one command in this process on ``self.device``, forwarding
        its log lines and build events to ``emit``.

        The log and event sinks bind to this request's context (and the
        threads the build spawns), so concurrent builds' streams stay
        apart. Admission happens here: past ``max_concurrent_builds``
        executing builds, the request waits its FIFO turn, and the wait
        lands on ``record``. ``fleet_info`` (the front door's routing
        outcome) is bound for the build's history record."""
        from makisu_tpu_torch import cli
        from makisu_tpu_torch.utils import events, metrics
        from makisu_tpu_torch.utils import logging as log
        from makisu_tpu_torch.worker import session as session_mod

        def sink(level: str, msg: str, fields: dict) -> None:
            try:
                emit(json.dumps({"level": level, "msg": msg}))
            except OSError:
                pass  # the client went away; keep building

        def event_sink(event: dict) -> None:
            try:
                emit(json.dumps({"event": event}, default=str))
            except OSError:
                pass  # the client went away; keep building

        if record is None:  # direct callers (tests) skip do_POST
            record = self.register_build(argv)
        queue_wait = self._admission.acquire()
        record.start_running(queue_wait)
        # The inbound trace context, for cli.main to adopt; parsed here
        # too so the queue-wait event carries the right ids.
        trace_token = metrics.bind_inbound_traceparent(traceparent)
        parsed_tp = (metrics.parse_traceparent(traceparent)
                     if traceparent else None)
        # Fleet provenance: the routing outcome the front door sent
        # rides into the build's history record (utils/history.py reads
        # the contextvar at append time).
        from makisu_tpu_torch.utils import history as history_mod
        fleet_token = None
        if fleet_info is not None:
            try:
                provenance = {
                    # The scheduler's worker id when one was sent (how
                    # every fleet surface names workers), else the
                    # socket path.
                    "worker": str(fleet_info.get("worker", "")
                                  or self.socket_path),
                    "verdict": str(fleet_info.get("verdict", "")),
                    "attempts": int(fleet_info.get("attempts", 1) or 1),
                    "quota_wait_seconds": float(
                        fleet_info.get("quota_wait_seconds", 0.0)
                        or 0.0),
                }
            except (TypeError, ValueError):
                # A junk "fleet" object degrades to bare provenance,
                # never a failed build.
                provenance = {"worker": self.socket_path}
            fleet_token = history_mod.bind_fleet_provenance(provenance)
        # The sink honours this build's own --log-level.
        flags = _effective_flags(argv)
        level = flags["log_level"]
        if flags["storage"]:
            # This build's chunk CAS, recipes and packs become servable.
            self.add_served_chunk_root(flags["storage"])
        token = log.set_build_sink(sink, level.replace("warn", "warning"))
        events_token = events.add_sink(event_sink)
        record_token = events.add_sink(record.note_event)
        mode_token = cli.invocation_mode.set("worker")
        session_token = session_mod.bind_manager(self.session_mgr)
        # The build's peer fetches skip this server's own socket
        # (context-scoped, so the threads the build spawns inherit it).
        from makisu_tpu_torch.fleet import peers as fleet_peers
        peers_token = fleet_peers.bind_self_socket(self.socket_path)
        # The admission wait, emitted now that the sinks are bound.
        events.emit("queue_wait", seconds=round(queue_wait, 6),
                    tenant=record.tenant or "",
                    **({"trace_id": parsed_tp[0],
                        "parent_id": parsed_tp[1]}
                       if parsed_tp else {}))
        # Counted as started before the path locks: a build waiting on
        # another's --root or --storage shows as active.
        with self._health_mu:
            self._builds_started += 1
            metrics.global_registry().gauge_set(
                "makisu_worker_active_builds",
                self._builds_started - self._builds_succeeded
                - self._builds_failed)
        locks = self._shared_path_locks(argv)
        for lock in locks:
            lock.acquire()
        code = 1
        try:
            code = cli.main(argv, device=self.device)
            return code
        except SystemExit as e:
            # argparse exits with an int; a reader exits with a message
            # (status 1, the message to the client).
            if e.code is None or isinstance(e.code, int):
                code = e.code or 0
            else:
                emit(json.dumps({"level": "error", "msg": str(e.code)}))
                code = 1
            return code
        except Exception as e:  # noqa: BLE001 - the worker outlives a build
            emit(json.dumps({"level": "error", "msg": str(e)}))
            return 1
        finally:
            metrics.counter_add("makisu_worker_builds_total",
                                result="ok" if code == 0 else "error")
            with self._health_mu:
                if code == 0:
                    self._builds_succeeded += 1
                else:
                    self._builds_failed += 1
                metrics.global_registry().gauge_set(
                    "makisu_worker_active_builds",
                    self._builds_started - self._builds_succeeded
                    - self._builds_failed)
            for lock in reversed(locks):
                lock.release()
            self._admission.release()
            self._retire_build(record, code)
            if flags["storage"] and record.tenant:
                # The ledger joins the census: this build's layer hexes
                # are attributed to its tenant.
                from makisu_tpu_torch.cache import census as census_mod
                census_mod.record_attribution(
                    flags["storage"], record.tenant, record.layer_hexes())
            if flags["storage"]:
                # The byte budget holds from build end, when new chunks
                # and blobs landed (throttled; never fails the build).
                from makisu_tpu_torch.storage import contentstore
                contentstore.store_for(flags["storage"]).maybe_evict()
            fleet_peers.reset_self_socket(peers_token)
            if fleet_token is not None:
                history_mod.reset_fleet_provenance(fleet_token)
            session_mod.reset_manager(session_token)
            metrics.reset_inbound_traceparent(trace_token)
            cli.invocation_mode.reset(mode_token)
            events.reset_sink(record_token)
            events.reset_sink(events_token)
            log.reset_build_sink(token)

    def _active_builds(self) -> int:
        with self._health_mu:
            return (self._builds_started - self._builds_succeeded
                    - self._builds_failed)

    def _device_health(self) -> dict:
        """The device plane's section, read only when something already
        imported it (a worker serving cpu-hasher builds never imports
        torch for a health probe). A module another thread is still
        importing (a first build loading torch while a poller asks) reads
        as absent: a health read must not fail on it."""
        ops_backend = sys.modules.get("makisu_tpu_torch.ops.backend")
        if (ops_backend is None
                or getattr(ops_backend.__spec__, "_initializing", False)
                or not hasattr(ops_backend, "device_health")):
            return {"probe": {"state": "absent", "sample_count": 0},
                    "dispatch_seconds": {}, "h2d_bytes": 0,
                    "padding_waste_bytes": 0}
        return ops_backend.device_health()

    def _slo_probe(self) -> dict:
        """The SLO evaluator's sample, from surfaces this server keeps:
        outcome counters for the burn-rate rules, ring and probe levels
        for the threshold rules."""
        from makisu_tpu_torch.utils import flightrecorder
        with self._health_mu:
            started = self._builds_started
            succeeded = self._builds_succeeded
            failed = self._builds_failed
        active = started - succeeded - failed
        latency = self._latency_ring.stats()
        wait = self._queue_wait_ring.stats()
        with self._builds_mu:
            tenant_rings = dict(self._tenant_latency)
        tenant_p99 = {t: float(ring.stats().get("p99", 0.0))
                      for t, ring in tenant_rings.items()}
        # Queue-wait share of the typical build (median over median).
        share = 0.0
        if latency.get("count") and latency.get("p50"):
            share = float(wait.get("p50", 0.0)) / float(latency["p50"])
        # The probe's verdict; a device plane that cannot even answer is
        # the page signal too.
        try:
            state = str(self._device_health().get("probe", {})
                        .get("state", ""))
        except Exception as exc:  # noqa: BLE001
            from makisu_tpu_torch.utils import logging as log
            log.debug("device health probe failed: %s", exc)
            state = "error"
        # Progress age counts only while builds are active.
        progress_age = (flightrecorder.last_progress_seconds()
                        if active > 0 else 0.0)
        storage_bytes = float(
            self.storage_health().get("total_bytes", 0) or 0)
        return {
            "counters": {
                "builds_started": float(started),
                "builds_failed": float(failed),
            },
            "levels": {
                "build_latency_p99": float(latency.get("p99", 0.0)),
                "tenant_latency_p99": tenant_p99,
                "queue_wait_share": round(share, 4),
                "queue_depth": float(self._admission.depth()),
                "progress_age": progress_age,
                "device_probe_bad": 1.0 if state in (
                    "wedged", "failed", "error") else 0.0,
                "storage_total_bytes": storage_bytes,
            },
        }

    def alerts(self) -> dict:
        """The ``GET /alerts`` payload: the alert ring plus the rule
        names this worker evaluates."""
        out = self.slo.manager.snapshot()
        out["source"] = "worker"
        out["rules"] = [r.name for r in self.slo.rules]
        return out

    def health(self) -> dict:
        """The ``GET /healthz`` payload: uptime, build outcome counts
        (active = started - finished), the admission queue, the cache's
        economics, the device plane, the sessions, the progress clock,
        the transfer engine's gauges, alerts and the profiler."""
        from makisu_tpu_torch.utils import flightrecorder, metrics
        with self._health_mu:
            started = self._builds_started
            succeeded = self._builds_succeeded
            failed = self._builds_failed
        g = metrics.global_registry()
        chunk_added = g.counter_total("makisu_chunk_bytes_total",
                                      result="added")
        chunk_reused = g.counter_total("makisu_chunk_bytes_total",
                                       result="reused")
        cache = {
            "hits": int(g.counter_total("makisu_cache_pull_total",
                                        result="hit")),
            "misses": int(g.counter_total("makisu_cache_pull_total",
                                          result="miss")),
            "miss_reasons": {
                reason: int(n) for reason, n in sorted(
                    g.counter_by_label("makisu_cache_miss_total",
                                       "reason").items())},
            "chunk_bytes_added": int(chunk_added),
            "chunk_bytes_reused": int(chunk_reused),
            "chunk_dedup_ratio": round(
                chunk_reused / (chunk_added + chunk_reused), 4)
                if (chunk_added + chunk_reused) else 0.0,
        }
        with self._builds_mu:
            tenant_rings = dict(self._tenant_latency)
        queue = {
            "depth": self._admission.depth(),
            "max_concurrent_builds": self.max_concurrent_builds,
            "wait_seconds": self._queue_wait_ring.stats(),
            "latency_seconds": self._latency_ring.stats(),
            "tenant_latency_seconds": {
                tenant: ring.stats()
                for tenant, ring in sorted(tenant_rings.items())},
        }
        session_stats = self.session_mgr.stats()
        sessions = {k: session_stats[k] for k in
                    ("count", "resident_bytes", "hits",
                     "invalidations", "max_sessions",
                     "max_resident_bytes")}
        sessions["snapshot"] = session_stats.get("snapshot", {})
        # What this worker can serve: the recipes and packs of its own
        # storages (the process-global request counters are on /metrics).
        from makisu_tpu_torch.fleet import peers as fleet_peers
        from makisu_tpu_torch.serve import server as serve_server
        serve = serve_server.serve_stats(roots=self.served_chunk_roots())
        return {
            "status": "ok",
            "uptime_seconds": round(
                time.monotonic() - self._started_mono, 3),
            "builds_started": started,
            "builds_succeeded": succeeded,
            "builds_failed": failed,
            "active_builds": started - succeeded - failed,
            "queue": queue,
            "cache": cache,
            "device": self._device_health(),
            "sessions": sessions,
            "serve": serve,
            # The storage planes: census totals (TTL-cached), the LRU
            # seed state, the budget digest and finding counts; the full
            # findings are on GET /storage.
            "storage": self.storage_health(),
            "last_progress_seconds": round(
                flightrecorder.last_progress_seconds(), 3),
            "transfer_inflight_bytes": int(g.gauge_value(
                "makisu_transfer_inflight_bytes")),
            "transfer_queue_depth": int(g.gauge_value(
                "makisu_transfer_queue_depth")),
            # The peer map version held: 0 after a restart tells whoever
            # publishes the map to publish it again.
            "peer_map_version": fleet_peers.map_version(),
            "alerts": self.slo.manager.digest(),
            "profiler": self.profiler_health(),
        }

    def profiler_health(self) -> dict:
        if self.profiler is None:
            return {"enabled": False, "hz": 0.0, "samples_total": 0,
                    "dropped": 0, "throttled": 0, "distinct_stacks": 0,
                    "overhead_fraction": 0.0}
        return self.profiler.stats()

    def profile(self, seconds: float) -> dict:
        """``GET /profile?seconds=N``: a window of the resident sampler,
        or of a sampler started for the window when profiling is off."""
        from makisu_tpu_torch.utils import profiler as profiler_mod
        seconds = min(max(float(seconds), 0.1), 30.0)
        if self.profiler is not None and self.profiler.enabled:
            return self.profiler.window(seconds, command="worker")
        temp = profiler_mod.SamplingProfiler().start()
        try:
            temp._stop.wait(seconds)
        finally:
            temp.stop()
        return temp.snapshot(command="worker")

    def _profile_on_page(self, payload: dict) -> None:
        """AlertManager ``on_fire`` hook: a page-severity alert writes the
        sampler's snapshot beside the bundles, named after its rule."""
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

    def server_close(self) -> None:
        from makisu_tpu_torch.utils import events
        from makisu_tpu_torch.utils import profiler as profiler_mod
        if self._profiler_owner and self.profiler is not None:
            self.profiler.stop()
            if profiler_mod.process_profiler() is self.profiler:
                profiler_mod.set_process_profiler(None)
        self.slo.stop()
        self._scrub_stop.set()
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        events.remove_global_sink(self._recorder_sink)
        # Inotify instances are a per-user budget (128 by default): a
        # closed worker gives its sessions' back at once.
        self.session_mgr.close()
        super().server_close()

    def _shared_path_locks(self, argv: list[str]) -> list:
        """Locks for this build's --root and --storage dirs (made on
        demand, taken in sorted order so overlapping sets cannot
        deadlock); both spellings of a flag resolve, and paths
        canonicalise through symlinks."""
        flags = _effective_flags(argv)
        paths = set()
        for name in ("root", "storage"):
            value = flags[name]
            key = (os.path.realpath(value) if value is not None
                   else "<none>")
            paths.add(f"--{name}={key}")
        return [self._path_lock(p) for p in sorted(paths)]

    def _path_lock(self, key: str) -> threading.Lock:
        with self._path_locks_mu:
            return self._path_locks.setdefault(key, threading.Lock())

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t
