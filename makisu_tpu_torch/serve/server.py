"""Serving side of the distribution plane.

Copy of ``makisu_tpu/serve/server.py``: the same routes, status codes,
headers and ``/healthz`` keys, so a client of either package reads a
server of the other.

Two deployment shapes, one handler set:

- **embedded**: every ``WorkerServer`` answers ``GET /recipes/<hex>``
  and ``GET /packs/<hex>`` out of the recipe stores registered for the
  storage roots its builds used (the same per-server honesty scoping as
  ``GET /chunks/<fp>``) — this is what the fleet peer plane rides.
- **standalone**: ``serve --storage DIR --socket S`` runs a
  :class:`ServeServer` — a read-only distribution endpoint over a
  storage directory a builder (or worker) populates, the CDN-edge
  shape.

Pack responses honor a single HTTP ``Range`` header (``bytes=a-b``,
inclusive-end like the RFC) with a 206 + ``Content-Range`` answer,
**streamed** through the transfer engine's :class:`MemoryBudget` in
1MiB pieces synthesized from the chunk CAS — a whole pack is never
materialized per request, so N concurrent pullers cost N stream
buffers, not N packs (the bounded-memory serving discipline of arxiv
2607.05596 applied server-side). An unparseable Range degrades to a
200 full-pack answer — the same semantics registries give
``pull_blob_range``, which clients already handle by carving what they
need.
"""

from __future__ import annotations

import collections
import json
import os
import socketserver
import threading
import time
from http.server import BaseHTTPRequestHandler

from makisu_tpu_torch.serve import recipe as recipe_mod
from makisu_tpu_torch.utils import events
from makisu_tpu_torch.utils import logging as log
from makisu_tpu_torch.utils import metrics

# Prometheus text exposition content type (format 0.0.4).
_METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


# -- process-wide serve-store registry ---------------------------------------

# RecipeStores keyed by realpath(storage dir), mirroring the chunk
# plane's serving registry: bounded by the number of distinct storage
# roots the process builds/serves against; re-registering replaces.
_stores: dict[str, recipe_mod.RecipeStore] = {}
_stores_mu = threading.Lock()

# Publishing switch: recipes are written at layer-index time, which
# costs one pass over the layer's novel chunk bytes — on by default
# only for processes that actually serve (workers, the `serve` command),
# or explicitly via MAKISU_TPU_SERVE=1. MAKISU_TPU_SERVE=0 wins
# everywhere.
_publishing = False


def enable_publishing() -> None:
    global _publishing
    _publishing = True


def publish_enabled() -> bool:
    flag = os.environ.get("MAKISU_TPU_SERVE", "")
    if flag == "0":
        return False
    return _publishing or flag == "1"


def register_store(storage_dir: str) -> recipe_mod.RecipeStore:
    """Idempotently create/fetch the RecipeStore for a storage dir
    (recipes+packs under ``<storage>/serve/``, chunk bytes from
    ``<storage>/chunks``)."""
    key = os.path.realpath(storage_dir)
    with _stores_mu:
        store = _stores.get(key)
        if store is None:
            store = recipe_mod.RecipeStore(
                os.path.join(storage_dir, "serve"),
                os.path.join(storage_dir, "chunks"))
            _stores[key] = store
        return store


def store_for(storage_dir: str) -> recipe_mod.RecipeStore | None:
    with _stores_mu:
        return _stores.get(os.path.realpath(storage_dir))


def stores(roots=None) -> list[recipe_mod.RecipeStore]:
    """Registered stores, optionally scoped to the given realpath'd
    storage/chunk roots (the worker's per-server honesty filter)."""
    with _stores_mu:
        items = list(_stores.items())
    if roots is None:
        return [store for _, store in items]
    return [store for key, store in items
            if key in roots or store.chunk_root in roots]


def reset_stores() -> None:
    """Drop the registry (tests)."""
    with _stores_mu:
        _stores.clear()


def serve_stats(roots=None) -> dict:
    """Aggregate digest for /healthz."""
    out = {"recipes": 0, "packs": 0, "pack_bytes": 0, "zpacks": 0}
    for store in stores(roots):
        stats = store.stats()
        for key in out:
            out[key] += stats[key]
    out["publish_enabled"] = publish_enabled()
    return out


# -- serve access ledger -----------------------------------------------------


class AccessLog:
    """Per-server ring of recent serve-plane requests — the
    cross-process half of a traced fetch. Every recipe/pack/zpack/
    chunk request lands here with the INBOUND trace id (the
    ``traceparent`` the fetching build sent), so a peer or delta fetch
    correlates with the build that issued it without grepping two
    machines' logs. Exposed as ``GET /serve/access``; each row also
    rides the event bus as a ``serve_access`` event (global sinks —
    the worker's flight recorder, a fleet's merged event log)."""

    def __init__(self, cap: int = 256) -> None:
        self._mu = threading.Lock()
        self._rows: collections.deque[dict] = collections.deque(
            maxlen=cap)

    def record(self, kind: str, name: str, status: int, nbytes: int,
               trace_id: str) -> None:
        row = {
            "ts": round(time.time(), 6),
            "kind": kind,
            "name": name,
            "status": int(status),
            "bytes": int(nbytes),
            "trace_id": trace_id or "",
        }
        with self._mu:
            self._rows.append(row)
        metrics.global_registry().counter_add(
            metrics.SERVE_ACCESS_TOTAL, kind=kind)
        # Delivered PRE-FORMED with the ledger row's own ts, so the
        # event and the /serve/access row are byte-equal — a fleet
        # that sees both (an in-process worker's direct emission AND
        # the shutdown collection of its ledger) dedups them by
        # identical fields in assemble_fleet_trace.
        events.deliver({**row, "type": "serve_access"})

    def snapshot(self) -> list[dict]:
        with self._mu:
            return list(self._rows)


def inbound_trace_id(handler) -> str:
    """The validated trace id of a request's ``traceparent`` header,
    or "" — never raises on a malformed header (a lying client costs
    correlation, not a request)."""
    parsed = metrics.parse_traceparent(
        handler.headers.get("traceparent") or "")
    return parsed[0] if parsed else ""


def _note_access(handler, access: "AccessLog | None", kind: str,
                 name: str, status: int, nbytes: int = 0) -> None:
    if access is not None:
        access.record(kind, name, status, nbytes,
                      inbound_trace_id(handler))


# -- request handling (shared by ServeServer and WorkerServer) ---------------


def parse_range(header: str | None, size: int):
    """A single ``bytes=a-b`` / ``bytes=a-`` range against ``size``.
    Returns ``(start, end)`` half-open, ``None`` for no/unparseable
    Range (serve the whole pack — the degradation clients already
    handle), or ``"unsatisfiable"`` for a well-formed range outside
    the pack."""
    if not header or not header.startswith("bytes="):
        return None
    spec = header[len("bytes="):]
    if "," in spec:
        return None  # multi-range: degrade to a full answer
    first, sep, last = spec.partition("-")
    if not sep or not first.isdigit() or (last and not last.isdigit()):
        return None
    start = int(first)
    end = int(last) + 1 if last else size
    if start >= size:
        return "unsatisfiable"
    if end <= start:
        return None  # inverted range: syntactically invalid, ignore
    return start, min(end, size)


def handle_recipe(handler, name: str, roots=None,
                  access: "AccessLog | None" = None) -> None:
    """``GET /recipes/<layer_hex>`` → the sealed recipe document."""
    g = metrics.global_registry()
    if not recipe_mod.is_hex_digest(name):
        _respond(handler, 400, b"bad layer digest")
        return
    for store in stores(roots):
        doc = store.recipe(name)
        if doc is not None:
            g.counter_add(metrics.SERVE_RECIPE_REQUESTS, result="hit")
            body = json.dumps(doc, separators=(",", ":")).encode()
            _note_access(handler, access, "recipe", name, 200,
                         len(body))
            _respond(handler, 200, body,
                     content_type="application/json")
            return
    g.counter_add(metrics.SERVE_RECIPE_REQUESTS, result="miss")
    _note_access(handler, access, "recipe", name, 404)
    _respond(handler, 404, b"no recipe for this layer")


def handle_pack(handler, name: str, roots=None,
                access: "AccessLog | None" = None) -> None:
    """``GET /packs/<pack_hex>`` with optional Range: stream the span,
    synthesized from chunks, through the transfer memory budget."""
    from makisu_tpu_torch.registry import transfer
    g = metrics.global_registry()
    if not recipe_mod.is_hex_digest(name):
        _respond(handler, 400, b"bad pack digest")
        return
    store = None
    for cand in stores(roots):
        if cand.pack_members(name) is not None:
            store = cand
            break
    if store is None:
        g.counter_add(metrics.SERVE_PACK_REQUESTS, kind="miss")
        _note_access(handler, access, "pack", name, 404)
        _respond(handler, 404, b"pack not held here")
        return
    size = store.pack_size(name)
    span = parse_range(handler.headers.get("Range"), size)
    if span == "unsatisfiable":
        g.counter_add(metrics.SERVE_PACK_REQUESTS, kind="bad_range")
        _note_access(handler, access, "pack", name, 416)
        _respond(handler, 416, b"range not satisfiable")
        return
    start, end = span if span is not None else (0, size)
    budget = transfer.engine().budget
    try:
        # Reserve one stream buffer, not the span: resident bytes per
        # in-flight response are a single piece.
        with budget.reserve(min(end - start, transfer.STREAM_RESERVE)):
            handler.send_response(206 if span is not None else 200)
            handler.send_header("Content-Type",
                                "application/octet-stream")
            handler.send_header("Content-Length", str(end - start))
            if span is not None:
                handler.send_header(
                    "Content-Range", f"bytes {start}-{end - 1}/{size}")
            handler.end_headers()
            sent = 0
            for piece in store.iter_pack_range(name, start, end):
                handler.wfile.write(piece)
                sent += len(piece)
        g.counter_add(metrics.SERVE_PACK_REQUESTS,
                      kind="range" if span is not None else "full")
        g.counter_add(metrics.SERVE_PACK_BYTES, sent)
        g.counter_add(metrics.SERVE_WIRE_BYTES, sent, encoding="raw")
        _note_access(handler, access, "pack", name,
                     206 if span is not None else 200, sent)
    except (FileNotFoundError, ValueError) as e:
        # Member chunk evicted (FileNotFoundError) or truncated on
        # disk (ValueError) after the headers went out: the body is
        # short of its Content-Length, so the connection MUST close —
        # a keep-alive client would otherwise block its full read
        # timeout waiting for the promised bytes. The close makes the
        # truncation immediate; the client's length check rejects it.
        handler.close_connection = True
        g.counter_add(metrics.SERVE_PACK_REQUESTS, kind="gone")
        log.warning("pack %s no longer fully backed by the chunk CAS "
                    "(%s)", name, e)
    except (BrokenPipeError, ConnectionResetError):
        pass  # client hung up mid-stream; not our problem


def handle_zpack(handler, name: str, roots=None,
                 access: "AccessLog | None" = None) -> None:
    """``GET /zpacks/<pack_hex>`` with optional Range: the pack's
    seekable-zstd twin — independently-decompressible frames, ranges
    over COMPRESSED bytes — streamed from the frame file under the
    transfer memory budget. 404 when the pack has no frames (pre-frame
    pack, libzstd-less publisher, unknown hex): the client's signal to
    keep the raw ``/packs`` wire, never a hard break."""
    from makisu_tpu_torch.registry import transfer
    g = metrics.global_registry()
    if not recipe_mod.is_hex_digest(name):
        _respond(handler, 400, b"bad pack digest")
        return
    store = frames = None
    for cand in stores(roots):
        frames = cand.pack_frames(name)
        if frames is not None:
            store = cand
            break
    if store is None:
        g.counter_add(metrics.SERVE_PACK_REQUESTS, kind="zmiss")
        _note_access(handler, access, "zpack", name, 404)
        _respond(handler, 404, b"no seekable pack held here")
        return
    size = store.zpack_size(name)
    span = parse_range(handler.headers.get("Range"), size)
    if span == "unsatisfiable":
        g.counter_add(metrics.SERVE_PACK_REQUESTS, kind="bad_range")
        _note_access(handler, access, "zpack", name, 416)
        _respond(handler, 416, b"range not satisfiable")
        return
    start, end = span if span is not None else (0, size)
    budget = transfer.engine().budget
    try:
        with budget.reserve(min(end - start, transfer.STREAM_RESERVE)):
            handler.send_response(206 if span is not None else 200)
            handler.send_header("Content-Type",
                                "application/zstd")
            handler.send_header("Content-Length", str(end - start))
            if span is not None:
                handler.send_header(
                    "Content-Range", f"bytes {start}-{end - 1}/{size}")
            handler.end_headers()
            sent = 0
            for piece in store.iter_zpack_range(name, start, end):
                handler.wfile.write(piece)
                sent += len(piece)
        served_frames = sum(1 for row in frames
                            if row[2] < end and row[2] + row[3] > start)
        g.counter_add(metrics.SERVE_PACK_REQUESTS,
                      kind="zrange" if span is not None else "zfull")
        g.counter_add(metrics.SERVE_PACK_FRAMES, served_frames)
        g.counter_add(metrics.SERVE_WIRE_BYTES, sent, encoding="zstd")
        _note_access(handler, access, "zpack", name,
                     206 if span is not None else 200, sent)
    except (FileNotFoundError, ValueError) as e:
        # Frame file gone/truncated after headers went out: close so
        # the short body is immediate (same discipline as handle_pack).
        handler.close_connection = True
        g.counter_add(metrics.SERVE_PACK_REQUESTS, kind="gone")
        log.warning("seekable pack %s no longer fully on disk (%s)",
                    name, e)
    except (BrokenPipeError, ConnectionResetError):
        pass  # client hung up mid-stream; not our problem


def _respond(handler, status: int, body: bytes,
             content_type: str | None = None) -> None:
    try:
        handler.send_response(status)
        if content_type:
            handler.send_header("Content-Type", content_type)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)
    except (BrokenPipeError, ConnectionResetError):
        pass


class _ServeHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args) -> None:  # quiet
        pass

    def do_GET(self) -> None:
        if self.path == "/ready":
            _respond(self, 200, b"ok")
        elif self.path.startswith("/recipes/"):
            handle_recipe(self, self.path[len("/recipes/"):],
                          access=self.server.serve_access)
        elif self.path.startswith("/packs/"):
            handle_pack(self, self.path[len("/packs/"):],
                        access=self.server.serve_access)
        elif self.path.startswith("/zpacks/"):
            handle_zpack(self, self.path[len("/zpacks/"):],
                         access=self.server.serve_access)
        elif self.path == "/serve/access":
            # The access ledger: recent serve-plane requests with the
            # inbound trace id of each — the server-side rows a merged
            # fleet trace (and a curious operator) correlates against.
            _respond(self, 200, json.dumps({
                "entries": self.server.serve_access.snapshot(),
            }).encode(), content_type="application/json")
        elif self.path == "/metrics":
            _respond(self, 200,
                     metrics.render_prometheus().encode(),
                     content_type=_METRICS_CONTENT_TYPE)
        elif self.path == "/healthz":
            _respond(self, 200, json.dumps(
                self.server.health()).encode(),
                content_type="application/json")
        elif self.path == "/exit":
            # Process-level shutdown; no build context to carry.
            threading.Thread(target=self.server.shutdown,
                             daemon=True).start()
            _respond(self, 200, b"bye")
        else:
            _respond(self, 404, b"not found")


class ServeServer(socketserver.ThreadingMixIn,
                  socketserver.UnixStreamServer):
    """Standalone chunk-native distribution endpoint over one storage
    directory: recipes + ranged pack serving, read-only. Builders
    populate the storage (their indexed chunks and published recipes);
    this process only hands bytes out."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, socket_path: str, storage_dir: str) -> None:
        if os.path.exists(socket_path):
            os.unlink(socket_path)
        super().__init__(socket_path, _ServeHandler)
        self.socket_path = socket_path
        self.storage_dir = storage_dir
        import time
        self._started_mono = time.monotonic()
        # The chunk CAS must be registered as a serving store for
        # iter_pack_range's open_served_chunk reads — full retention
        # sizing, same as a builder's (an evicting CAS would silently
        # shrink what this endpoint can serve).
        from makisu_tpu_torch.cache import chunks as chunks_mod
        self._chunk_store = chunks_mod.ChunkStore(
            os.path.join(storage_dir, "chunks"))
        chunks_mod.register_serving_store(self._chunk_store)
        self.store = register_store(storage_dir)
        # Per-server access ledger: this endpoint's own request rows
        # (trace-id-stamped), never a sibling's.
        self.serve_access = AccessLog()
        # Deliberately NOT enable_publishing(): this server is
        # read-only — it never indexes layers, so the flag would only
        # leak publish cost into builds an embedder (bench, tests)
        # runs later in the same process. Processes that build AND
        # serve (workers) opt in explicitly; standalone builders use
        # MAKISU_TPU_SERVE=1.

    def get_request(self):
        request, _ = super().get_request()
        return request, ("serve", 0)

    def handle_error(self, request, client_address) -> None:
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError)):
            return
        super().handle_error(request, client_address)

    def health(self) -> dict:
        import time
        g = metrics.global_registry()
        return {
            "status": "ok",
            "uptime_seconds": round(
                time.monotonic() - self._started_mono, 3),
            "storage": self.storage_dir,
            "serve": serve_stats(),
            "recipe_requests": int(g.counter_total(
                metrics.SERVE_RECIPE_REQUESTS)),
            "pack_requests": int(g.counter_total(
                metrics.SERVE_PACK_REQUESTS)),
            "pack_bytes": int(g.counter_total(
                metrics.SERVE_PACK_BYTES)),
        }

    def serve_background(self) -> threading.Thread:
        # Process-level accept loop; handler threads serve reads only
        # and never touch a build's contextvar state.
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t
