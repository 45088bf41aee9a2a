"""Delta-pull client: fetch only the chunks you don't have.

Copy of ``makisu_tpu/serve/client.py``. The consuming half of the
distribution plane, used three ways:

- ``pull --delta`` (``pull_image_delta``): manifest + config
  come from the registry as always; each layer's bytes come from a
  serve endpoint's recipe + ranged pack fetches, falling back per-layer
  to the registry blob route when no recipe is published.
- the library surface (``ServeClient`` + ``delta_pull_layer``) for
  embedders.
- the fleet peer plane (``fleet/peers.py``), which points the same
  planning/fetch/carve core at sibling workers' sockets.

The wire discipline: missing chunks are grouped by pack, adjacent
spans coalesce into runs (gap ≤ ``ChunkStore.PACK_RUN_GAP``), each run
is one HTTP Range request charged against the memory budget, and
packs mostly-needed fetch whole — so the cost of a pull is ~the novel
fraction in bytes and ~the novel-region count in round trips. Every
carved chunk is sha256-verified before the CAS stores it, and a
reconstituted layer must match the registry digest byte-for-byte
before install: a lying or corrupt server can waste bytes, never
install bytes.
"""

from __future__ import annotations

import http.client
import threading

from makisu_tpu_torch.serve import recipe as recipe_mod
from makisu_tpu_torch.utils import events
from makisu_tpu_torch.utils import logging as log
from makisu_tpu_torch.utils import metrics

# Planning math AND its constants come from the registry pack-fetch
# path's single definition (cache/chunks.py): span coalescing, the
# whole-pack crossover, and their tuning are properties of
# ranged-fetch economics, not of the transport — one implementation
# means a change there moves the serve/peer wire and the registry
# wire together, never one without the other.
from makisu_tpu_torch.cache.chunks import plan_frame_runs
from makisu_tpu_torch.cache.chunks import plan_pack_runs as plan_runs

# Connect/read timeouts for serve-endpoint requests: local-ish sockets;
# an endpoint that can't answer promptly is effectively down and the
# registry fallback is waiting.
SERVE_TIMEOUT = 60.0
SERVE_CONNECT_TIMEOUT = 5.0


class ServeClient:
    """Thin HTTP client for a serve endpoint (a ``serve``
    socket or any worker socket — the handlers are shared)."""

    def __init__(self, socket_path: str,
                 timeout: float = SERVE_TIMEOUT,
                 connect_timeout: float = SERVE_CONNECT_TIMEOUT) -> None:
        self.socket_path = socket_path
        self.timeout = timeout
        self.connect_timeout = connect_timeout
        # Transport failures (dead socket, timeout — NOT 404s) since
        # construction: the peer plane reads this to mark an endpoint
        # dead instead of re-paying the timeout per layer (the recipe/
        # pack_range return value can't distinguish "miss" from
        # "down").
        self.transport_failures = 0
        # One keep-alive connection per thread: after a scattered edit
        # round-trip latency, not bytes, dominates a delta pull, so
        # each engine thread reuses its connection across recipe and
        # range requests instead of paying a connect (plus a server
        # handler-thread spawn) per request.
        self._local = threading.local()

    def _connect(self):
        from makisu_tpu_torch.worker.client import _UnixHTTPConnection
        return _UnixHTTPConnection(self.socket_path, self.timeout,
                                   connect_timeout=self.connect_timeout)

    def _request(self, path: str, headers: dict | None):
        """One GET on this thread's pooled connection. A stale pooled
        socket (server idled it out between requests) retries ONCE on
        a fresh connection; a failure on a fresh one propagates.

        EVERY serve-plane request carries the caller's trace context
        (the fetching build's adopted trace id) — injected here, the
        single choke point, so the ranged pack/zpack fetches that move
        the actual bytes correlate in the server's access ledger, not
        just the recipe lookups. An explicit caller header wins; same
        injection the registry and KV planes use."""
        headers = dict(headers or {})
        headers.setdefault("traceparent",
                           metrics.current_traceparent())
        conn = getattr(self._local, "conn", None)
        self._local.conn = None
        fresh = conn is None
        if conn is None:
            conn = self._connect()
        while True:
            try:
                conn.request("GET", path, headers=headers)
                return conn, conn.getresponse()
            except (OSError, http.client.HTTPException):
                conn.close()
                if fresh:
                    raise
                conn = self._connect()
                fresh = True

    def _retain(self, conn, resp) -> None:
        """Pool the connection back — callers only invoke this after
        fully draining the response body."""
        if getattr(resp, "will_close", True):
            conn.close()
        else:
            self._local.conn = conn

    def _get(self, path: str, headers: dict | None = None):
        try:
            conn, resp = self._request(path, headers)
        except (OSError, http.client.HTTPException):
            self.transport_failures += 1
            raise
        try:
            body = resp.read()
        except (OSError, http.client.HTTPException):
            self.transport_failures += 1
            conn.close()
            raise
        status, hdrs = resp.status, dict(resp.getheaders())
        self._retain(conn, resp)
        return status, hdrs, body

    def ready(self) -> bool:
        try:
            status, _, _ = self._get("/ready")
            return status == 200
        except (OSError, http.client.HTTPException):
            return False

    def recipe(self, layer_hex: str,
               key: bytes | None = None) -> dict | None:
        """Fetch + integrity-verify one layer recipe; None on miss,
        transport failure, or a recipe that fails verification (a bad
        signature is a miss, not an error — the blob route is the safe
        degradation)."""
        try:
            status, _, body = self._get(f"/recipes/{layer_hex}")
        except (OSError, http.client.HTTPException):
            return None
        if status != 200:
            return None
        try:
            import json
            doc = json.loads(body)
        except ValueError:
            return None
        if not recipe_mod.verify(doc, key=key):
            log.warning("recipe for %s failed verification; ignoring",
                        layer_hex)
            return None
        return doc

    def pack_range(self, pack_hex: str, start: int, end: int,
                   limit: int | None = None
                   ) -> tuple[str, bytes | int] | None:
        """GET bytes [start, end) of a pack (raw wire). Returns
        ``("partial", bytes)`` on 206 (length-checked),
        ``("full", whole_pack)`` on 200 whose body fits ``limit``,
        ``("oversized", content_length)`` — body UNREAD — on a 200
        that would exceed it (a Range-ignoring server answering a span
        request with the whole pack; the caller re-reserves at the
        true size and re-fetches), None on failure. ``limit`` is the
        caller's memory-budget reservation: without it a full-pack 200
        would sit resident against a reservation sized for the span
        alone."""
        return self._ranged_get(f"/packs/{pack_hex}", start, end,
                                limit)

    def zpack_range(self, pack_hex: str, start: int, end: int,
                    limit: int | None = None
                    ) -> tuple[str, bytes | int] | None:
        """GET compressed bytes [start, end) of a pack's seekable-zstd
        twin (``/zpacks``); same return contract as
        :meth:`pack_range`. A 404 — old server, frame-less pack — is
        None, the caller's signal to use the raw wire."""
        return self._ranged_get(f"/zpacks/{pack_hex}", start, end,
                                limit)

    def _ranged_get(self, path: str, start: int, end: int,
                    limit: int | None = None
                    ) -> tuple[str, bytes | int] | None:
        try:
            conn, resp = self._request(
                path, {"Range": f"bytes={start}-{end - 1}"})
        except (OSError, http.client.HTTPException):
            self.transport_failures += 1
            return None
        # Only a fully-drained response leaves the connection reusable;
        # every other path (truncation, unread oversized body, midway
        # error) closes it.
        drained = False
        try:
            if resp.status == 206:
                body = resp.read(end - start + 1)
                if len(body) != end - start:
                    return None  # truncated mid-stream (chunk eviction)
                drained = True
                return "partial", body
            if resp.status == 200:
                if limit is not None:
                    clen_hdr = resp.getheader("Content-Length")
                    if clen_hdr is None:
                        # Unknown size: read at most limit+1 — a body
                        # beyond the reservation can't be re-reserved
                        # accurately, so it's a miss (blob fallback).
                        body = resp.read(limit + 1)
                        if len(body) <= limit:
                            drained = True
                            return "full", body
                        return None
                    clen = int(clen_hdr)
                    if clen > limit:
                        return "oversized", clen
                body = resp.read()
                drained = True
                return "full", body
            resp.read()  # drain the small error body so the conn pools
            drained = True
            return None
        except (OSError, http.client.HTTPException, ValueError):
            self.transport_failures += 1
            return None
        finally:
            if drained:
                self._retain(conn, resp)
            else:
                conn.close()


def fetch_missing(fetch_range, rows: list, missing: set,
                  put, pack_sizes: dict | None = None,
                  zframes: dict | None = None,
                  fetch_zrange=None) -> tuple[set, dict]:
    """The fetch/carve core: plan runs for ``missing``, execute them in
    parallel across packs on the transfer engine (runs within one pack
    stay sequential so a failure stops further requests against it),
    charge each run's bytes to the memory budget, and store verified
    chunks via ``put(fp, bytes)`` (which re-verifies the digest —
    corrupt range bytes are dropped, never stored).

    ``fetch_range(pack_hex, start, end, limit=N) -> (kind, payload) |
    None`` abstracts the transport (serve socket, peer worker socket)
    — the ``ServeClient.pack_range`` contract, including the
    ``("oversized", content_length)`` answer for a Range-ignoring
    server whose full body exceeds the span reservation.
    ``pack_sizes`` (the recipe's ``packs`` map) gives the planner the
    referenced packs' TRUE sizes — without it the whole-pack crossover
    is judged against only this recipe's referenced extent, firing
    early on packs shared with other layers.

    ``zframes`` (the recipe's ``zpacks`` map: pack hex → frame-index
    rows) plus ``fetch_zrange`` (the ``/zpacks`` transport,
    ``ServeClient.zpack_range``) switch eligible packs onto the
    **seekable-zstd wire**: missing spans map to frame runs
    (``plan_frame_runs``), one ranged request per run moves COMPRESSED
    bytes, each frame decompresses independently, and chunks carve out
    of the decompressed frames — sha256-verified by ``put`` exactly
    like raw spans, so a lying frame never installs. Any failure on
    that wire (404 from an old server, truncated/corrupt frame, no
    local libzstd) drops the pack back to the raw route — negotiation
    by capability, never a hard break. ``stats["raw_wire_bytes"]``
    records what the raw wire would have moved for the same plan, the
    denominator the compressed-vs-raw CI gate reads. Returns
    ``(got_fps, stats)``."""
    from makisu_tpu_torch.registry import transfer
    # First-occurrence coordinate wins per fingerprint, for BOTH the
    # planner and the carve table: recipe rows repeat an fp once per
    # stream occurrence (honest recipes always at one coordinate), so
    # each chunk is fetched and carved once, not once per occurrence —
    # and a lying recipe mapping one fp to TWO coordinates must not
    # plan a pack the carve table doesn't know (KeyError out of the
    # engine instead of the blob-route degradation every other
    # bad-recipe shape gets).
    uniq_rows: list = []
    seen_fps: set[str] = set()
    for fp, length, pack_hex, pack_off in rows:
        if fp in seen_fps:
            continue
        seen_fps.add(fp)
        uniq_rows.append((fp, length, pack_hex, pack_off))
    run_jobs, whole_jobs = plan_runs(uniq_rows, missing,
                                     pack_sizes=pack_sizes)
    spans_by_pack: dict[str, list] = {}
    for fp, length, pack_hex, pack_off in uniq_rows:
        if fp in missing:
            spans_by_pack.setdefault(pack_hex, []).append(
                (int(pack_off), int(length), fp))
    got: set[str] = set()
    stats = {"requests": 0, "bytes_fetched": 0, "raw_wire_bytes": 0}
    mu = threading.Lock()
    budget = transfer.engine().budget
    # Packs eligible for the compressed wire: the recipe published a
    # frame index AND the caller wired a /zpacks transport AND this
    # process can decode zstd. Everything else stays raw.
    zcapable: dict[str, list] = {}
    if zframes and fetch_zrange is not None:
        from makisu_tpu_torch.utils import zstdio
        if zstdio.available():
            zcapable = {ph: fr for ph, fr in zframes.items() if fr}

    def carve(pack_hex: str, data: bytes, base: int, spans) -> None:
        for off, length, fp in spans:
            piece = data[off - base:off - base + length]
            if len(piece) != length:
                continue
            try:
                put(fp, piece)
            except (ValueError, OSError) as e:
                log.warning("pack %s span for chunk %s unusable: %s",
                            pack_hex, fp, e)
                continue
            with mu:
                got.add(fp)

    def note(nbytes: int, raw_equiv: int | None = None) -> None:
        with mu:
            stats["requests"] += 1
            stats["bytes_fetched"] += nbytes
            stats["raw_wire_bytes"] += \
                nbytes if raw_equiv is None else raw_equiv

    def fetch_pack_frames(pack_hex: str, raw_equiv: int) -> bool:
        """The compressed wire for one pack: frame runs fetched over
        /zpacks, frames decompressed independently, chunks carved.
        Returns False on ANY failure — the caller re-runs the raw
        route for the pack (chunks already carved stay; put() is
        idempotent, so the rare mid-pack fallback costs duplicate
        spans, never correctness). ``raw_equiv`` is what the raw plan
        would have moved for this pack (the stats denominator).

        Stats flush only on SUCCESS: a pack that falls back mid-way
        reports its raw re-run alone, so ``bytes_fetched <=
        raw_wire_bytes`` holds exactly even under partial z failure
        (the abandoned attempt's wire bytes stay visible in
        ``makisu_serve_wire_bytes_total{encoding=zstd}`` — the report
        prices plans, the counters price the wire)."""
        from makisu_tpu_torch.utils import zstdio
        frames = zcapable[pack_hex]
        spans = sorted(spans_by_pack[pack_hex])
        try:
            zruns = plan_frame_runs(frames, spans)
        except (TypeError, ValueError, IndexError):
            return False  # malformed frame rows: raw wire
        if not zruns:
            return False
        # The frame index prices BOTH wires before any request:
        # compressed cost is the planned z-run extents, raw cost is
        # what the raw plan would move. Frames win only when they are
        # actually cheaper — frame granularity over-covers scattered
        # spans, and zstd on incompressible chunks grows them, so
        # "compressed" is not automatically "fewer bytes". This is
        # what makes `bytes_fetched <= raw_wire_bytes` an invariant
        # the CI smoke can gate on, not a hope.
        z_cost = sum(zrun[-1][2] + zrun[-1][3] - zrun[0][2]
                     for zrun in zruns)
        if z_cost >= raw_equiv > 0:
            return False
        zreqs = zbytes = 0
        for zrun in zruns:
            z_start = zrun[0][2]
            z_end = zrun[-1][2] + zrun[-1][3]
            raw_total = sum(r[1] for r in zrun)
            # Reservation covers the compressed run AND the frames
            # decompressed from it — both resident while carving.
            with budget.reserve((z_end - z_start) + raw_total):
                span = fetch_zrange(pack_hex, z_start, z_end,
                                    limit=z_end - z_start)
                if span is None:
                    return False
                kind, data = span
                if kind == "oversized":
                    # Range-ignoring server with a zpack bigger than
                    # the run reservation: the raw route's oversized
                    # machinery is the tested degradation.
                    return False
                base = 0 if kind == "full" else z_start
                zreqs += 1
                zbytes += len(data)
                metrics.counter_add(metrics.SERVE_WIRE_BYTES,
                                    len(data), encoding="zstd")
                for raw_off, raw_len, z_off, z_len in zrun:
                    zslice = data[z_off - base:z_off - base + z_len]
                    if len(zslice) != z_len:
                        return False
                    try:
                        rawbuf = zstdio.decompress(zslice, raw_len)
                    except ValueError as e:
                        log.warning("seekable pack %s frame at %d "
                                    "undecodable (%s); raw fallback",
                                    pack_hex, z_off, e)
                        return False
                    frame_end = raw_off + raw_len
                    carve(pack_hex, rawbuf, raw_off,
                          [s for s in spans
                           if s[0] >= raw_off
                           and s[0] + s[1] <= frame_end])
        with mu:
            stats["requests"] += zreqs
            stats["bytes_fetched"] += zbytes
            stats["raw_wire_bytes"] += raw_equiv
        return True

    def fetch_pack_runs(job) -> None:
        pack_hex, runs = job
        if pack_hex in zcapable:
            raw_equiv = sum(
                run[-1][0] + run[-1][1] - run[0][0] for run in runs)
            if fetch_pack_frames(pack_hex, raw_equiv):
                return
        for run in runs:
            start = run[0][0]
            end = run[-1][0] + run[-1][1]
            kind = data = None
            with budget.reserve(end - start):
                span = fetch_range(pack_hex, start, end,
                                   limit=end - start)
                if span is None:
                    return  # this pack is done; others continue
                kind, data = span
                if kind == "partial":
                    note(len(data))
                    metrics.counter_add(metrics.SERVE_WIRE_BYTES,
                                        len(data), encoding="raw")
                    carve(pack_hex, data, start, run)
                elif kind == "full":
                    # Server ignored Range but the body fit the run
                    # reservation: the whole pack is in hand — carve
                    # everything wanted and stop issuing ranges.
                    note(len(data))
                    metrics.counter_add(metrics.SERVE_WIRE_BYTES,
                                        len(data), encoding="raw")
                    carve(pack_hex, data, 0,
                          sorted(spans_by_pack[pack_hex]))
            if kind == "full":
                return
            if kind == "oversized":
                # Range ignored AND the full body exceeds this run's
                # reservation (data = Content-Length, body unread):
                # re-fetch whole under a true-size reservation.
                fetch_whole(pack_hex, size=int(data))
                return

    def fetch_whole(pack_hex: str, size: int = 0) -> None:
        spans = sorted(spans_by_pack[pack_hex])
        end = size or max(off + length for off, length, _ in spans)
        if size == 0 and pack_hex in zcapable:
            # Mostly-needed pack: the compressed wire moves the same
            # frames for a fraction of the bytes; the raw extent is
            # what a whole-pack raw fetch would have moved.
            raw_equiv = (pack_sizes or {}).get(pack_hex, end)
            if fetch_pack_frames(pack_hex, raw_equiv):
                return
        # The second pass only fires for a Range-ignoring server whose
        # true pack size exceeds the referenced extent — retried once
        # at the size it declared, never unbounded.
        for _ in range(2):
            with budget.reserve(end):
                span = fetch_range(pack_hex, 0, end, limit=end)
                if span is None:
                    return
                kind, data = span
                if kind != "oversized":
                    note(len(data))
                    metrics.counter_add(metrics.SERVE_WIRE_BYTES,
                                        len(data), encoding="raw")
                    carve(pack_hex, data, 0, spans)
                    return
            end = int(data)

    engine = transfer.engine()
    engine.map(fetch_pack_runs, run_jobs)
    engine.map(fetch_whole, whole_jobs)
    return got, stats


def delta_pull_layer(serve_client: ServeClient, chunk_store,
                     layer_store, recipe: dict) -> dict | None:
    """Materialize one layer from a verified recipe: diff the chunk
    table against the local chunk CAS, fetch only missing spans,
    reconstitute, and install ONLY if both the tar and gzip digests
    match the recipe's layer identity (which the caller has already
    tied to the registry manifest). Returns a stats dict, or None when
    the layer could not be produced (caller falls back to the blob
    route)."""
    import os

    from makisu_tpu_torch.docker.image import (
        MEDIA_TYPE_LAYER,
        Descriptor,
        Digest,
        DigestPair,
    )
    layer = recipe["layer"]
    rows = recipe["chunks"]
    pair = DigestPair(
        tar_digest=Digest.from_hex(layer["tar"]),
        gzip_descriptor=Descriptor(MEDIA_TYPE_LAYER,
                                   int(layer["size"]),
                                   Digest.from_hex(layer["gzip"])))
    triples = recipe_mod.stream_triples(rows)
    bytes_total = sum(length for _, length, _ in triples)
    lengths: dict[str, int] = {}
    for _, length, fp in triples:
        lengths.setdefault(fp, length)
    missing = {fp for fp in lengths
               if not chunk_store.cas.exists(fp)}
    bytes_missing = sum(lengths[fp] for fp in missing)
    got: set = set()
    stats = {"requests": 0, "bytes_fetched": 0, "raw_wire_bytes": 0}
    if missing:
        got, stats = fetch_missing(serve_client.pack_range, rows,
                                   missing, chunk_store.put,
                                   pack_sizes=recipe.get("packs"),
                                   zframes=recipe.get("zpacks"),
                                   fetch_zrange=serve_client.zpack_range)
        if got != missing:
            log.info("delta pull: %d/%d missing chunks unavailable "
                     "from the serve endpoint for %s",
                     len(missing) - len(got), len(missing),
                     layer["gzip"])
            return None
    path = chunk_store.reconstitute_to_path(
        pair, triples, gz_backend=layer.get("gz") or None)
    if path is None:
        return None
    try:
        layer_store.link_file(layer["gzip"], path)
    finally:
        os.unlink(path)
    metrics.counter_add(metrics.SERVE_DELTA_BYTES,
                        stats["bytes_fetched"], result="fetched")
    metrics.counter_add(metrics.SERVE_DELTA_BYTES,
                        max(bytes_total - bytes_missing, 0),
                        result="reused")
    events.emit("delta_pull_layer", layer=layer["gzip"],
                chunks=len(triples), missing=len(missing),
                bytes_total=bytes_total,
                bytes_fetched=stats["bytes_fetched"],
                requests=stats["requests"])
    return {
        "layer": layer["gzip"],
        "size": int(layer["size"]),
        "chunks": len(triples),
        "chunks_missing": len(missing),
        "bytes_total": bytes_total,
        "bytes_fetched": stats["bytes_fetched"],
        # What the RAW pack wire would have moved for the same plan —
        # equal to bytes_fetched when no seekable frames were used,
        # strictly the uncompressed denominator when they were (the
        # compressed-vs-raw gate the CI smoke reads).
        "raw_wire_bytes": stats.get("raw_wire_bytes",
                                    stats["bytes_fetched"]),
        "bytes_reused": max(bytes_total - bytes_missing, 0),
        "requests": stats["requests"],
    }


def build_pull_report(image, serve_socket: str,
                      layers_report: list) -> dict:
    """The ``makisu-tpu.serve-pull.v1`` economics document, shared by
    ``pull --delta`` and plain ``pull --report-out`` so the two
    emitters can never drift apart: a consumer pointed at either file
    reads one shape. Each row needs ``route`` plus ``bytes_fetched``
    and ``size`` (or ``bytes_total``). Units are per-ROUTE wire
    bytes: delta rows count raw pack span bytes (packs are
    uncompressed), blob/local rows and ``size`` count compressed blob
    bytes — so ``fetched_fraction`` is "bytes this pull moved ÷ bytes
    a cold blob pull would move", which can exceed 1.0 for highly
    compressible mostly-cold layers (see docs/SERVE.md "Units")."""
    fetched = sum(r.get("bytes_fetched", 0) for r in layers_report)
    full = sum(r.get("size", r.get("bytes_total", 0))
               for r in layers_report)
    raw_wire = sum(r.get("raw_wire_bytes", r.get("bytes_fetched", 0))
                   for r in layers_report)
    return {
        "schema": "makisu-tpu.serve-pull.v1",
        "image": str(image),
        "serve_socket": serve_socket,
        "layers": layers_report,
        "bytes_fetched": fetched,
        # The raw-pack-wire denominator: bytes the same pull would
        # have moved without seekable-zstd frames (== bytes_fetched
        # for raw/blob routes). The delta-pull smoke gates
        # bytes_fetched <= bytes_raw_wire.
        "bytes_raw_wire": raw_wire,
        "bytes_full_image": full,
        "fetched_fraction": round(fetched / full, 6) if full else 0.0,
        "delta_layers": sum(1 for r in layers_report
                            if r["route"] == "delta"),
        "fallback_layers": sum(1 for r in layers_report
                               if r["route"] == "blob"),
    }


def pull_image_delta(registry_client, store, name,
                     serve_socket: str) -> tuple:
    """``pull --delta``: manifest + config via the registry
    (identity comes from there, never from the serve plane), layer
    bytes via recipes + ranged pack fetches where published, per-layer
    registry fallback otherwise. Delta layers process SEQUENTIALLY on
    purpose: layer N's missing-set diff runs after layer N-1's chunks
    landed in the CAS, so chunks shared across layers are fetched once
    — pipelining layers (the blob route's start_pull trick) would
    re-fetch every shared chunk per layer and break the delta
    economics this command exists for. Within a layer, pack fetches
    are already parallel on the transfer engine — and blob-route
    FALLBACK layers, which never touch the chunk CAS and so have no
    sharing to protect, are collected during the walk and fetched in
    parallel after it, keeping a no-recipes cold pull at ~the plain
    pull's parallel wall time. Returns
    ``(manifest, report)`` with the report a
    ``makisu-tpu.serve-pull.v1`` economics document."""
    from makisu_tpu_torch.docker.image import ImageName
    tag = name.tag if isinstance(name, ImageName) else str(name)
    manifest = registry_client.pull_manifest(tag)
    registry_client.pull_layer(manifest.config.digest,
                               size=manifest.config.size)
    serve_client = ServeClient(serve_socket)
    from makisu_tpu_torch.cache.chunks import ChunkStore
    import os as os_mod
    chunk_store = ChunkStore(os_mod.path.join(store.root, "chunks"))
    layers_report = []
    seen: set[str] = set()
    fallback: list = []
    for desc in manifest.layers:
        hex_digest = desc.digest.hex()
        if hex_digest in seen:
            continue
        seen.add(hex_digest)
        if store.layers.exists(hex_digest):
            layers_report.append({"layer": hex_digest, "route": "local",
                                  "size": desc.size,
                                  "bytes_fetched": 0})
            continue
        # A transport-dead endpoint must cost ONE connect timeout, not
        # one per layer: after any socket-level failure (the counter
        # never counts 404s), every remaining layer goes straight to
        # the blob route — the same down-vs-miss distinction the peer
        # plane draws from this counter.
        recipe = (serve_client.recipe(hex_digest)
                  if not serve_client.transport_failures else None)
        layer_stats = None
        if recipe is not None \
                and recipe["layer"].get("gzip") == hex_digest \
                and int(recipe["layer"].get("size", -1)) == desc.size:
            layer_stats = delta_pull_layer(serve_client, chunk_store,
                                           store.layers, recipe)
        if layer_stats is not None:
            metrics.counter_add(metrics.SERVE_DELTA_PULLS,
                                result="delta")
            layer_stats["route"] = "delta"
            layers_report.append(layer_stats)
            log.info("delta-pulled layer %s: %d/%d bytes over the "
                     "wire in %d request(s)", hex_digest,
                     layer_stats["bytes_fetched"],
                     layer_stats["bytes_total"],
                     layer_stats["requests"])
            continue
        metrics.counter_add(metrics.SERVE_DELTA_PULLS,
                            result="fallback")
        fallback.append(desc)
        layers_report.append({"layer": hex_digest, "route": "blob",
                              "size": desc.size,
                              "bytes_fetched": desc.size})
    if fallback:
        from makisu_tpu_torch.registry import transfer
        transfer.engine().map(
            lambda desc: registry_client.pull_layer(desc.digest,
                                                    size=desc.size),
            fallback)
    if isinstance(name, ImageName):
        store.manifests.save(name, manifest)
    report = build_pull_report(name, serve_socket, layers_report)
    log.info("delta pull %s: %d of %d full-image bytes fetched "
             "(%.1f%%), %d delta / %d fallback layer(s)", name,
             report["bytes_fetched"], report["bytes_full_image"],
             100.0 * report["fetched_fraction"],
             report["delta_layers"], report["fallback_layers"])
    return manifest, report
