"""Peer chunk exchange: fetch missing chunks worker-to-worker.

Copy of ``makisu_tpu/fleet/peers.py``: the same wire (``/recipes``,
``/packs``, ``/zpacks``, ``/chunks``), so a port worker and a makisu_tpu
worker exchange chunks either way. Until the fleet front door is ported,
whoever runs the workers publishes the map with ``POST /peers``.

The scheduler publishes the fleet membership to every worker
(``POST /peers``); this module holds that map process-wide and serves
the consuming side: when a build's chunk CAS is missing chunks that a
KV cache hit references (``cache/chunks.py ensure_available``), the
peers are consulted — ``GET /chunks/<fingerprint>`` on each worker
socket — BEFORE the registry/KV blob plane is paid. A sibling worker
that built the same (or any chunk-sharing) context holds the bytes one
unix-socket round trip away; the registry is a WAN away.

The exchange is **pack-granular**: a fetch first asks each peer for the
layer's signed recipe (``GET /recipes/<layer_hex>`` — the distribution
plane's metadata, ``serve/``) and pulls the missing chunks as coalesced ranged
pack reads (``GET /packs/<hex>`` with Range), so after a 1% edit the
peer wire carries ~the novel-region count in round trips instead of
one request per ~8KiB chunk. The per-chunk ``GET /chunks/<fp>`` route
is kept strictly as the fallback — old workers without the serve
endpoints, and chunks no published recipe covers. Both routes are
digest-verified on arrival and charged against the transfer engine's
memory budget so peer traffic and registry traffic share one bound.

In-process fleets (tests, drives) share this module's
globals across their workers; that is correct — they also share one
peer map in a real deployment — except for self-identity, which is
context-bound per build (``bind_self_socket``) so a worker never pays
a round trip asking itself.
"""

from __future__ import annotations

import contextvars
import hashlib
import http.client
import threading

from makisu_tpu_torch.utils import logging as log
from makisu_tpu_torch.utils import metrics

# Metric names: the shared set in utils/metrics.py (hits/misses count
# CHUNKS, not requests).
PEER_CHUNK_HITS = metrics.FLEET_PEER_CHUNK_HITS
PEER_CHUNK_MISSES = metrics.FLEET_PEER_CHUNK_MISSES
PEER_CHUNK_BYTES = metrics.FLEET_PEER_CHUNK_BYTES
PEER_MAP_VERSION = metrics.FLEET_PEER_MAP_VERSION

# Connect/read timeout for one peer GET. Peers are local-ish sockets;
# a peer that can't answer in this window is effectively down and the
# registry fallback is waiting.
PEER_TIMEOUT = 5.0

# A peer that failed a request is skipped for this many seconds — a
# dead worker must not charge every subsequent missing chunk a
# connect timeout each.
PEER_BACKOFF = 10.0

_mu = threading.Lock()
_peers: tuple[str, ...] = ()
_version = 0
_dead_until: dict[str, float] = {}

# The requesting worker's own socket, bound per build context by
# WorkerServer.run_build: excluded from fetch attempts.
_self_socket: "contextvars.ContextVar[str]" = contextvars.ContextVar(
    "makisu_fleet_self_socket", default="")


def bind_self_socket(socket_path: str):
    """Mark ``socket_path`` as "myself" in the current context (a
    worker binds this around each build so peer fetches skip it).
    Returns a reset token."""
    return _self_socket.set(socket_path)


def reset_self_socket(token) -> None:
    _self_socket.reset(token)


def set_peers(sockets, version: int | None = None) -> bool:
    """Install the peer map (the scheduler's ``POST /peers`` payload).
    Versions are monotonic — a late-arriving stale map is ignored.
    Returns whether the map was applied."""
    global _peers, _version
    cleaned = tuple(dict.fromkeys(s for s in sockets if s))
    with _mu:
        if version is not None and version < _version:
            return False
        _peers = cleaned
        if version is not None:
            _version = version
        else:
            _version += 1
        _dead_until.clear()
        metrics.global_registry().gauge_set(PEER_MAP_VERSION, _version)
    return True


def peers() -> tuple[str, ...]:
    with _mu:
        return _peers


def map_version() -> int:
    with _mu:
        return _version


def available() -> bool:
    """Whether any peer other than ourselves is known."""
    me = _self_socket.get()
    with _mu:
        return any(p != me for p in _peers)


def reset() -> None:
    """Drop the map (tests)."""
    global _peers, _version
    with _mu:
        _peers = ()
        _version = 0
        _dead_until.clear()


def _candidates(rotation: int) -> list[str]:
    """Live peers, self excluded, rotated so concurrent fetchers
    spread load instead of hammering the first listed worker."""
    import time
    me = _self_socket.get()
    now = time.monotonic()
    with _mu:
        live = [p for p in _peers
                if p != me and _dead_until.get(p, 0.0) <= now]
    if not live:
        return []
    pivot = rotation % len(live)
    return live[pivot:] + live[:pivot]


def _mark_dead(socket_path: str) -> None:
    import time
    with _mu:
        _dead_until[socket_path] = time.monotonic() + PEER_BACKOFF


def fetch_chunk(hex_digest: str) -> bytes | None:
    """Fetch one chunk from the first peer holding it; bytes are
    digest-verified before they are returned (a peer can be wrong, the
    CAS must not be). Returns None when no peer has it."""
    # Late import: worker.client imports nothing from the cache tree,
    # but keeping it out of module import time keeps peers importable
    # from anywhere in the tree without cycles.
    from makisu_tpu_torch.worker.client import _UnixHTTPConnection
    rotation = int(hex_digest[:8], 16) if len(hex_digest) >= 8 else 0
    for peer in _candidates(rotation):
        conn = _UnixHTTPConnection(peer, PEER_TIMEOUT,
                                   connect_timeout=PEER_TIMEOUT)
        try:
            # The fetching build's trace context rides along so the
            # serving worker's access ledger names this build's trace.
            conn.request("GET", f"/chunks/{hex_digest}", headers={
                "traceparent": metrics.current_traceparent()})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                continue
            if hashlib.sha256(data).hexdigest() != hex_digest:
                log.warning("peer %s served corrupt chunk %s",
                            peer, hex_digest)
                continue
            return data
        except (OSError, http.client.HTTPException):
            _mark_dead(peer)
            continue
        finally:
            conn.close()
    return None


def fetch_via_packs(put, missing: list[str],
                    layer_hex: str) -> set[str]:
    """Pack-granular exchange: ask each live peer for the layer's
    signed recipe; a peer that answers serves the missing chunks as
    coalesced ranged pack reads through the shared planning/fetch core
    (serve/client.py — per-run budget reservations, digest-verified
    carving). Peers that 404 (old workers, or the layer just isn't
    published there) cost one round trip and fall through; remaining
    chunks go to the per-chunk fallback. Returns the digests
    obtained."""
    from makisu_tpu_torch.serve.client import ServeClient, fetch_missing
    want = set(missing)
    got: set[str] = set()
    rotation = int(layer_hex[:8], 16) if len(layer_hex) >= 8 else 0
    for peer in _candidates(rotation):
        if not want:
            break
        client = ServeClient(peer, timeout=PEER_TIMEOUT,
                             connect_timeout=PEER_TIMEOUT)
        doc = client.recipe(layer_hex)
        if doc is None:
            if client.transport_failures:
                # Dead/wedged peer (not a 404): back it off like the
                # per-chunk route does, instead of re-paying the
                # timeout on every later layer.
                _mark_dead(peer)
            continue
        covered = {row[0] for row in doc["chunks"]} & want
        if not covered:
            continue
        # The peer wire rides the same seekable-zstd frames as the
        # serve plane when the recipe advertises them (zpacks) — a
        # relocated build's chunks cross worker sockets compressed;
        # old peers without /zpacks 404 back onto the raw pack wire.
        from_peer, stats = fetch_missing(client.pack_range,
                                         doc["chunks"], covered, put,
                                         pack_sizes=doc.get("packs"),
                                         zframes=doc.get("zpacks"),
                                         fetch_zrange=client.zpack_range)
        if client.transport_failures:
            _mark_dead(peer)
        if stats["requests"]:
            metrics.counter_add(metrics.SERVE_PEER_PACK_REQUESTS,
                                stats["requests"])
            metrics.counter_add(metrics.SERVE_PEER_PACK_BYTES,
                                stats["bytes_fetched"])
        if from_peer:
            log.info("fetched %d/%d missing chunks from peer %s as "
                     "%d ranged pack read(s)", len(from_peer),
                     len(want), peer, stats["requests"])
        got |= from_peer
        want -= from_peer
    return got


def fetch_chunks(put, missing: list[str],
                 lengths: dict[str, int],
                 layer_hex: str | None = None) -> set[str]:
    """Fetch ``missing`` chunks from peers: pack-granular first when
    the caller can name the layer (``layer_hex`` — recipes are keyed
    by it), then the per-chunk fallback in parallel on the transfer
    engine (blob-granular leaves, like the registry chunk fetches they
    stand in front of), each reservation charged to the global memory
    budget. ``put(hex, bytes)`` stores a verified chunk (ChunkStore.put
    re-verifies; cheap). Returns the digests obtained."""
    if not missing or not available():
        return set()
    requested = len(missing)
    got: set[str] = set()
    got_bytes = [0]
    if layer_hex:
        got = fetch_via_packs(put, missing, layer_hex)
        got_bytes[0] = sum(lengths.get(h, 0) for h in got)
        missing = [h for h in missing if h not in got]
    from makisu_tpu_torch.registry import transfer
    engine = transfer.engine()
    mu = threading.Lock()

    def fetch_one(hex_digest: str) -> None:
        with engine.budget.reserve(lengths.get(hex_digest, 0)):
            data = fetch_chunk(hex_digest)
            if data is None:
                return
            try:
                put(hex_digest, data)
            except (ValueError, OSError) as e:
                log.warning("peer chunk %s unusable: %s",
                            hex_digest, e)
                return
        with mu:
            got.add(hex_digest)
            got_bytes[0] += len(data)

    if missing:
        engine.map(fetch_one, missing)
    if got:
        metrics.counter_add(PEER_CHUNK_HITS, len(got))
        metrics.counter_add(PEER_CHUNK_BYTES, got_bytes[0])
    if requested > len(got):
        metrics.counter_add(PEER_CHUNK_MISSES, requested - len(got))
    return got
