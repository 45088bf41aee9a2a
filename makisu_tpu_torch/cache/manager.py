"""Cache manager: map chained cache IDs to layers, with async push.

Copy of ``makisu_tpu/cache/manager.py`` with its telemetry (pull and
miss-reason counters, ``cache`` events, ``kv`` ledger decisions, the
push-queue gauge). Entries go to the KV store in
the same JSON schema (``{tar, gzip, size, gz, chunks, packs}``), so
makisu_tpu and this package read each other's entries. The base route
is a hit when the layer blob is in the local store, whatever gzip backend
wrote it (applying a layer only reads gzip), or, with a registry client,
when the registry holds the blob (one HEAD; the blob transfers lazily
when something needs its bytes). Layer pushes and KV writes run on a
thread per entry, joined by ``wait_for_push``.
Reference: lib/cache/cache_manager.go (mem-map + KV, 3 tries + registry
PullLayer :116-182; async push :184-222; WaitForPush 10-min bound
:225-237; empty sentinel :35,144; noop impl :47-62).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
from typing import TYPE_CHECKING

from makisu_tpu_torch import tario
from makisu_tpu_torch.docker.image import (
    MEDIA_TYPE_LAYER,
    Descriptor,
    Digest,
    DigestPair,
)
from makisu_tpu_torch.utils import events, ledger, metrics
from makisu_tpu_torch.utils import logging as log

if TYPE_CHECKING:  # the chunker loads torch; the census needs neither
    from makisu_tpu_torch.chunker.hasher import LayerCommit

# In-flight async cache pushes across every CacheManager in the process:
# the label-less global push-queue-depth gauge.
_push_gauge_lock = threading.Lock()
_push_inflight_total = 0

EMPTY_ENTRY = "MAKISU_TPU_CACHE_EMPTY"  # a step that committed no layer
_KV_RETRIES = 3


class CacheMiss(KeyError):
    """No usable entry for this cache ID — breaks the stage's prefetch
    chain (distinct from the EMPTY sentinel, which continues it)."""


def encode_entry(pair: DigestPair | None,
                 commit: LayerCommit | None = None) -> str:
    if pair is None:
        return EMPTY_ENTRY
    entry = {
        "tar": str(pair.tar_digest),
        "gzip": str(pair.gzip_descriptor.digest),
        "size": pair.gzip_descriptor.size,
        # The compression identity the layer was actually written with.
        "gz": ((commit.gzip_backend_id if commit is not None else "")
               or tario.gzip_backend_id()),
    }
    if commit is not None and commit.chunks:
        entry["chunks"] = [[c.offset, c.length, c.hex_digest]
                           for c in commit.chunks]
    return json.dumps(entry, separators=(",", ":"))


def decode_entry_full(raw: str) -> tuple[DigestPair | None, list,
                                         str | None, list]:
    """(pair, chunks, gzip backend id, packs) of one entry. ``packs`` maps
    the layer's newly pushed chunks to their pack blobs
    (``[[pack_hex, [chunk_index, ...]], ...]``; empty for an entry whose
    chunks were never pushed as packs)."""
    if raw == EMPTY_ENTRY:
        return None, [], None, []
    entry = json.loads(raw)
    pair = DigestPair(
        tar_digest=Digest(entry["tar"]),
        gzip_descriptor=Descriptor(MEDIA_TYPE_LAYER, entry["size"],
                                   Digest(entry["gzip"])))
    return (pair, entry.get("chunks", []), entry.get("gz"),
            entry.get("packs", []))


def record_miss(cache_id: str, reason: str,
                verdict: str = "miss", **fields) -> None:
    """One failed cache consult, wherever it must land: the
    result="miss" pull counter, ``makisu_cache_miss_total{reason}``, the
    ``cache`` event and the ledger. ``verdict`` tells an absent entry
    ("miss") from one that existed but could not be honored ("stale")
    and from an infrastructure failure ("error")."""
    metrics.counter_add("makisu_cache_pull_total", result="miss")
    metrics.counter_add("makisu_cache_miss_total",
                        reason=ledger.coarse_reason(reason))
    events.emit("cache", result="miss", cache_id=cache_id, reason=reason)
    ledger.record("kv", cache_id, verdict, reason=reason, **fields)


def get_entry(manager, cache_id: str) -> tuple[str, DigestPair | None,
                                               list, str | None, list]:
    """Shared consult head of both pull routes (blob and chunk-aware):
    KV lookup and decode, each failure classified and recorded. Returns
    ``(raw, pair, chunks, gz_backend, packs)``; raises CacheMiss for an
    absent, unreachable or undecodable entry."""
    raw, reason = manager._get_raw2(cache_id)
    if raw is None:
        record_miss(cache_id, reason or "absent",
                    verdict="error" if reason == "kv_error" else "miss")
        raise CacheMiss(cache_id)
    try:
        pair, chunks, gz_backend, packs = decode_entry_full(raw)
    except (ValueError, KeyError, TypeError) as e:
        log.warning("cache entry %s undecodable (%s); treating as miss",
                    cache_id, e)
        record_miss(cache_id, "decode_error", verdict="error")
        raise CacheMiss(cache_id) from e
    return raw, pair, chunks, gz_backend, packs


class CacheManager:
    """Pulls/pushes layers keyed by cache ID through a KV store, the local
    image store and, when given one, a registry client."""

    PUSH_TIMEOUT_SECONDS = 600

    def __init__(self, kv_store, image_store, registry_client=None) -> None:
        self.kv = kv_store
        self.store = image_store
        self.registry = registry_client
        self._mem: dict[str, str] = {}
        # Lazily materializable cache hits: gzip hex digest -> raw entry.
        # A hit whose blob is not local produces its bytes only when
        # something needs them (layer apply, an export, an upload the
        # target registry cannot HEAD-skip). MAKISU_TPU_LAZY_CACHE=0
        # makes every such hit materialize at pull time.
        self._lazy: dict[str, str] = {}
        self._lock = threading.Lock()
        self._pushes: list[threading.Thread] = []

    @staticmethod
    def lazy_enabled() -> bool:
        return os.environ.get("MAKISU_TPU_LAZY_CACHE", "1") == "1"

    def _get_raw2(self, cache_id: str) -> tuple[str | None, str | None]:
        """Entry lookup, build-local memory first, then the KV store,
        that says why nothing came back: ``(raw, None)``,
        ``(None, "absent")`` when the store has no entry, ``(None,
        "kv_error")`` when every KV attempt raised."""
        with self._lock:
            raw = self._mem.get(cache_id)
        if raw is not None:
            return raw, None
        for attempt in range(_KV_RETRIES):
            try:
                with metrics.span("kv_pull"):
                    raw = self.kv.get(cache_id)
                break
            except Exception as e:  # noqa: BLE001 - retried, then a miss
                metrics.counter_add("makisu_cache_kv_retries_total",
                                    op="get")
                log.warning("cache KV get %s failed (try %d): %s",
                            cache_id, attempt + 1, e)
        else:
            return None, "kv_error"
        return (raw, None) if raw is not None else (None, "absent")

    def pull_cache(self, cache_id: str) -> DigestPair | None:
        """Layer for this cache ID. Returns None for the EMPTY sentinel (a
        step known to commit nothing); raises CacheMiss when no usable
        entry exists. A blob that is not local is not transferred here:
        a hit is a promise the build keeps, so the registry's HEAD must
        answer for it now, and the bytes move when needed
        (open_layer_tar / materialize)."""
        raw, pair, _chunks, _gz, _packs = get_entry(self, cache_id)
        if pair is None:
            # Sentinel: the step is known to produce no layer.
            metrics.counter_add("makisu_cache_pull_total", result="empty")
            events.emit("cache", result="empty", cache_id=cache_id)
            ledger.record("kv", cache_id, "empty")
            return None
        hex_digest = pair.gzip_descriptor.digest.hex()
        if not self.store.layers.exists(hex_digest):
            if self.registry is None:
                log.info("cache hit %s but layer %s not local; ignoring",
                         cache_id, hex_digest)
                record_miss(cache_id, "layer_not_local", verdict="stale",
                            layer=hex_digest)
                raise CacheMiss(cache_id)
            if self.lazy_enabled():
                try:
                    remote_ok = self.registry.layer_exists(
                        pair.gzip_descriptor.digest)
                except Exception as e:  # noqa: BLE001 - network plane
                    log.warning("cache hit %s: blob HEAD failed (%s); "
                                "treating as miss", cache_id, e)
                    remote_ok = False
                if not remote_ok:
                    log.info("cache hit %s but blob %s gone from the "
                             "registry; ignoring", cache_id, hex_digest)
                    record_miss(cache_id, "blob_gone", verdict="stale",
                                layer=hex_digest)
                    raise CacheMiss(cache_id)
                with self._lock:
                    self._lazy[hex_digest] = raw
                log.info("cache hit %s -> %s (lazy: blob deferred)",
                         cache_id, hex_digest)
                metrics.counter_add("makisu_cache_pull_total",
                                    result="hit")
                events.emit("cache", result="hit", cache_id=cache_id,
                            layer=hex_digest, lazy=True)
                ledger.record("kv", cache_id, "hit", layer=hex_digest,
                              route="lazy_blob",
                              bytes_saved=pair.gzip_descriptor.size)
                return pair
            self.registry.pull_layer(pair.gzip_descriptor.digest)
        log.info("cache hit %s -> %s", cache_id, hex_digest)
        metrics.counter_add("makisu_cache_pull_total", result="hit")
        events.emit("cache", result="hit", cache_id=cache_id,
                    layer=hex_digest)
        ledger.record("kv", cache_id, "hit", layer=hex_digest,
                      route="blob", bytes_saved=pair.gzip_descriptor.size)
        return pair

    # -- materialization (the lazy half of pull) --------------------------

    def materialize(self, hex_digest: str) -> str:
        """Path of the blob in the local store. Base route: the blob is
        local, or it is pulled from the registry; without one this raises
        CacheMiss. Chunk dedup puts reconstitution in front."""
        if self.store.layers.exists(hex_digest):
            return self.store.layers.path(hex_digest)
        if self.registry is None:
            raise CacheMiss(f"layer {hex_digest} not local and no "
                            "registry to materialize it from")
        path = self.registry.pull_layer(Digest.from_hex(hex_digest))
        with self._lock:
            self._lazy.pop(hex_digest, None)
        return path

    def materialize_pending(self) -> None:
        """Materialize every deferred blob (``--dest``, ``--oci-dest`` and
        ``--load`` need the bytes of every layer)."""
        with self._lock:
            pending = list(self._lazy)
        for hex_digest in pending:
            self.materialize(hex_digest)

    def open_layer_tar(self, pair: DigestPair):
        """Context manager yielding the layer's uncompressed tar stream,
        what layer application reads. Base route: materialize the blob,
        then inflate; chunk dedup streams from chunks instead."""

        @contextlib.contextmanager
        def _open():
            hex_digest = pair.gzip_descriptor.digest.hex()
            self.materialize(hex_digest)
            with self.store.layers.open(hex_digest) as f:
                with tario.gzip_reader(f) as gz:
                    yield gz

        return _open()

    # -- push ---------------------------------------------------------------

    def _set_push_queue_gauge(self, own_depth: int) -> None:
        """The process-global gauge carries the in-flight count across
        every manager (one build's clean finish must not zero another's
        wedged push); the build's own registry sees this manager's."""
        with _push_gauge_lock:
            total = _push_inflight_total
        g = metrics.global_registry()
        g.gauge_set("makisu_cache_push_queue_depth", total)
        bound = metrics.active_registry()
        if bound is not g:
            bound.gauge_set("makisu_cache_push_queue_depth", own_depth)

    def push_cache(self, cache_id: str,
                   pair: DigestPair | None,
                   commit: LayerCommit | None = None) -> None:
        """Record the mapping, then push the layer (with a registry) and
        write the KV entry on a thread of its own; a failure is logged and
        never fails the build (reference :210-212)."""
        entry = encode_entry(pair, commit)
        metrics.counter_add("makisu_cache_push_total")
        with self._lock:
            self._mem[cache_id] = entry

        def push() -> None:
            try:
                if pair is not None and self.registry is not None:
                    self.registry.push_layer(pair.gzip_descriptor.digest)
                for attempt in range(_KV_RETRIES):
                    try:
                        # Re-read at put time: the pack thread may have
                        # enriched the entry (set_entry_packs) while the
                        # blob uploaded; loop until the value written is
                        # the value in _mem (the put runs unlocked).
                        while True:
                            with self._lock:
                                current = self._mem.get(cache_id, entry)
                            with metrics.span("kv_push"):
                                self.kv.put(cache_id, current)
                            with self._lock:
                                if self._mem.get(cache_id,
                                                 entry) == current:
                                    return
                    except Exception as e:  # noqa: BLE001 - retried
                        metrics.counter_add(
                            "makisu_cache_kv_retries_total", op="put")
                        log.warning("cache KV put %s failed (try %d): %s",
                                    cache_id, attempt + 1, e)
            except Exception as e:  # noqa: BLE001 - logged, never fatal
                metrics.counter_add("makisu_cache_push_failures_total")
                log.warning("async cache push %s failed: %s", cache_id, e)

        def push_and_account() -> None:
            global _push_inflight_total
            try:
                push()
            finally:
                with self._lock:
                    own = sum(1 for p in self._pushes
                              if p.is_alive()
                              and p is not threading.current_thread())
                with _push_gauge_lock:
                    _push_inflight_total -= 1
                self._set_push_queue_gauge(own)

        global _push_inflight_total
        t = threading.Thread(target=contextvars.copy_context().run,
                             args=(push_and_account,), daemon=True,
                             name=f"cachepush-{cache_id}")
        with self._lock:
            self._pushes.append(t)
            depth = sum(1 for p in self._pushes if p.is_alive()) + 1
        with _push_gauge_lock:
            _push_inflight_total += 1
        self._set_push_queue_gauge(depth)
        t.start()

    def set_entry_packs(self, cache_id: str, packs: list) -> None:
        """Record the chunk -> pack mapping on an entry already written.
        A consumer racing the update sees an entry without packs and takes
        another route; never a broken hit."""
        with self._lock:
            raw = self._mem.get(cache_id)
        if raw in (None, EMPTY_ENTRY):
            return
        entry = json.loads(raw)
        entry["packs"] = packs
        new_raw = json.dumps(entry, separators=(",", ":"))
        with self._lock:
            self._mem[cache_id] = new_raw
        for attempt in range(_KV_RETRIES):
            try:
                self.kv.put(cache_id, new_raw)
                return
            except Exception as e:  # noqa: BLE001 - retried, then logged
                metrics.counter_add("makisu_cache_kv_retries_total",
                                    op="put")
                log.warning("cache KV pack update %s failed (try %d): "
                            "%s", cache_id, attempt + 1, e)

    def wait_for_push(self) -> None:
        """Join every push thread, each for at most PUSH_TIMEOUT_SECONDS
        (one still running then is logged and left behind)."""
        with self._lock:
            pending, self._pushes = self._pushes, []
        for t in pending:
            t.join(timeout=self.PUSH_TIMEOUT_SECONDS)
            if t.is_alive():
                metrics.counter_add("makisu_cache_push_timeouts_total")
                log.warning("cache push %s still running at timeout",
                            t.name)
        # Wedged pushes stay visible: they never left the aggregate.
        self._set_push_queue_gauge(sum(1 for t in pending
                                       if t.is_alive()))


class NoopCacheManager:
    """Cache disabled (reference: noopCacheManager :47-62)."""

    def pull_cache(self, cache_id: str) -> None:
        raise CacheMiss(cache_id)

    def push_cache(self, cache_id, pair, commit=None) -> None:
        pass

    def wait_for_push(self) -> None:
        pass

    def materialize_pending(self) -> None:
        pass  # no cache: every layer was committed locally
