"""Cache manager: map chained cache IDs to layers in the local store.

Copy of ``makisu_tpu/cache/manager.py`` for a local storage dir: entries
go to the KV store in the same JSON schema (``{tar, gzip, size, gz,
chunks}``), so makisu_tpu and this package read each other's entries.
The base route is a hit when the layer blob is in the local store,
whatever gzip backend wrote it (applying a layer only reads gzip). The
registry transfer plane is not part of the port yet, so a blob that is
not local materializes only through chunk dedup (``cache/chunks.py``).
Reference: lib/cache/cache_manager.go (mem-map + KV, 3 tries :116-182;
empty sentinel :35,144; noop impl :47-62).
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import threading

from makisu_tpu_torch import tario
from makisu_tpu_torch.chunker.hasher import LayerCommit
from makisu_tpu_torch.docker.image import (
    MEDIA_TYPE_LAYER,
    Descriptor,
    Digest,
    DigestPair,
)
from makisu_tpu_torch.utils import logging as log

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
    """(pair, chunks, gzip backend id, packs) of one entry. ``packs`` is
    what makisu_tpu's chunk dedup adds (empty from this package)."""
    if raw == EMPTY_ENTRY:
        return None, [], None, []
    entry = json.loads(raw)
    pair = DigestPair(
        tar_digest=Digest(entry["tar"]),
        gzip_descriptor=Descriptor(MEDIA_TYPE_LAYER, entry["size"],
                                   Digest(entry["gzip"])))
    return (pair, entry.get("chunks", []), entry.get("gz"),
            entry.get("packs", []))


def get_entry(manager, cache_id: str) -> tuple[str, DigestPair | None,
                                               list, str | None, list]:
    """Shared consult head of both pull routes (blob and chunk-aware):
    KV lookup and decode. Returns ``(raw, pair, chunks, gz_backend,
    packs)``; raises CacheMiss for an absent or undecodable entry."""
    raw = manager._get_raw(cache_id)
    if raw is None:
        raise CacheMiss(cache_id)
    try:
        pair, chunks, gz_backend, packs = decode_entry_full(raw)
    except (ValueError, KeyError, TypeError) as e:
        log.warning("cache entry %s undecodable (%s); treating as miss",
                    cache_id, e)
        raise CacheMiss(cache_id) from e
    return raw, pair, chunks, gz_backend, packs


class CacheManager:
    """Pulls/pushes layers keyed by cache ID through a KV store and the
    local image store."""

    def __init__(self, kv_store, image_store) -> None:
        self.kv = kv_store
        self.store = image_store
        self._mem: dict[str, str] = {}
        # Lazily materializable cache hits: gzip hex digest -> raw entry.
        # A hit served from chunks produces its blob only when an export
        # needs it (materialize_pending). MAKISU_TPU_LAZY_CACHE=0 makes
        # every such hit materialize at pull time.
        self._lazy: dict[str, str] = {}
        self._lock = threading.Lock()

    @staticmethod
    def lazy_enabled() -> bool:
        return os.environ.get("MAKISU_TPU_LAZY_CACHE", "1") == "1"

    def _get_raw(self, cache_id: str) -> str | None:
        """Entry lookup: build-local memory first, then the KV store.
        Raises CacheMiss when every KV attempt failed."""
        with self._lock:
            raw = self._mem.get(cache_id)
        if raw is not None:
            return raw
        for attempt in range(_KV_RETRIES):
            try:
                return self.kv.get(cache_id)
            except Exception as e:  # noqa: BLE001 - retried, then a miss
                log.warning("cache KV get %s failed (try %d): %s",
                            cache_id, attempt + 1, e)
        raise CacheMiss(cache_id)

    def pull_cache(self, cache_id: str) -> DigestPair | None:
        """Layer for this cache ID. Returns None for the EMPTY sentinel (a
        step known to commit nothing); raises CacheMiss when no usable
        entry exists."""
        _raw, pair, _chunks, _gz, _packs = get_entry(self, cache_id)
        if pair is None:
            return None
        hex_digest = pair.gzip_descriptor.digest.hex()
        if not self.store.layers.exists(hex_digest):
            log.info("cache hit %s but layer %s not local; ignoring",
                     cache_id, hex_digest)
            raise CacheMiss(cache_id)
        log.info("cache hit %s -> %s", cache_id, hex_digest)
        return pair

    # -- materialization (the lazy half of pull) --------------------------

    def materialize(self, hex_digest: str) -> str:
        """Path of the blob in the local store. Base route: the blob is
        local or this raises CacheMiss (no registry to fetch it from);
        chunk dedup puts reconstitution in front."""
        if self.store.layers.exists(hex_digest):
            return self.store.layers.path(hex_digest)
        raise CacheMiss(f"layer {hex_digest} not local and no registry "
                        "to materialize it from")

    def materialize_pending(self) -> None:
        """Materialize every deferred blob (``--dest`` needs the bytes of
        every layer)."""
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
                with gzip.GzipFile(fileobj=f, mode="rb") as gz:
                    yield gz

        return _open()

    def push_cache(self, cache_id: str,
                   pair: DigestPair | None,
                   commit: LayerCommit | None = None) -> None:
        """Record the mapping and write the KV entry; a KV failure is
        logged and never fails the build (reference :210-212)."""
        entry = encode_entry(pair, commit)
        with self._lock:
            self._mem[cache_id] = entry
        for attempt in range(_KV_RETRIES):
            try:
                self.kv.put(cache_id, entry)
                return
            except Exception as e:  # noqa: BLE001 - retried, then logged
                log.warning("cache KV put %s failed (try %d): %s",
                            cache_id, attempt + 1, e)

    def wait_for_push(self) -> None:
        pass  # pushes are synchronous


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
