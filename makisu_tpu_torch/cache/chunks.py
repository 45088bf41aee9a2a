"""Chunk-granular layer dedup, the local plane.

Copy of the local half of ``makisu_tpu/cache/chunks.py``. Every cache
entry written by the gpu hasher carries the layer's content-defined chunk
list (offset, length, sha256 of the uncompressed tar stream). After each
commit the layer is indexed into a chunk CAS at ``<storage>/chunks/``
(the reference's layout, ``<aa>/<hex>`` and ``_tmp``), so one storage dir
serves both builders. Because the gzip writer is deterministic
(``tario.gzip_writer`` pins mtime, filename and level), a layer blob is a
pure function of its chunk bytes: a cache hit whose blob is not local is
applied straight from the chunk stream (no blob, no gzip), and the blob
is rebuilt byte for byte only when an export needs it.

The registry half of the reference (chunk and pack push, pins, remote
and pack fetch), peer exchange, recipe publishing and the content
store's tier refetch are not part of the port yet.
"""

from __future__ import annotations

import contextlib
import gzip as gzip_mod
import hashlib
import os
import tempfile
import threading

from makisu_tpu_torch import tario
from makisu_tpu_torch.cache.manager import decode_entry_full, get_entry
from makisu_tpu_torch.chunker import cdc
from makisu_tpu_torch.docker.image import DigestPair
from makisu_tpu_torch.storage.cas import CASStore
from makisu_tpu_torch.utils import concurrency
from makisu_tpu_torch.utils import logging as log

Triple = tuple[int, int, str]  # (offset, length, hex sha256) of a chunk


def _skip(stream, nbytes: int) -> None:
    """Advance a non-seekable decompression stream by nbytes."""
    while nbytes > 0:
        step = stream.read(min(nbytes, 1 << 20))
        if not step:
            raise ValueError("layer stream truncated while seeking")
        nbytes -= len(step)


class _Pins:
    """In-process refcount of the chunks being read. The chunk CAS's
    eviction skips a pinned name, so a read in flight never loses its
    chunk to the entry-count cap."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}

    def pin(self, name: str) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + 1

    def unpin(self, name: str) -> None:
        with self._lock:
            n = self._counts.get(name, 0) - 1
            if n > 0:
                self._counts[name] = n
            else:
                self._counts.pop(name, None)

    def pinned(self, name: str) -> bool:
        with self._lock:
            return name in self._counts

    @contextlib.contextmanager
    def hold(self, name: str):
        self.pin(name)
        try:
            yield
        finally:
            self.unpin(name)


class ChunkStore:
    """CAS of uncompressed-stream chunks, keyed by hex sha256."""

    # Digests per pooled existence-probe task: one task per chunk would
    # put a submission back on every chunk (a 1 GiB layer is ~130k).
    PROBE_BATCH = 256

    # Sized so that the largest layer's chunks all stay (a 4 GiB layer is
    # ~500k chunks): a warm rebuild's coverage is whatever survived here.
    MAX_ENTRIES = 1 << 20

    def __init__(self, root: str, max_entries: int = MAX_ENTRIES) -> None:
        self.cas = CASStore(root, max_entries)
        self.pins = _Pins()
        self.cas.pin_check = self.pins.pinned
        # Existence memo streamed from the commit (note_fingerprint): the
        # dedup lookup, one CAS stat per chunk, runs on the commit pool
        # as fingerprints resolve instead of inside index_layer.
        self._exists_memo: dict[str, bool] = {}
        self._probe_queue: list[str] = []
        self._memo_gen = 0  # bumped by reset; stale probe batches discard
        self._memo_lock = threading.Lock()

    def has(self, hex_digest: str) -> bool:
        return self.cas.exists(hex_digest)

    # -- streamed existence prefetch --------------------------------------

    def note_fingerprint(self, hex_digest: str) -> None:
        """Chunk-fingerprint observer (``cdc.set_chunk_observer``): each
        digest is claimed in the memo and queued; every PROBE_BATCH
        digests one pool task stats them and records the hits. A tail
        shorter than a batch never probes (advisory: _exists_cached
        falls back to the stat). Thread-safe, never raises."""
        with self._memo_lock:
            if hex_digest in self._exists_memo:
                return
            self._exists_memo[hex_digest] = False  # claimed; stat fills
            self._probe_queue.append(hex_digest)
            if len(self._probe_queue) < self.PROBE_BATCH:
                return
            batch, self._probe_queue = self._probe_queue, []
            gen = self._memo_gen

        def probe(batch=batch, gen=gen) -> None:
            hits = [h for h in batch if self.cas.exists(h)]
            with self._memo_lock:
                if self._memo_gen != gen:
                    # reset_fingerprint_memo ran while this batch was
                    # queued: its hits belong to the previous window.
                    return
                for h in hits:
                    self._exists_memo[h] = True

        concurrency.hash_pool().submit(probe)

    def _exists_cached(self, hex_digest: str) -> bool:
        """index_layer's dedup probe: a memoized True skips the stat; any
        other answer stats (the commit may have stored the chunk since,
        for a digest repeated within one layer)."""
        with self._memo_lock:
            if self._exists_memo.get(hex_digest):
                return True
        return self.cas.exists(hex_digest)

    def reset_fingerprint_memo(self) -> None:
        """Drop the streamed memo. Runs after every index_layer: a
        memoized True must not outlive the commit that prefetched it, or
        eviction between layers could make index_layer skip storing a
        chunk it no longer holds."""
        with self._memo_lock:
            self._exists_memo.clear()
            self._probe_queue = []
            self._memo_gen += 1  # in-flight probe batches discard

    # -- chunk bytes --------------------------------------------------------

    def get(self, hex_digest: str) -> bytes:
        with self.pins.hold(hex_digest):
            with self.cas.open(hex_digest) as f:
                return f.read()

    def put(self, hex_digest: str, data: bytes) -> None:
        """Store one chunk after checking its bytes against its name (on
        the gpu hasher's path this re-checks every novel chunk's S1
        digest on the host)."""
        if hashlib.sha256(data).hexdigest() != hex_digest:
            raise ValueError(f"chunk content does not match {hex_digest}")
        self.cas.write_bytes(hex_digest, data)

    def index_layer(self, layer_blob_path: str,
                    chunks: list[Triple]) -> list[str]:
        """Slice a layer's uncompressed stream into its chunks and store
        the ones not held yet. Returns the digests newly added.

        One forward pass over the gzip stream (the chunk list is
        offset-sorted), so memory stays bounded by the largest chunk;
        then a drain to EOF, so the gzip trailer's CRC and size are
        checked and a corrupt blob fails here."""
        added: list[str] = []
        with open(layer_blob_path, "rb") as raw:
            stream = gzip_mod.GzipFile(fileobj=raw, mode="rb")
            pos = 0
            for offset, length, hex_digest in chunks:
                if offset < pos:
                    raise ValueError(
                        f"chunk list not offset-sorted at {offset} < {pos}")
                _skip(stream, offset - pos)
                data = stream.read(length)
                pos = offset + len(data)
                if len(data) != length:
                    raise ValueError(
                        f"layer stream ended at {pos}, chunk needs "
                        f"{offset + length}")
                if self._exists_cached(hex_digest):
                    continue
                self.put(hex_digest, data)
                added.append(hex_digest)
            while stream.read(1 << 20):
                pass
        return added

    def ensure_available(self, chunks: list[Triple]) -> bool:
        """True when every chunk of the list is in the local CAS: one stat
        per distinct digest (a digest repeated at several offsets counts
        once)."""
        distinct = dict.fromkeys(h for _, _, h in chunks)
        missing = [h for h in distinct if not self.cas.exists(h)]
        if missing:
            log.debug("%d of %d distinct chunks missing locally",
                      len(missing), len(distinct))
        return not missing

    def coverage(self, chunks: list[Triple]) -> float:
        """Fraction of the layer's bytes present as local chunks."""
        total = sum(length for _, length, _ in chunks)
        if total == 0:
            return 1.0
        have = sum(length for _, length, hex_digest in chunks
                   if self.cas.exists(hex_digest))
        return have / total

    # -- reconstitution -----------------------------------------------------

    def reconstitute_to_path(self, pair: DigestPair, chunks: list[Triple],
                             gz_backend: str | None = None) -> str | None:
        """Rebuild a layer blob from chunks into a temp file beside the
        CAS and check both digests. Returns the temp path (the caller
        owns it) or None if a chunk is missing, the list has a gap or a
        digest differs.

        Chunk bytes stream through the deterministic gzip writer in
        pieces of at most 1 MiB with both digests updated as they go, so
        memory is bounded by the piece, never by the layer."""
        if gz_backend is not None and not tario.backend_id_usable(
                gz_backend):
            # Byte identity is out of reach without the producing
            # compressor: report "cannot reconstitute".
            log.warning("cannot reconstitute %s: gzip backend %r not "
                        "usable here", pair.gzip_descriptor.digest,
                        gz_backend)
            return None
        tar_digest = hashlib.sha256()
        pos = 0
        # Beside the chunk CAS, not in $TMPDIR (often tmpfs): the blob
        # hits disk once and the layer store can hardlink it.
        fd, tmp = tempfile.mkstemp(prefix="reconstitute-",
                                   dir=self.cas._tmp_dir)
        try:
            with os.fdopen(fd, "wb") as raw:
                tee = tario.TeeDigest(raw)
                gz = tario.gzip_writer(tee, backend_id=gz_backend)
                failed = False
                try:
                    for offset, length, hex_digest in chunks:
                        if offset != pos:
                            log.warning("chunk list has a gap at %d "
                                        "(expected %d)", offset, pos)
                            failed = True
                            break
                        if not self._copy_chunk(hex_digest, length,
                                                tar_digest, gz):
                            failed = True
                            break
                        pos = offset + length
                    if (not failed and tar_digest.hexdigest()
                            != pair.tar_digest.hex()):
                        log.warning("reconstituted stream digest mismatch "
                                    "for %s", pair.tar_digest)
                        failed = True
                finally:
                    # Always close: an unclosed compressor would write at
                    # collection time after raw is gone.
                    gz.close()
            if failed:
                return None
            if tee.digest.hexdigest() != pair.gzip_descriptor.digest.hex():
                log.warning("reconstituted gzip digest mismatch for %s "
                            "(compression settings differ?)",
                            pair.gzip_descriptor.digest)
                return None
            keep, tmp = tmp, None
            return keep
        finally:
            if tmp is not None:
                os.unlink(tmp)

    def _copy_chunk(self, hex_digest: str, length: int, tar_digest,
                    gz) -> bool:
        """Stream one chunk into the tar digest and the gzip writer in
        pieces of at most 1 MiB. False if it is missing or shorter than
        ``length``. The open is the existence check: one syscall a chunk,
        ~130k of them for a 1 GiB layer."""
        with self.pins.hold(hex_digest):
            try:
                f = self.cas.open(hex_digest)
            except FileNotFoundError:
                log.warning("chunk %s missing", hex_digest)
                return False
            with f:
                remaining = length
                while remaining > 0:
                    piece = f.read(min(remaining, 1 << 20))
                    if not piece:
                        log.warning("chunk %s shorter than its recorded "
                                    "length", hex_digest)
                        return False
                    tar_digest.update(piece)
                    gz.write(piece)
                    remaining -= len(piece)
        return True

    def reconstitute(self, pair: DigestPair, chunks: list[Triple],
                     gz_backend: str | None = None) -> bytes | None:
        """Bytes-returning form of reconstitute_to_path (tests and small
        layers; the cache route links the file instead)."""
        path = self.reconstitute_to_path(pair, chunks, gz_backend)
        if path is None:
            return None
        try:
            with open(path, "rb") as f:
                return f.read()
        finally:
            os.unlink(path)

    def open_stream(self, chunks: list[Triple]):
        """Readable file-like over the layer's uncompressed tar stream,
        served chunk by chunk from the local CAS: a layer whose chunks
        are local applies with no gzip work at all. Memory is bounded by
        one 1 MiB read; a gap, a short chunk or a missing chunk raises."""
        return _ChunkStream(self, chunks)


class _ChunkStream:
    """``ChunkStore.open_stream``'s reader. One chunk is pinned at a
    time, the one under the cursor."""

    def __init__(self, store: ChunkStore, chunks: list[Triple]) -> None:
        self._store = store
        self._chunks = list(chunks)
        self._idx = 0
        self._fh = None
        self._remaining = 0
        self._pos = 0
        self._pinned: str | None = None

    def _pin(self, hex_digest: str | None) -> None:
        if self._pinned is not None:
            self._store.pins.unpin(self._pinned)
        self._pinned = hex_digest
        if hex_digest is not None:
            self._store.pins.pin(hex_digest)

    def _advance(self) -> bool:
        while self._idx < len(self._chunks):
            offset, length, hex_digest = self._chunks[self._idx]
            self._idx += 1
            if offset != self._pos:
                raise ValueError(f"chunk list has a gap at {offset} "
                                 f"(expected {self._pos})")
            if length == 0:
                continue
            self._pin(hex_digest)
            # Open directly: ~130k chunks a GiB, so the happy path costs
            # one syscall, not a stat and an open.
            try:
                self._fh = self._store.cas.open(hex_digest)
            except FileNotFoundError:
                self._pin(None)
                raise FileNotFoundError(
                    f"chunk {hex_digest} unavailable") from None
            self._remaining = length
            return True
        self._pin(None)
        return False

    def read(self, n: int = -1) -> bytes:
        out = []
        want = n if n >= 0 else None
        while want is None or want > 0:
            if self._remaining == 0:
                if self._fh is not None:
                    self._fh.close()
                    self._fh = None
                if not self._advance():
                    break
            step = self._remaining if want is None else min(
                want, self._remaining)
            piece = self._fh.read(min(step, 1 << 20))
            if not piece:
                raise ValueError("chunk shorter than its recorded length")
            out.append(piece)
            self._remaining -= len(piece)
            self._pos += len(piece)
            if want is not None:
                want -= len(piece)
        return b"".join(out)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._pin(None)

    def __enter__(self) -> "_ChunkStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _index_fields(triples: list[Triple], added: list[str]) -> dict:
    """Dedup accounting of one indexed layer: how many of its bytes were
    new to the CAS and how many were already held."""
    bytes_total = sum(n for _, n, _ in triples)
    lengths: dict[str, int] = {}
    for _, n, h in triples:
        lengths.setdefault(h, n)
    bytes_added = sum(lengths[h] for h in set(added))
    return {"chunks": len(triples), "added": len(added),
            "bytes_total": bytes_total, "bytes_added": bytes_added,
            "bytes_reused": bytes_total - bytes_added}


def attach_chunk_dedup(manager, chunk_root: str) -> ChunkStore:
    """Wire a ChunkStore into a CacheManager: index every committed
    layer's chunks on push, serve a hit whose blob is not local from
    chunks, and rebuild the blob from chunks when it is materialized."""
    chunk_store = ChunkStore(chunk_root)
    inner_push = manager.push_cache
    inner_pull = manager.pull_cache
    inner_materialize = manager.materialize
    inner_open_tar = manager.open_layer_tar

    def push_cache(cache_id, pair, commit=None):
        inner_push(cache_id, pair, commit)
        if pair is None or commit is None or not commit.chunks:
            return
        triples = [(c.offset, c.length, c.hex_digest) for c in commit.chunks]
        layer_hex = pair.gzip_descriptor.digest.hex()
        try:
            path = manager.store.layers.path(layer_hex)
            added = chunk_store.index_layer(path, triples)
        except FileNotFoundError:
            return
        finally:
            # The streamed memo served exactly this commit-to-index
            # window; a True must not survive into the next layer's.
            chunk_store.reset_fingerprint_memo()
        log.info("indexed %d new chunks for %s", len(added), cache_id,
                 **_index_fields(triples, added))

    def pull_cache(cache_id):
        """Chunk-aware pull: the chunk route first when the blob is not
        local, then the base blob route. A chunk-route hit is a promise
        the build keeps (execution is skipped), so it is accepted only
        when every chunk is local and the entry's gzip backend can be
        replayed here byte for byte."""
        raw, pair, chunks, gz_backend, _packs = get_entry(manager, cache_id)
        if pair is None:
            return None
        hex_digest = pair.gzip_descriptor.digest.hex()
        if not manager.store.layers.exists(hex_digest) and chunks:
            if not tario.backend_id_usable(gz_backend):
                log.info("cache hit %s: gzip backend %r not replayable "
                         "here; trying the blob route", cache_id,
                         gz_backend)
            elif chunk_store.ensure_available([tuple(c) for c in chunks]):
                with manager._lock:
                    manager._lazy[hex_digest] = raw
                log.info("cache hit %s -> %s (lazy: %d chunks "
                         "available)", cache_id, hex_digest, len(chunks))
                if not manager.lazy_enabled():
                    # MAKISU_TPU_LAZY_CACHE=0 restores eager
                    # materialization on the chunk route too.
                    manager.materialize(hex_digest)
                return pair
            else:
                log.info("cache hit %s: chunks incomplete; trying the "
                         "blob route", cache_id)
        # The blob route re-reads the entry: seed the build-local memory
        # so the fall-through costs no second KV read.
        with manager._lock:
            manager._mem.setdefault(cache_id, raw)
        return inner_pull(cache_id)

    def _lazy_entry(hex_digest):
        with manager._lock:
            raw = manager._lazy.get(hex_digest)
        if raw is None:
            return None, None, None, None
        return decode_entry_full(raw)

    def materialize(hex_digest):
        """Reconstitution from chunks first, then the base route."""
        if manager.store.layers.exists(hex_digest):
            return manager.store.layers.path(hex_digest)
        pair, chunks, gz_backend, _packs = _lazy_entry(hex_digest)
        if pair is not None and chunks:
            path = chunk_store.reconstitute_to_path(
                pair, [tuple(c) for c in chunks], gz_backend=gz_backend)
            if path is not None:
                try:
                    manager.store.layers.link_file(hex_digest, path)
                finally:
                    os.unlink(path)
                with manager._lock:
                    manager._lazy.pop(hex_digest, None)
                log.info("reconstituted layer %s from %d cached chunks",
                         hex_digest, len(chunks))
                return manager.store.layers.path(hex_digest)
        return inner_materialize(hex_digest)

    def open_layer_tar(pair):
        """The uncompressed tar straight from chunks when the blob is not
        local (no blob, no gzip), else the base route. Availability is
        settled before the stream opens: application mutates the tree as
        it reads, so the stream must be a sure thing."""
        hex_digest = pair.gzip_descriptor.digest.hex()
        if not manager.store.layers.exists(hex_digest):
            _, chunks, _, _ = _lazy_entry(hex_digest)
            if chunks:
                triples = [tuple(c) for c in chunks]
                if chunk_store.ensure_available(triples):

                    @contextlib.contextmanager
                    def _chunk_tar():
                        log.info("applying layer %s from %d chunks "
                                 "(no blob, no gzip)", hex_digest,
                                 len(triples))
                        with chunk_store.open_stream(triples) as stream:
                            yield stream

                    return _chunk_tar()
                log.info("layer %s chunks incomplete locally; falling "
                         "back to blob materialization", hex_digest)
        return inner_open_tar(pair)

    manager.push_cache = push_cache
    manager.pull_cache = pull_cache
    manager.materialize = materialize
    manager.open_layer_tar = open_layer_tar
    manager.chunk_store = chunk_store
    if concurrency.hash_workers() > 1:
        # Stream the dedup lookups: the chunk session reports each
        # fingerprint (context-scoped, so concurrent builds see only
        # their own), and the CAS stats index_layer needs run on the
        # pool before push_cache re-reads the layer.
        cdc.set_chunk_observer(chunk_store.note_fingerprint)
    return chunk_store
