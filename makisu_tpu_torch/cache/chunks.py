"""Chunk-granular layer dedup: the local plane and the registry plane.

Copy of ``makisu_tpu/cache/chunks.py`` with its telemetry (the index's
dedup accounting, the fetch counters and events, the ``chunk_cas`` and
``chunk_index`` ledger decisions, the chunk-route hits). Every cache
entry written by the gpu hasher carries the layer's content-defined chunk
list (offset, length, sha256 of the uncompressed tar stream). After each
commit the layer is indexed into a chunk CAS at ``<storage>/chunks/``
(the reference's layout, ``<aa>/<hex>`` and ``_tmp``), so one storage dir
serves both builders. Because the gzip writers are deterministic
(``tario.gzip_writer`` pins mtime, filename, level and, for pgzip, the
block size), a layer blob is a pure function of its chunk bytes: a cache
hit whose blob is not local is applied straight from the chunk stream
(no blob, no gzip), and the blob is rebuilt byte for byte only when an
export or an upload needs it.

With a registry client the chunks also travel between builders: after
each index the layer's new chunks are pushed as pack blobs (about 8 MB
of concatenated chunk bytes each), pinned against registry GC by tagged
manifests, and the chunk -> pack map is recorded on the cache entry; a
builder missing chunks fetches only the spans it needs out of those
packs (HTTP Range runs, or whole packs when most of one is needed).

The service half: every attached store registers as a serving store
(``open_served_chunk``, the worker's ``GET /chunks/<fp>`` and the serve
plane's pack synthesis read through it); a process that serves
publishes each indexed layer's signed recipe and pack tables on a
background thread (``serve/recipe.py``); and ``ensure_available`` asks
the fleet's peers (``fleet/peers.py``: the layer's recipe and ranged
pack reads first, then one chunk per GET) before the registry. Reads
pin their chunk on the content store's board for the storage dir
(``storage/contentstore.py``), shared by every store of that root in
the process, so a pack range served to a peer, a build's own reads and
the budget evictor see the same pins. A missing chunk first tries the
content store's tier refetch (its pack's local seekable-zstd twin, or
the remote tier), then the peers, then the registry.
"""

from __future__ import annotations

import contextlib
import contextvars
import gzip as gzip_mod
import hashlib
import json
import math
import os
import tempfile
import threading
import time

from makisu_tpu_torch import tario
from makisu_tpu_torch.cache.manager import decode_entry_full, get_entry
from makisu_tpu_torch.docker.image import (
    MEDIA_TYPE_CONFIG,
    Descriptor,
    Digest,
    DigestPair,
    DistributionManifest,
)
from makisu_tpu_torch.registry import transfer
from makisu_tpu_torch.storage import contentstore
from makisu_tpu_torch.storage.cas import CASStore
from makisu_tpu_torch.utils import concurrency, events, ledger, metrics
from makisu_tpu_torch.utils import logging as log
from makisu_tpu_torch.utils.httputil import HTTPError

Triple = tuple[int, int, str]  # (offset, length, hex sha256) of a chunk

# Chunk blobs carry their own media type in pin manifests (raw
# uncompressed tar-stream slices, not gzip layers).
CHUNK_MEDIA_TYPE = "application/vnd.makisu-tpu.chunk.v1"

# A pack is the wire form of many chunks: the concatenation of a layer's
# newly added chunk bytes, carved back into chunks by the consumer. One
# request per ~8 MB instead of one per ~8 KiB chunk; the local CAS keeps
# chunk granularity.
PACK_MEDIA_TYPE = "application/vnd.makisu-tpu.chunkpack.v1"

# Blobs per pin manifest: ~140 bytes a descriptor keeps one manifest near
# 2.8 MB, under distribution's 4 MiB payload cap.
PIN_SHARD_CHUNKS = 20_000

# The dedup probes list a CAS shard directory once a window has sent it
# list_shard_at(names) digests, where ``names`` is how many the store's
# last listing of a shard held; below that each probe stats. A listing
# pays for itself once it spares listdir / lstat stats, and a listdir
# grows with the shard. On an H100 host whose root is 9p (gVisor), one
# shard listdir (into a set) took 125, 274, 843, 3,318, 15,235 and
# 79,263 us at 16, 67, 256, 1,024, 4,096 and 16,384 names, an existence
# stat 74 us (hit; 38 a miss): about 60 us + 3.7 us a name. So a shard
# the size of a 256 MiB layer's fresh CAS (~67) lists at 5 digests, and
# one of a full chunk CAS (MAX_ENTRIES / 256) at 206.
_LIST_BASE_US = 60.0
_LIST_NAME_US = 3.7
_STAT_US = 74.0


def list_shard_at(names: int) -> int:
    """Digests a window sends a CAS shard of about ``names`` entries
    before its probes answer from one listing of it."""
    return max(1, math.ceil(
        (_LIST_BASE_US + _LIST_NAME_US * names) / _STAT_US))


def packs_enabled() -> bool:
    """MAKISU_TPU_CHUNK_PACKS=0 pushes each chunk as its own blob."""
    return os.environ.get("MAKISU_TPU_CHUNK_PACKS", "1") == "1"


def pack_target_bytes() -> int:
    """Target pack size (MAKISU_TPU_PACK_TARGET_MB, default 8 MB),
    floored at 1 MB: a target under the chunk size would make one pack
    per chunk."""
    try:
        target = int(float(os.environ.get(
            "MAKISU_TPU_PACK_TARGET_MB", "8")) * 1e6)
    except ValueError:
        return 8_000_000
    return max(target, 1_000_000)


def plan_pack_runs(rows, missing, gap=None, whole_fraction=None,
                   pack_sizes=None):
    """Group the missing chunks' pack spans into coalesced fetch runs.

    ``rows`` are ``(fp, length, pack_hex, pack_off)`` rows; returns
    ``(run_jobs, whole_jobs)``: ``run_jobs`` is ``[(pack_hex, [run,
    ...])]`` with each run a sorted list of ``(pack_off, length, fp)``
    spans whose gaps are at most ``gap``; ``whole_jobs`` names the packs
    worth fetching whole (needed bytes over ``whole_fraction`` of the
    pack's known extent; ``-1`` forces every pack whole)."""
    if gap is None:
        gap = ChunkStore.PACK_RUN_GAP
    if whole_fraction is None:
        whole_fraction = ChunkStore.PACK_WHOLE_FETCH_FRACTION
    by_pack: dict[str, dict[str, tuple[int, int]]] = {}
    extents: dict[str, int] = dict(pack_sizes or {})
    for fp, length, pack_hex, pack_off in rows:
        extents[pack_hex] = max(extents.get(pack_hex, 0),
                                int(pack_off) + int(length))
        if fp in missing:
            by_pack.setdefault(pack_hex, {}).setdefault(
                fp, (int(pack_off), int(length)))
    run_jobs: list[tuple[str, list]] = []
    whole_jobs: list[str] = []
    for pack_hex, wanted in sorted(by_pack.items()):
        spans = sorted((off, length, fp)
                       for fp, (off, length) in wanted.items())
        needed = sum(length for _, length, _ in spans)
        if needed > extents[pack_hex] * whole_fraction:
            whole_jobs.append(pack_hex)
            continue
        runs: list[list] = []
        for span in spans:
            if (runs and span[0] - (runs[-1][-1][0] + runs[-1][-1][1])
                    <= gap):
                runs[-1].append(span)
            else:
                runs.append([span])
        run_jobs.append((pack_hex, runs))
    return run_jobs, whole_jobs


def _count_probes(routes: list) -> None:
    """Flush a [listing, stat] tally of existence answers."""
    for route, n in zip(("listing", "stat"), routes):
        if n:
            metrics.counter_add(metrics.CHUNK_PROBES, n, route=route)


# -- the process-wide serving registry (the worker's GET /chunks/<fp>) ------

# Every ChunkStore attached in this process, keyed by its CAS root: the
# peer endpoints serve chunk bytes out of whichever store holds them.
# Re-attaching a root replaces its entry, so the registry grows with the
# number of storage roots, never with builds.
_serving_stores: dict[str, "ChunkStore"] = {}
_serving_lock = threading.Lock()


def register_serving_store(store: "ChunkStore") -> None:
    key = os.path.realpath(store.cas.root)
    with _serving_lock:
        _serving_stores[key] = store


def serving_stores() -> list["ChunkStore"]:
    with _serving_lock:
        return list(_serving_stores.values())


def open_served_chunk(hex_digest: str, roots=None):
    """Open ``hex_digest`` from a registered store: an open file object,
    or None. The local CAS only: serving a peer never triggers a remote
    fetch of our own (a fleet proxying misses onward would turn one cold
    chunk into N registry round trips). ``roots`` (realpath'd CAS roots)
    scopes the lookup to the stores one worker owns: in-process workers
    share this registry, and serving a sibling's bytes would fake the
    cross-host exchange."""
    for store in serving_stores():
        if roots is not None \
                and os.path.realpath(store.cas.root) not in roots:
            continue
        try:
            return store.cas.open(hex_digest)
        except FileNotFoundError:
            continue
    return None


def plan_frame_runs(frames, spans, gap=None):
    """Map one pack's missing raw spans onto its seekable-zstd frame
    index: the frames to fetch, coalesced into ranged runs over the
    compressed bytes (beside ``plan_pack_runs``: one definition of
    ranged-fetch economics for the serve client and the peer plane).
    ``frames`` are ``(raw_off, raw_len, z_off, z_len)`` rows (a recipe's
    ``zpacks`` entry), ``spans`` ``(raw_off, length, fp)`` missing spans
    of the pack. Returns runs, each a list of frame rows whose compressed
    extents lie within ``gap`` bytes of each other."""
    import bisect
    if gap is None:
        gap = ChunkStore.PACK_RUN_GAP
    rows = sorted([int(r[0]), int(r[1]), int(r[2]), int(r[3])]
                  for r in frames)
    starts = [r[0] for r in rows]
    needed: set[int] = set()
    for off, length, _fp in spans:
        end = int(off) + int(length)
        i = max(bisect.bisect_right(starts, int(off)) - 1, 0)
        while i < len(rows) and rows[i][0] < end:
            if rows[i][0] + rows[i][1] > int(off):
                needed.add(i)
            i += 1
    runs: list[list] = []
    for i in sorted(needed):
        row = rows[i]
        if runs and row[2] - (runs[-1][-1][2] + runs[-1][-1][3]) <= gap:
            runs[-1].append(row)
        else:
            runs.append([row])
    return runs


class _ShardListing:
    """One window's names of one CAS shard: a single ``listdir``, plus
    the chunks the store wrote there meanwhile. ``ready`` is set once
    the listing has landed; ``ok`` is False where it failed, and that
    shard's probes stat. ``removals`` is the CAS's removal count read
    before the ``listdir``: once it moves, a listed name may be gone."""

    __slots__ = ("shard", "names", "ready", "ok", "removals")

    def __init__(self, shard: str) -> None:
        self.shard = shard
        self.names: set[str] = set()
        self.ready = threading.Event()
        self.ok = False
        self.removals = 0


class ChunkStore:
    """CAS of uncompressed-stream chunks, keyed by hex sha256.

    With a registry client attached (``set_remote``), chunks also ride
    the registry's blob plane: new chunks push as packs after each index,
    and missing chunks fetch from packs (or as single blobs) on demand.
    """

    # Digests per pooled existence-probe task: one task per chunk would
    # put a submission back on every chunk (a 1 GiB layer is ~130k).
    PROBE_BATCH = 256

    # index_layer's read size from the layer's gzip stream: a read per
    # chunk (~8 KiB) costs its Python once per chunk, when ~99% of a
    # rebuilt layer's chunks are held and need no bytes at all.
    INDEX_READ_BLOCK = 1 << 20

    # Sized so that the largest layer's chunks all stay (a 4 GiB layer is
    # ~500k chunks): a warm rebuild's coverage is whatever survived here.
    MAX_ENTRIES = 1 << 20

    def __init__(self, root: str, max_entries: int = MAX_ENTRIES) -> None:
        self.cas = CASStore(root, max_entries)
        # Reads pin their chunk for their duration on the content
        # store's board for this storage dir, which the budget evictor,
        # the CAS's own count-LRU and the serve plane all share.
        self.pins = contentstore.board_for_chunk_root(root)
        self.cas.pin_check = self.pins.chunk_pinned
        # Existence memo streamed from the commit (note_fingerprint): the
        # dedup lookup runs on the commit pool as fingerprints resolve
        # instead of inside index_layer.
        self._exists_memo: dict[str, bool] = {}
        self._probe_queue: list[str] = []
        self._memo_gen = 0  # bumped by reset; stale probe batches discard
        self._memo_lock = threading.Lock()
        # Per window, beside the memo: the distinct digests sent to each
        # CAS shard, and the shards listed once that count reached
        # list_shard_at (their probes answer from the listing).
        self._shard_demand: dict[str, int] = {}
        self._listings: dict[str, _ShardListing] = {}
        # Names in the last shard this store listed, in any window: the
        # size of every shard, since digests spread evenly over them.
        self._shard_names = 0
        self.registry = None  # attach with set_remote()

    def set_remote(self, layer_client) -> None:
        """Attach a registry client: chunk and pack blobs transfer
        straight into this CAS (the layer client lends its registry,
        repository, config, transport and redirect policy)."""
        if layer_client is None:
            self.registry = None
            return
        from makisu_tpu_torch.registry.client import RegistryClient

        class _CASOnlyStore:
            """Just enough ImageStore surface for blob transfers."""

            def __init__(self, cas) -> None:
                self.layers = cas

        self.registry = RegistryClient(
            _CASOnlyStore(self.cas), layer_client.registry,
            layer_client.repository, config=layer_client.config,
            transport=layer_client.transport)
        # An explicit transport would pin cross-origin redirects to it;
        # keep the layer client's own redirect policy instead.
        self.registry.cdn_transport = layer_client.cdn_transport

    def has(self, hex_digest: str) -> bool:
        if self.cas.exists(hex_digest):
            return True
        # A demoted chunk comes back from its pack's compressed twin (or
        # the remote tier) before the registry is asked: a local
        # decompress beats a round trip, and it is the only route when
        # no registry is attached.
        if contentstore.refetch_for_chunk_root(
                self.cas.root, [hex_digest], {}, put=self.put):
            return True
        if self.registry is not None:
            return self._fetch_remote(hex_digest)
        return False

    # -- streamed existence prefetch --------------------------------------

    def note_fingerprint(self, hex_digest: str) -> None:
        """Chunk-fingerprint observer (``cdc.set_chunk_observer``): each
        digest is claimed in the memo and queued; every PROBE_BATCH
        digests one pool task answers them (``_probe_batch``) and
        records the hits. A tail shorter than a batch never probes
        (advisory: _exists_cached answers it). Thread-safe, never
        raises."""
        with self._memo_lock:
            if not self._claim_locked(hex_digest):
                return
            self._probe_queue.append(hex_digest)
            if len(self._probe_queue) < self.PROBE_BATCH:
                return
            batch, self._probe_queue = self._probe_queue, []
            gen = self._memo_gen
        # The batch counts its answers into the build's registry.
        ctx = contextvars.copy_context()

        def probe() -> None:
            ctx.run(self._probe_batch, batch, gen)

        concurrency.hash_pool().submit(probe)

    def _claim_locked(self, hex_digest: str) -> bool:
        """Claim a digest for this window (memo False until an answer
        fills it) and count it against its shard; False where it was
        claimed already. Under ``_memo_lock``."""
        if hex_digest in self._exists_memo:
            return False
        self._exists_memo[hex_digest] = False
        shard = self.cas.shard(hex_digest)
        self._shard_demand[shard] = self._shard_demand.get(shard, 0) + 1
        return True

    def _probe_batch(self, batch: list[str], gen: int) -> None:
        """One pool task: answer a batch and record its hits. Each digest
        looks at its shard's count when its turn comes (the commit goes
        on noting meanwhile); the batch stops where
        reset_fingerprint_memo ended its window (its answers belong to
        the previous window)."""
        routes = [0, 0]  # [listing, stat]
        hits = []
        for h in batch:
            with self._memo_lock:
                if self._memo_gen != gen:
                    break
                listing, mine = self._listing_locked(h, gen)
            if mine:
                self._fill_listing(listing)
            if self._answer(h, listing, routes):
                hits.append(h)
        with self._memo_lock:
            if self._memo_gen == gen:
                for h in hits:
                    self._exists_memo[h] = True
        _count_probes(routes)

    def _listing_locked(self, hex_digest: str,
                        gen: int) -> tuple[_ShardListing | None, bool]:
        """The window's listing of the digest's shard, and whether the
        caller just claimed it (and must fill it). None where the shard
        has been sent fewer digests than ``list_shard_at`` asks of a
        shard its size, or ``gen`` is not the current window: the probe
        stats. Under ``_memo_lock``."""
        shard = self.cas.shard(hex_digest)
        listing = self._listings.get(shard)
        if listing is not None:
            return listing, False
        if self._memo_gen != gen or self._shard_demand.get(shard, 0) \
                < list_shard_at(self._shard_names):
            return None, False
        listing = self._listings[shard] = _ShardListing(shard)
        return listing, True

    def _fill_listing(self, listing: _ShardListing) -> None:
        """List the shard of a listing this thread claimed, outside
        every lock; waiters wake even where the listing fails."""
        try:
            removals = self.cas.removals()
            names = self.cas.list_shard(listing.shard)
            with self._memo_lock:
                listing.names |= names
                listing.removals = removals
                listing.ok = True
                self._shard_names = len(names)
            metrics.counter_add(metrics.CHUNK_SHARD_LISTINGS)
        except OSError as e:
            log.debug("chunk shard %s not listed: %s", listing.shard, e)
        finally:
            listing.ready.set()

    def _answer(self, hex_digest: str, listing: _ShardListing | None,
                routes: list) -> bool:
        """Whether the chunk is stored: from its shard's listing where
        there is one (a name missing from it is a miss; a hit records
        its access, as a stat does), else a stat. A hit stats instead
        once an entry has left the CAS since the listing was read.
        Counts the route into ``routes`` ([listing, stat])."""
        if listing is not None:
            listing.ready.wait()
            listed = hex_digest in listing.names
            if listing.ok and (not listed or self.cas.touch_listed(
                    hex_digest, listing.removals)):
                routes[0] += 1
                return listed
        routes[1] += 1
        return self.cas.exists(hex_digest)

    def _exists_cached(self, hex_digest: str, gen: int, tally: list,
                       routes: list) -> bool:
        """index_layer's dedup probe of one digest: a memoized True is
        the answer; any other is answered now, from the shard's listing
        or a stat. ``tally`` ([memo hits, answers]) and ``routes``
        ([listing, stat]) are flushed by the caller once per layer,
        never per chunk."""
        with self._memo_lock:
            if self._exists_memo.get(hex_digest):
                tally[0] += 1
                return True
            listing, mine = self._listing_locked(hex_digest, gen)
        tally[1] += 1
        if mine:
            self._fill_listing(listing)
        return self._answer(hex_digest, listing, routes)

    def reset_fingerprint_memo(self) -> None:
        """Drop the streamed memo and the window's shard listings. Runs
        after every index_layer: a True must not outlive the commit that
        read it, or eviction between layers could make index_layer skip
        storing a chunk it no longer holds."""
        with self._memo_lock:
            self._exists_memo.clear()
            self._probe_queue = []
            self._shard_demand = {}
            self._listings = {}
            self._memo_gen += 1  # in-flight probe batches discard

    # -- the registry plane -------------------------------------------------

    def push_remote(self, hex_digest: str) -> None:
        if self.registry is not None:
            self.registry.push_layer(Digest.from_hex(hex_digest))

    def pin_remote(self, layer_hex: str, chunks: list[Triple]) -> None:
        """Tag manifests referencing every chunk blob of a layer, so the
        registry's GC keeps them (``makisu-chunks-<layer>[-<shard>]``,
        sharded under the manifest size cap). Deleting the tags un-pins
        them."""
        if self.registry is None or not chunks:
            return
        self._pin_shards(layer_hex,
                         [(length, hex_digest)
                          for _, length, hex_digest in chunks],
                         CHUNK_MEDIA_TYPE, "makisu-chunks")

    def _pin_shards(self, layer_hex: str, blobs: list[tuple[int, str]],
                    media_type: str, tag_prefix: str) -> None:
        """Tag one or more manifests referencing ``blobs`` ((length, hex)
        pairs) under a config blob that names the pinned layer."""
        config_blob = json.dumps({"makisuTpuChunkPin": layer_hex},
                                 separators=(",", ":")).encode()
        config_hex = hashlib.sha256(config_blob).hexdigest()
        if not self.cas.exists(config_hex):
            self.cas.write_bytes(config_hex, config_blob)
        self.registry.push_layer(Digest.from_hex(config_hex))
        config_desc = Descriptor(MEDIA_TYPE_CONFIG, len(config_blob),
                                 Digest.from_hex(config_hex))
        for shard_index, start in enumerate(
                range(0, len(blobs), PIN_SHARD_CHUNKS)):
            shard = blobs[start:start + PIN_SHARD_CHUNKS]
            manifest = DistributionManifest(
                config=config_desc,
                layers=[Descriptor(media_type, length,
                                   Digest.from_hex(hex_digest))
                        for length, hex_digest in shard])
            tag = f"{tag_prefix}-{layer_hex[:40]}"
            if start:
                tag += f"-{shard_index}"
            self._push_pin_manifest(tag, manifest, shard)

    def _push_pin_manifest(self, tag: str, manifest, shard) -> None:
        try:
            self.registry.push_manifest(tag, manifest)
        except HTTPError as e:
            # BLOB_UNKNOWN: blobs reused from earlier layers were never
            # pushed to this repository. Upload them (existing ones
            # HEAD-skip) and retry once; any other error cannot be fixed
            # by pushing blobs.
            if b"BLOB_UNKNOWN" not in e.body:
                raise
            for _, hex_digest in shard:
                self.push_remote(hex_digest)
            self.registry.push_manifest(tag, manifest)

    def _fetch_remote(self, hex_digest: str) -> bool:
        try:
            self.registry.pull_layer(Digest.from_hex(hex_digest))
        except Exception as e:  # noqa: BLE001 - remote miss or network
            log.debug("remote chunk %s unavailable: %s", hex_digest, e)
            return False
        # pull_layer checked the bytes against the digest before linking.
        return self.cas.exists(hex_digest)

    # -- chunk bytes --------------------------------------------------------

    def get(self, hex_digest: str) -> bytes:
        with self.pins.pinned("chunks", hex_digest):
            with self.cas.open(hex_digest) as f:
                return f.read()

    def put(self, hex_digest: str, data: bytes) -> None:
        """Store one chunk after checking its bytes against its name (on
        the gpu hasher's path this re-checks every novel chunk's S1
        digest on the host)."""
        if hashlib.sha256(data).hexdigest() != hex_digest:
            raise ValueError(f"chunk content does not match {hex_digest}")
        self.cas.write_bytes(hex_digest, data)
        # The window's listing stays true to the store: a later probe
        # of this digest answers True, as a stat would.
        with self._memo_lock:
            listing = self._listings.get(self.cas.shard(hex_digest))
            if listing is not None:
                listing.names.add(hex_digest)

    def index_layer(self, layer_blob_path: str,
                    chunks: list[Triple]) -> list[str]:
        """Slice a layer's uncompressed stream into its chunks and store
        the ones not held yet. Returns the digests newly added.

        One forward pass over the gzip stream (the chunk list is
        offset-sorted) in INDEX_READ_BLOCK reads, copying out only the
        chunks to store, so memory stays bounded by a block and the
        largest chunk; then a drain to EOF, so the gzip trailer's CRC and
        size are checked and a corrupt blob fails here. The layer's
        digests join the window's claims first, so a shard that the
        layer sends enough digests answers from one listing whether or
        not the streamed observer saw them."""
        added: list[str] = []
        tally = [0, 0]  # [prefetch hits, answers]; flushed below
        routes = [0, 0]  # [listing, stat]
        block = self.INDEX_READ_BLOCK
        with self._memo_lock:
            gen = self._memo_gen
            for _, _, hex_digest in chunks:
                self._claim_locked(hex_digest)
        with open(layer_blob_path, "rb") as raw:
            stream = gzip_mod.GzipFile(fileobj=raw, mode="rb")
            window, start = b"", 0  # stream bytes [start, start + len)
            pos = 0
            for offset, length, hex_digest in chunks:
                if offset < pos:
                    raise ValueError(
                        f"chunk list not offset-sorted at {offset} < {pos}")
                pos = offset + length
                if self._exists_cached(hex_digest, gen, tally, routes):
                    continue
                while start + len(window) < pos:
                    data = stream.read(block)
                    end = start + len(window)
                    if not data:
                        raise ValueError(f"layer stream ended at {end}, "
                                         f"chunk needs {pos}")
                    # Keep the bytes from this chunk on, and no others.
                    window = window[offset - start:] + data \
                        if offset < end else data
                    start = min(offset, end)
                self.put(hex_digest, window[offset - start:pos - start])
                added.append(hex_digest)
            size = start + len(window)
            while data := stream.read(block):
                size += len(data)
        if pos > size:
            raise ValueError(
                f"layer stream ended at {size}, chunk needs {pos}")
        for result, n in zip(("hit", "probe"), tally):
            if n:
                metrics.counter_add("makisu_chunk_exists_prefetch_total",
                                    n, result=result)
        _count_probes(routes)
        return added

    def build_packs(self, chunks: list[Triple],
                    added: list[str]) -> list[tuple[str, list[int]]]:
        """Group a layer's newly added chunk bytes into pack blobs in the
        local CAS. Returns ``[(pack_hex, [chunk_index, ...]), ...]``, the
        map the cache entry records (a member's offset in its pack is the
        sum of the lengths of the members before it). Member bytes come
        from the CAS, which index_layer just filled; peak memory is one
        ~pack_target_bytes() buffer."""
        added_set = set(added)
        target = pack_target_bytes()
        packs: list[tuple[str, list[int]]] = []
        buf = bytearray()
        members: list[int] = []
        packed: set[str] = set()

        def flush() -> None:
            nonlocal buf, members
            if not members:
                return
            pack_hex = hashlib.sha256(bytes(buf)).hexdigest()
            if not self.cas.exists(pack_hex):
                self.cas.write_bytes(pack_hex, bytes(buf))
            packs.append((pack_hex, members))
            buf = bytearray()
            members = []

        for i, (_, length, hex_digest) in enumerate(chunks):
            if hex_digest not in added_set or hex_digest in packed:
                continue
            data = self.get(hex_digest)
            if len(data) != length:
                raise ValueError(
                    f"chunk {hex_digest} CAS size {len(data)} != "
                    f"recorded length {length}")
            packed.add(hex_digest)
            buf += data
            members.append(i)
            if len(buf) >= target:
                flush()
        flush()
        return packs

    def push_packs(self, packs: list[tuple[str, list[int]]]) -> None:
        for pack_hex, _ in packs:
            self.registry.push_layer(Digest.from_hex(pack_hex))

    def pin_packs(self, layer_hex: str,
                  packs: list[tuple[str, list[int]]]) -> None:
        """Pin the packs this layer pushed (``makisu-packs-<layer>``, a
        tag namespace apart from pin_remote's, so a builder pushing
        single chunks never unpins another's packs)."""
        if self.registry is None or not packs:
            return
        self._pin_shards(layer_hex,
                         [(self.cas.size(pack_hex), pack_hex)
                          for pack_hex, _ in packs],
                         PACK_MEDIA_TYPE, "makisu-packs")

    def drop_local_packs(self,
                         packs: list[tuple[str, list[int]]]) -> None:
        """Packs are a wire format: the local CAS keeps chunks. A
        single-member pack is its chunk (same digest, same file) and
        stays."""
        for pack_hex, members in packs:
            if len(members) == 1:
                continue
            try:
                self.cas.delete(pack_hex)
            except OSError:
                pass

    def ensure_available(self, chunks: list[Triple],
                         packs: list | None = None,
                         ledger_key: str | None = None) -> bool:
        """True when every chunk of the list is local after this call. A
        digest repeated at several offsets counts once. With a registry,
        the missing ones fetch from the entry's packs (only the spans
        needed), else one blob each on the transfer engine.

        With ``ledger_key`` (the layer's hex), the outcome lands on the
        decision ledger as a ``chunk_cas`` decision: hit (all local),
        partial (some fetched) or miss, with the bytes re-fetched."""
        lengths: dict[str, int] = {}
        for _, length, hex_digest in chunks:
            lengths.setdefault(hex_digest, length)
        missing = sorted(h for h in lengths if not self.cas.exists(h))
        n_missing = len(missing)
        bytes_missing = sum(lengths[h] for h in missing)

        def outcome(available: bool) -> bool:
            if ledger_key is not None:
                verdict = ("hit" if not n_missing
                           else "partial" if available else "miss")
                ledger.record(
                    "chunk_cas", ledger_key, verdict,
                    reason=None if available else "chunks_incomplete",
                    requested=len(lengths), missing=n_missing,
                    bytes_total=sum(n for _, n, _ in chunks),
                    bytes_refetched=bytes_missing if available else 0)
            return available

        if not missing:
            return outcome(True)
        log.debug("%d of %d distinct chunks missing locally",
                  len(missing), len(lengths))
        # The pack and remote tiers first: a chunk the budget evictor
        # demoted is still on disk (or one object-tier read away) in its
        # pack's compressed twin. No serve plane: a free no-op.
        restored = contentstore.refetch_for_chunk_root(
            self.cas.root, missing, lengths, put=self.put)
        if restored:
            missing = [h for h in missing if h not in restored]
            if not missing:
                return outcome(True)
        # The fleet's peers next: a sibling worker that built this (or a
        # chunk-sharing) context holds the bytes one unix-socket round
        # trip away. With the layer's hex (``ledger_key``) the exchange
        # asks for its recipe and reads ranged packs; one chunk per GET
        # is the fallback. No peers: a free no-op.
        from makisu_tpu_torch.fleet import peers as fleet_peers
        if fleet_peers.available():
            from_peers = fleet_peers.fetch_chunks(
                self.put, missing, lengths, layer_hex=ledger_key)
            if from_peers:
                events.emit("chunk_fetch", route="peer",
                            fetched=len(from_peers), requested=len(missing))
                log.info("fetched %d/%d missing chunks from fleet peers",
                         len(from_peers), len(missing))
                missing = [h for h in missing if h not in from_peers]
            if not missing:
                return outcome(True)
        if self.registry is None:
            return outcome(False)
        if packs:
            missing, mapped_failed = self._fetch_from_packs(
                chunks, packs, missing)
            if not missing and not mapped_failed:
                return outcome(True)
            if mapped_failed:
                # Pack-mapped chunks were never pushed one by one: a
                # per-chunk fetch of them is a 404 each. Report the
                # layer unavailable so the pull takes the blob route.
                return outcome(False)
        ok = transfer.engine().map(self._fetch_remote, missing)
        metrics.counter_add("makisu_chunks_fetched_total", sum(ok),
                            route="blob")
        events.emit("chunk_fetch", route="blob", fetched=sum(ok),
                    requested=len(missing))
        return outcome(all(ok))

    # Coalesce needed spans of a pack when the gap between them is under
    # this: one ranged GET fetching a few spare KiB beats two round trips.
    PACK_RUN_GAP = 128 * 1024
    # Above this needed fraction of a pack, fetch it whole.
    PACK_WHOLE_FETCH_FRACTION = 0.5

    def _fetch_from_packs(self, chunks, packs, missing: list[str]
                          ) -> tuple[list[str], bool]:
        """Fetch missing chunks out of their pack blobs, moving only the
        spans needed: members coalesce into runs served by HTTP Range
        requests, and a pack needed mostly (or on a registry that ignores
        Range) transfers whole. Carved members are checked against their
        digests before the CAS stores them. Returns (digests mapped to no
        pack, which the per-chunk route may still fetch; True when a
        mapped chunk could not be produced)."""
        locate: dict[str, tuple[str, int, int]] = {}
        pack_sizes: dict[str, int] = {}
        pack_member_counts: dict[str, int] = {}
        try:
            for pack_hex, members in packs:
                off = 0
                for i in members:
                    _, length, hex_digest = chunks[i]
                    locate.setdefault(hex_digest, (pack_hex, off, length))
                    off += length
                pack_sizes[pack_hex] = off
                pack_member_counts[pack_hex] = len(members)
        except (IndexError, TypeError, ValueError):
            # A malformed map (a pack row that is not a (hex, members)
            # pair, members that are not a list of indices, an index
            # out of range), as another host's KV entry may carry: its
            # chunks were never pushed one by one, so the pull takes
            # the blob route.
            return [], True
        rows = [(h, locate[h][2], locate[h][0], locate[h][1])
                for h in dict.fromkeys(missing) if h in locate]
        got: set[str] = set()
        pack_spans: dict[str, list] = {}
        for h, length, pack_hex, off in rows:
            pack_spans.setdefault(pack_hex, []).append((off, length, h))
        for spans in pack_spans.values():
            spans.sort()

        def carve(pack_hex: str, data: bytes, base: int, members) -> None:
            """Check and store the members whose bytes lie in ``data``
            (pack bytes [base, base + len(data))); a corrupt member stays
            missing."""
            for off, length, hex_digest in members:
                piece = data[off - base:off - base + length]
                if len(piece) != length:
                    continue
                try:
                    self.put(hex_digest, piece)
                    got.add(hex_digest)
                except ValueError as e:
                    log.warning("pack %s member %s corrupt: %s",
                                pack_hex, hex_digest, e)

        run_jobs, whole_jobs = plan_pack_runs(
            rows, {r[0] for r in rows}, gap=self.PACK_RUN_GAP,
            whole_fraction=self.PACK_WHOLE_FETCH_FRACTION,
            pack_sizes=pack_sizes)
        t0 = time.perf_counter()
        requests_issued: list[int] = []  # list.append is atomic
        if run_jobs:
            range_failed: set[str] = set()
            budget = transfer.engine().budget

            def fetch_pack_runs(job) -> None:
                # One task per pack, its runs in order: a "full" answer
                # (Range ignored) or a failure stops further requests to
                # that pack.
                pack_hex, runs = job
                for run in runs:
                    start = run[0][0]
                    end = run[-1][0] + run[-1][1]
                    with budget.reserve(end - start):
                        got_range = self.registry.pull_blob_range(
                            Digest.from_hex(pack_hex), start, end)
                        requests_issued.append(1)
                        if got_range is None:
                            range_failed.add(pack_hex)
                            return
                        kind, data = got_range
                        if kind == "partial":
                            carve(pack_hex, data, start, run)
                    if kind == "full":
                        # The whole pack is in hand: re-reserve at its
                        # true size (outside the run's reservation),
                        # then carve every needed member.
                        with budget.reserve(len(data)):
                            carve(pack_hex, data, 0, pack_spans[pack_hex])
                        return

            transfer.engine().map(fetch_pack_runs, run_jobs)
            whole_jobs.extend(sorted(range_failed))

        def fetch_whole(pack_hex: str) -> bool:
            if not self._fetch_remote(pack_hex):
                log.debug("pack %s unavailable; %d chunks degrade",
                          pack_hex, len(pack_spans[pack_hex]))
                return False
            try:
                with transfer.engine().budget.reserve(
                        self.cas.size(pack_hex)):
                    with self.cas.open(pack_hex) as f:
                        carve(pack_hex, f.read(), 0, pack_spans[pack_hex])
            finally:
                # A single-member pack is its chunk: deleting it would
                # delete the chunk just carved.
                if pack_member_counts[pack_hex] != 1:
                    try:
                        self.cas.delete(pack_hex)
                    except OSError:
                        pass
            return True

        # Whole packs run on the transfer engine (the reference fetches
        # them one after another): one pack's carve, a digest check and
        # a file per member, overlaps the others' transfers, and the
        # budget bounds the packs held in memory.
        fetched = transfer.engine().map(fetch_whole, whole_jobs)
        n_requests = len(requests_issued) + sum(fetched)
        # Counted even when every fetch failed: a failure episode is
        # when the count matters.
        if n_requests:
            metrics.counter_add("makisu_chunk_fetch_requests_total",
                                n_requests)
        if got:
            metrics.counter_add("makisu_chunks_fetched_total", len(got),
                                route="pack")
            events.emit("chunk_fetch", route="pack", fetched=len(got),
                        requested=len(missing), requests=n_requests)
            log.info("fetched %d/%d missing chunks from %d pack(s) in "
                     "%d request(s)", len(got), len(missing),
                     len(pack_spans), n_requests,
                     seconds=time.perf_counter() - t0,
                     bytes=sum(locate[h][2] for h in got))
        unmapped = [h for h in missing if h not in got and h not in locate]
        mapped_failed = any(h in locate and h not in got
                            and not self.cas.exists(h) for h in missing)
        return unmapped, mapped_failed

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
        ~130k of them for a 1 GiB layer; a local miss asks the pack tiers
        and the registry (``has``) before it gives up."""
        with self.pins.pinned("chunks", hex_digest):
            try:
                f = self.cas.open(hex_digest)
            except FileNotFoundError:
                if not self.has(hex_digest):
                    log.warning("chunk %s missing", hex_digest)
                    return False
                f = self.cas.open(hex_digest)
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
        served chunk by chunk from the local CAS (and, per local miss,
        the registry): a layer whose chunks are local applies with no gzip
        work at all. Memory is bounded by one 1 MiB read; a gap, a short
        chunk or an unavailable chunk raises."""
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
            self._store.pins.unpin("chunks", self._pinned)
        self._pinned = hex_digest
        if hex_digest is not None:
            self._store.pins.pin("chunks", hex_digest)

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
            # one syscall, not a stat and an open. A local miss falls
            # back to the registry probe.
            try:
                self._fh = self._store.cas.open(hex_digest)
            except FileNotFoundError:
                if not self._store.has(hex_digest):
                    self._pin(None)
                    raise FileNotFoundError(
                        f"chunk {hex_digest} unavailable") from None
                self._fh = self._store.cas.open(hex_digest)
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


def _record_index(layer_hex: str, cache_id: str, triples: list[Triple],
                  added: list[str]) -> dict:
    """Dedup accounting of one indexed layer, how many of its bytes were
    new to the CAS and how many were already held: the chunk-byte
    counters, the dedup-ratio gauge and the ``chunk_index`` ledger
    decision. Returns the fields, for the log line."""
    bytes_total = sum(n for _, n, _ in triples)
    lengths: dict[str, int] = {}
    for _, n, h in triples:
        lengths.setdefault(h, n)
    bytes_added = sum(lengths[h] for h in set(added))
    bytes_reused = bytes_total - bytes_added
    metrics.counter_add("makisu_chunk_bytes_total", bytes_added,
                        result="added")
    metrics.counter_add("makisu_chunk_bytes_total", bytes_reused,
                        result="reused")
    ratio = bytes_reused / bytes_total if bytes_total else 0.0
    # Per-layer series only in the build's registry; the process-global
    # one keeps one unlabeled last-layer series, so a long-lived process
    # never grows a series per layer it committed.
    bound = metrics.active_registry()
    if bound is not metrics.global_registry():
        bound.gauge_set("makisu_chunk_dedup_ratio", ratio,
                        layer=layer_hex[:12])
    metrics.global_registry().gauge_set("makisu_chunk_dedup_ratio", ratio)
    fields = {"chunks": len(triples), "added": len(added),
              "bytes_total": bytes_total, "bytes_added": bytes_added,
              "bytes_reused": bytes_reused}
    ledger.record("chunk_index", layer_hex, "indexed", cache_id=cache_id,
                  **fields)
    return fields


def _push_chunks(chunk_store: ChunkStore, manager, cache_id: str,
                 layer_hex: str, triples: list[Triple],
                 added: list[str]) -> None:
    """The chunk push thread of one layer: its new chunks as packs (one
    PUT per ~8 MB), pinned, and the chunk -> pack map recorded on the
    entry; with packs disabled or failed, one blob per chunk on the
    transfer engine, then a pin of the layer's whole chunk set. Failures
    are logged; they never fail the build."""
    if packs_enabled() and added:
        packs: list = []
        try:
            packs = chunk_store.build_packs(triples, added)
            chunk_store.push_packs(packs)
            chunk_store.pin_packs(layer_hex, packs)
            manager.set_entry_packs(
                cache_id, [[pack_hex, members] for pack_hex, members in packs])
            log.info("pushed %d chunks as %d pack blob(s) for %s",
                     len(added), len(packs), cache_id,
                     pack_bytes=sum(chunk_store.cas.size(h)
                                    for h, _ in packs))
            return
        except Exception as e:  # noqa: BLE001 - degrade to single chunks
            log.warning("pack push for %s failed (%s); falling back to "
                        "per-chunk blobs", cache_id, e)
        finally:
            chunk_store.drop_local_packs(packs)
    failed = []

    def push_one(hex_digest):
        try:
            chunk_store.push_remote(hex_digest)
        except Exception as e:  # noqa: BLE001 - counted below
            failed.append((hex_digest, e))

    transfer.engine().map(push_one, added)
    if failed:
        log.warning("chunk push failed for %d/%d chunks (first: %s: %s)",
                    len(failed), len(added), failed[0][0], failed[0][1])
        return
    try:
        chunk_store.pin_remote(layer_hex, triples)
    except Exception as e:  # noqa: BLE001 - logged, never fatal
        log.warning("chunk pin for %s failed: %s", layer_hex, e)


def attach_chunk_dedup(manager, chunk_root: str) -> ChunkStore:
    """Wire a ChunkStore into a CacheManager: index every committed
    layer's chunks on push, serve a hit whose blob is not local from
    chunks, and rebuild the blob from chunks when it is materialized.
    With the manager's registry client, each layer's new chunks are also
    pushed as packs (off the build thread, joined by wait_for_push) and
    missing chunks fetch from the registry."""
    chunk_store = ChunkStore(chunk_root)
    # This store's chunks become servable to the fleet's peers.
    register_serving_store(chunk_store)
    if getattr(manager, "registry", None) is not None:
        chunk_store.set_remote(manager.registry)
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
        with metrics.span("index_layer"):
            try:
                path = manager.store.layers.path(layer_hex)
                added = chunk_store.index_layer(path, triples)
            except FileNotFoundError:
                return
            finally:
                # The streamed memo served exactly this commit-to-index
                # window; a True must not survive into the next layer's.
                chunk_store.reset_fingerprint_memo()
            fields = _record_index(layer_hex, cache_id, triples, added)
        metrics.counter_add("makisu_chunks_indexed_total", len(added))
        log.info("indexed %d new chunks for %s", len(added), cache_id,
                 **fields)
        _spawn_recipe_publish(pair, triples, commit, cache_id)
        if chunk_store.registry is not None:
            t = threading.Thread(
                target=contextvars.copy_context().run,
                args=(_push_chunks, chunk_store, manager, cache_id,
                      layer_hex, triples, added),
                daemon=True, name=f"chunkpush-{cache_id}")
            t.start()
            with manager._lock:
                manager._pushes.append(t)

    def pull_cache(cache_id):
        """Chunk-aware pull: the chunk route first when the blob is not
        local (after a small edit it moves only the novel chunks), then
        the base blob route. A chunk-route hit is a promise the build
        keeps (execution is skipped), so it is accepted only when every
        chunk is local, fetched now from the registry if need be, and the
        entry's gzip backend can be replayed here byte for byte."""
        raw, pair, chunks, gz_backend, packs = get_entry(manager, cache_id)
        if pair is None:
            metrics.counter_add("makisu_cache_pull_total", result="empty")
            events.emit("cache", result="empty", cache_id=cache_id)
            ledger.record("kv", cache_id, "empty")
            return None
        hex_digest = pair.gzip_descriptor.digest.hex()
        if not manager.store.layers.exists(hex_digest) and chunks:
            if not tario.backend_id_usable(gz_backend):
                log.info("cache hit %s: gzip backend %r not replayable "
                         "here; trying the blob route", cache_id,
                         gz_backend)
                ledger.record("chunk_cas", hex_digest, "stale",
                              reason="gz_backend")
            elif chunk_store.ensure_available([tuple(c) for c in chunks],
                                              packs, ledger_key=hex_digest):
                with manager._lock:
                    manager._lazy[hex_digest] = raw
                metrics.counter_add("makisu_cache_pull_total",
                                    result="hit")
                metrics.counter_add("makisu_cache_chunk_route_hits_total")
                events.emit("cache", result="hit", cache_id=cache_id,
                            layer=hex_digest, route="chunks",
                            chunks=len(chunks))
                ledger.record("kv", cache_id, "hit", layer=hex_digest,
                              route="chunks",
                              bytes_saved=pair.gzip_descriptor.size)
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
            t0 = time.perf_counter()
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
                         hex_digest, len(chunks), gz=gz_backend,
                         seconds=time.perf_counter() - t0)
                return manager.store.layers.path(hex_digest)
        return inner_materialize(hex_digest)

    def open_layer_tar(pair):
        """The uncompressed tar straight from chunks when the blob is not
        local (no blob, no gzip), else the base route. Availability,
        missing chunks fetched included, is settled before the stream
        opens: application mutates the tree as it reads, so the stream
        must be a sure thing."""
        hex_digest = pair.gzip_descriptor.digest.hex()
        if not manager.store.layers.exists(hex_digest):
            _, chunks, _, packs = _lazy_entry(hex_digest)
            if chunks:
                triples = [tuple(c) for c in chunks]
                if chunk_store.ensure_available(triples, packs,
                                                ledger_key=hex_digest):

                    @contextlib.contextmanager
                    def _chunk_tar():
                        log.info("applying layer %s from %d chunks "
                                 "(no blob, no gzip)", hex_digest,
                                 len(triples))
                        with chunk_store.open_stream(triples) as stream:
                            yield stream

                    return _chunk_tar()
                log.info("layer %s chunks incomplete locally/remotely; "
                         "falling back to blob materialization",
                         hex_digest)
        return inner_open_tar(pair)

    def _publish_serve_recipe(pair, triples, commit) -> None:
        """The distribution plane's publish: when this process serves (a
        worker, ``MAKISU_TPU_SERVE=1``), every indexed layer gets a
        signed recipe and pack tables in ``<storage>/serve/``, what delta
        pulls and the pack-granular peer exchange read. Never fails the
        build: an unpublished layer keeps the blob route only."""
        from makisu_tpu_torch.serve import server as serve_server
        try:
            serve_store = serve_server.register_store(manager.store.root)
            serve_store.publish(pair, triples, commit.gzip_backend_id,
                                chunk_store)
        except Exception as e:  # noqa: BLE001 - publish is advisory
            log.warning("serve recipe publish failed for %s: %s",
                        pair.gzip_descriptor.digest.hex(), e)

    def _spawn_recipe_publish(pair, triples, commit, cache_id) -> None:
        """The publish re-reads and re-hashes every novel chunk out of the
        CAS, so it runs on a thread of its own like the registry chunk
        push, joined by ``wait_for_push``: a finished build has
        published; a client that asks earlier takes the blob route."""
        from makisu_tpu_torch.serve import server as serve_server
        if not serve_server.publish_enabled():
            return
        t = threading.Thread(
            target=contextvars.copy_context().run,
            args=(_publish_serve_recipe, pair, triples, commit),
            daemon=True, name=f"recipepub-{cache_id}")
        t.start()
        with manager._lock:
            manager._pushes.append(t)

    manager.push_cache = push_cache
    manager.pull_cache = pull_cache
    manager.materialize = materialize
    manager.open_layer_tar = open_layer_tar
    manager.chunk_store = chunk_store
    if concurrency.hash_workers() > 1:
        # Stream the dedup lookups: the chunk session reports each
        # fingerprint (context-scoped, so concurrent builds see only
        # their own), and the CAS stats index_layer needs run on the
        # pool before push_cache re-reads the layer. (Imported here: the
        # chunker loads torch, which the storage readers never need.)
        from makisu_tpu_torch.chunker import cdc
        cdc.set_chunk_observer(chunk_store.note_fingerprint)
    return chunk_store
