"""Chunk-addressed session snapshots: durable warm state.

Copy of ``makisu_tpu/worker/snapshots.py``, its write counters included;
recipe staging (``SnapshotStore.stage``, the worker's restore endpoint)
pulls shard chunks missing here over the peer wire. A resident build
session (``worker/session.py``) dies with its process; this module
serializes its memos into **shards** stored through the chunk CAS
(``cache/chunks.py``, ``<storage>/chunks/``), indexed by a small JSON
**recipe** under ``<storage>/serve/snapshots/<key>.json``, in the
reference's format (``makisu-tpu.session-snapshot.v1``):

- ``scan``: the context-scan memo, (source, checksum_in) ->
  (checksum_out, files, bytes) transitions;
- ``stat/<n>``: the stat-cache entries of this context, bucketed by a
  hash of the rel path, so one touched file serializes one bucket again;
- ``walk/<n>``: the mtime-walk baseline's stat signatures, bucketed the
  same way: the point a restored session deltas against, so the gap
  between snapshot and restore is covered at the trust level of the
  live mtime-walk fallback;
- ``layer/<key>``: one shard per layer-replay memo entry, keyed by
  (applied chain, digest).

Shard documents serialize deterministically (sorted keys), so an
unchanged shard hashes to the chunk it already has: a checkpoint costs
O(changed shards). The recipe carries the invalidation story (portable
flag identity, kernel route, capture time) and ``try_restore`` enforces
it (``flag_identity`` / ``isa_change`` / ``stale``) before any shard
byte is trusted. Restored stat-cache entries keep their ``hashed_at``,
so the racily-clean discipline and the per-lookup stat comparison apply
to them unchanged.
"""

from __future__ import annotations

import hashlib
import json
import os
import tarfile
import time
import zlib

from makisu_tpu_torch.utils import fileio, metrics
from makisu_tpu_torch.utils import logging as log

SNAPSHOT_SCHEMA = "makisu-tpu.session-snapshot.v1"
SNAPSHOT_SUBDIR = os.path.join("serve", "snapshots")

# Rel-path hash buckets of the stat and walk shards: enough that one
# touched file serializes ~1/16th of a big table again, few enough that
# an idle checkpoint's existence probes stay a handful of stats.
STAT_BUCKETS = 16
WALK_BUCKETS = 16

# TarInfo fields that round-trip through a layer shard. Offsets and sparse
# maps are stream-position state that a replay never consults.
_TAR_FIELDS = ("name", "mode", "uid", "gid", "size", "mtime",
               "linkname", "uname", "gname", "devmajor", "devminor")

# Watcher-mode sessions keep a persistence baseline of their own (the
# live session needs no walk); it is taken again once this many
# watcher-observed dirty paths accumulate, which bounds the over-dirtying
# a stale baseline costs a restore.
BASELINE_REFRESH_PATHS = 4096


def snapshots_dir(storage_dir: str) -> str:
    return os.path.join(os.path.abspath(storage_dir), SNAPSHOT_SUBDIR)


def snap_key(context_dir: str, portable_identity: str) -> str:
    """Recipe file key: one recipe per (context, portable flag identity);
    a checkpoint replaces its predecessor atomically."""
    blob = (os.path.realpath(os.path.abspath(context_dir))
            + "\n" + portable_identity).encode()
    return hashlib.sha256(blob).hexdigest()


def _bucket(rel: str, buckets: int) -> int:
    return zlib.crc32(rel.encode("utf-8", "surrogateescape")) % buckets


def _dumps(doc) -> bytes:
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()


# -- TarInfo / layer-entry round trip ----------------------------------------


def _tarinfo_to_doc(hdr: tarfile.TarInfo) -> dict:
    doc = {f: getattr(hdr, f) for f in _TAR_FIELDS}
    doc["type"] = hdr.type.decode("latin-1")
    if hdr.pax_headers:
        doc["pax"] = {str(k): str(v) for k, v in hdr.pax_headers.items()}
    return doc


def _tarinfo_from_doc(doc: dict) -> tarfile.TarInfo:
    hdr = tarfile.TarInfo()
    for f in _TAR_FIELDS:
        if f in doc:
            setattr(hdr, f, doc[f])
    hdr.type = str(doc.get("type", "0")).encode("latin-1")
    pax = doc.get("pax")
    if isinstance(pax, dict):
        hdr.pax_headers = {str(k): str(v) for k, v in pax.items()}
    return hdr


def _entries_to_doc(entries: list) -> list:
    from makisu_tpu_torch.snapshot.layer import ContentEntry, WhiteoutEntry
    out = []
    for e in entries:
        if isinstance(e, WhiteoutEntry):
            out.append({"wh": e.deleted})
        elif isinstance(e, ContentEntry):
            out.append({"src": e.src, "dst": e.dst,
                        "hdr": _tarinfo_to_doc(e.hdr)})
        else:
            raise ValueError(f"unknown layer entry {type(e)!r}")
    return out


def _entries_from_doc(doc: list) -> list:
    from makisu_tpu_torch.snapshot.layer import ContentEntry, WhiteoutEntry
    out = []
    for row in doc:
        if "wh" in row:
            out.append(WhiteoutEntry(str(row["wh"])))
        else:
            out.append(ContentEntry(str(row["src"]), str(row["dst"]),
                                    _tarinfo_from_doc(row["hdr"])))
    return out


# -- the store --------------------------------------------------------------


class SnapshotStore:
    """One storage dir's snapshot plane: recipes under
    ``serve/snapshots/``, shard bytes in the storage's chunk CAS."""

    def __init__(self, storage_dir: str) -> None:
        self.storage_dir = os.path.abspath(storage_dir)
        self.dir = snapshots_dir(storage_dir)
        self._chunks = None

    def chunk_store(self):
        if self._chunks is None:
            from makisu_tpu_torch.cache.chunks import ChunkStore
            self._chunks = ChunkStore(
                os.path.join(self.storage_dir, "chunks"))
        return self._chunks

    def recipe_path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.json")

    def write_recipe(self, recipe: dict) -> str:
        key = snap_key(recipe["context"], recipe["portable_identity"])
        os.makedirs(self.dir, exist_ok=True)
        fileio.write_json_atomic(self.recipe_path(key), recipe)
        return key

    def load(self, context_dir: str,
             portable_identity: str) -> dict | None:
        return self._read(self.recipe_path(
            snap_key(context_dir, portable_identity)))

    def load_for_context(self, context_dir: str) -> dict | None:
        """The newest recipe of a context, whatever its identity."""
        key = os.path.realpath(os.path.abspath(context_dir))
        best = None
        try:
            names = os.listdir(self.dir)
        except OSError:
            return None
        for name in names:
            if not name.endswith(".json"):
                continue
            doc = self._read(os.path.join(self.dir, name))
            if doc is None or doc.get("context") != key:
                continue
            if best is None or (doc.get("saved_at", 0)
                                > best.get("saved_at", 0)):
                best = doc
        return best

    @staticmethod
    def _read(path: str) -> dict | None:
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(doc, dict) \
                or doc.get("schema") != SNAPSHOT_SCHEMA \
                or not isinstance(doc.get("shards"), dict):
            return None
        return doc

    @staticmethod
    def shard_plan(recipe: dict) -> list[tuple[int, int, str]]:
        """The recipe's shards as chunk triples (``ensure_available``)."""
        return [(0, int(row.get("bytes", 0)), str(row.get("chunk", "")))
                for row in recipe.get("shards", {}).values()]

    def stage(self, recipe: dict) -> tuple[bool, str]:
        """Adopt a recipe (the worker's ``POST /sessions/restore``):
        check its shape, make sure every shard chunk is in this storage's
        chunk CAS and persist it, so the next build of its context
        restores warm. Shard chunks missing here come from the fleet's
        peers (``ChunkStore.ensure_available``, one chunk per GET: shards
        are no pack's members). Returns ``(ok, reason)``; a refused stage
        (``chunks_unavailable`` when no peer held a chunk) writes no
        recipe."""
        if not isinstance(recipe, dict) \
                or recipe.get("schema") != SNAPSHOT_SCHEMA \
                or not isinstance(recipe.get("shards"), dict) \
                or not recipe.get("context") \
                or not recipe.get("portable_identity"):
            return False, "schema"
        plan = self.shard_plan(recipe)
        if not all(h and len(h) == 64 for _, _, h in plan):
            return False, "schema"
        if not self.chunk_store().ensure_available(plan):
            return False, "chunks_unavailable"
        self.write_recipe(recipe)
        return True, ""


# -- checkpoint write ---------------------------------------------------------


def _layer_shard_name(key: tuple) -> str:
    chain, digest = key
    return "layer/" + hashlib.sha256(
        f"{chain}:{digest}".encode()).hexdigest()[:32]


def write_snapshot(session, storage_dir: str) -> dict | None:
    """Checkpoint one session into the chunk CAS. Incremental: a shard
    whose dirty flag is clear carries its previous chunk forward, and a
    serialized shard that hashes to a stored chunk skips the put. Never
    raises: a checkpoint that cannot land costs durability, not the
    build."""
    try:
        return _write_snapshot(session, storage_dir)
    except Exception as exc:  # noqa: BLE001 - advisory by contract
        metrics.counter_add(metrics.SESSION_SNAPSHOT_WRITES,
                            result="error")
        log.warning("session snapshot write failed for %s: %s",
                    session.context_dir, exc)
        return None


def _walk_baseline(session):
    """The walk baseline to persist. An mtime-walk session persists its
    live baseline (taken at begin_build); a watcher session keeps one of
    its own, taken again once the watcher's churn would make a restore's
    delta too conservative."""
    baseline = session.snapshot
    if session.watcher is None or not session.watcher.healthy:
        return baseline
    if session._snap_baseline is None and baseline is not None:
        # A restored-then-watched session holds a current baseline (the
        # restore's gap delta refreshed it): adopt it.
        session._snap_baseline = baseline
    if (session._snap_baseline is None
            or session._snap_gap_paths > BASELINE_REFRESH_PATHS):
        from makisu_tpu_torch.worker.session import walk_mod
        session._snap_baseline = walk_mod.snapshot_tree(
            session.context_dir, session._walk_blacklist)
        session._snap_gap_paths = 0
        session._snap_walk_all = True
    return session._snap_baseline


def _write_snapshot(session, storage_dir: str) -> dict | None:
    if not session.portable_identity:
        return None
    store = SnapshotStore(storage_dir)
    chunks = store.chunk_store()
    carried: dict[str, dict] = dict(session._snap_shards)
    shards: dict[str, dict] = {}
    written = reused = 0

    def put_shard(name: str, doc) -> None:
        nonlocal written, reused
        blob = _dumps(doc)
        hex_digest = hashlib.sha256(blob).hexdigest()
        if chunks.cas.exists(hex_digest):
            reused += len(blob)
        else:
            chunks.put(hex_digest, blob)
            written += len(blob)
        shards[name] = {"chunk": hex_digest, "bytes": len(blob)}

    def carry(name: str) -> bool:
        row = carried.get(name)
        if not row:
            return False
        shards[name] = {"chunk": row["chunk"], "bytes": row["bytes"]}
        return True

    def put_buckets(family: str, buckets: int, dirty: set[int],
                    rows) -> None:
        """Shards ``family/0..buckets-1``; those outside ``dirty`` carry
        forward. ``rows()`` yields (key, value) of the whole table and is
        read only when a bucket serializes."""
        table = None
        for b in range(buckets):
            name = f"{family}/{b}"
            if b not in dirty and carry(name):
                continue
            if table is None:
                table = [{} for _ in range(buckets)]
                for key, value in rows():
                    table[_bucket(key, buckets)][key] = value
            put_shard(name, table[b])

    # The scan memo: one shard, serialized again only after a store or a
    # clear.
    if session._snap_scan_dirty or not carry("scan"):
        put_shard("scan", [[src, cin, out, files, nbytes]
                           for (src, cin), (out, files, nbytes)
                           in session.scan_memo.items()])
        session._snap_scan_dirty = False

    # The stat cache: only buckets holding a mutated key serialize.
    cache = session.content_ids
    if cache is not None:
        mutated = cache.drain_mutations()
        dirty = (set(range(STAT_BUCKETS)) if session._snap_stat_all
                 else {_bucket(rel, STAT_BUCKETS) for rel in mutated})
        put_buckets("stat", STAT_BUCKETS, dirty,
                    lambda: cache.namespace_items().items())
        session._snap_stat_all = False

    baseline = _walk_baseline(session)
    walk_doc = None
    if baseline is not None:
        walk_doc = {"root": baseline.root,
                    "captured_ns": baseline.captured_ns,
                    "est_bytes": baseline.est_bytes,
                    "fresh": sorted(baseline.fresh)}
        dirty = (set(range(WALK_BUCKETS)) if session._snap_walk_all
                 else {_bucket(p, WALK_BUCKETS)
                       for p in session._snap_walk_dirty})
        put_buckets("walk", WALK_BUCKETS, dirty,
                    lambda: ((p, list(sig))
                             for p, sig in baseline.sigs.items()))
        session._snap_walk_all = False
        session._snap_walk_dirty.clear()

    # The layer-replay memo: one content-keyed shard per entry; carried
    # names are the dedup, and evicted memos drop out of the recipe.
    layer_index = {}
    for key, entries in session.layer_replay.items():
        name = _layer_shard_name(key)
        layer_index[name] = list(key)
        if not carry(name):
            put_shard(name, _entries_to_doc(entries))

    recipe = {
        "schema": SNAPSHOT_SCHEMA,
        "context": os.path.realpath(session.context_dir),
        "identity": session.identity,
        "portable_identity": session.portable_identity,
        "isa": session.isa,
        "ignore_sig": session._ignore_sig,
        "exact": bool(session.exact and walk_doc is not None),
        "builds": session.builds,
        "saved_at": time.time(),
        "pending_dirty": sorted(session.pending_dirty),
        "walk": walk_doc,
        "layer_keys": layer_index,
        "shards": shards,
    }
    store.write_recipe(recipe)
    session._snap_shards = {n: dict(r) for n, r in shards.items()}
    metrics.counter_add(metrics.SESSION_SNAPSHOT_WRITES, result="ok")
    if written:
        metrics.counter_add(metrics.SESSION_SNAPSHOT_CHUNK_BYTES,
                            written, result="written")
    if reused:
        metrics.counter_add(metrics.SESSION_SNAPSHOT_CHUNK_BYTES,
                            reused, result="reused")
    return recipe


# -- restore ----------------------------------------------------------------


def try_restore(context_dir: str, identity: str, storage_dir: str,
                portable_identity: str):
    """Rebuild a session from the storage's snapshot plane. Returns
    ``(session, "")`` on success, ``(None, "")`` when no recipe exists (a
    plain cold miss), or ``(None, reason)`` on a refusal; the reasons are
    the live session's invalidations, so a snapshot never outlives a
    check a resident session obeys."""
    store = SnapshotStore(storage_dir)
    recipe = store.load(context_dir, portable_identity)
    if recipe is None:
        # An identity-keyed miss: take any recipe of the context, so a
        # changed identity is refused loudly (flag_identity) rather than
        # built cold in silence.
        recipe = store.load_for_context(context_dir)
        if recipe is None:
            return None, ""
    return restore_from_recipe(store, recipe, context_dir, identity,
                               portable_identity)


def restore_from_recipe(store: SnapshotStore, recipe: dict,
                        context_dir: str, identity: str,
                        portable_identity: str):
    from makisu_tpu_torch.worker import session as session_mod
    key = os.path.realpath(os.path.abspath(context_dir))
    if recipe.get("context") != key:
        return None, "context_mismatch"
    if recipe.get("portable_identity") != portable_identity:
        return None, "flag_identity"
    if recipe.get("isa") != session_mod._isa_identity():
        return None, "isa_change"
    age = time.time() - float(recipe.get("saved_at", 0) or 0)
    if age > session_mod.session_ttl():
        return None, "stale"
    if not store.chunk_store().ensure_available(store.shard_plan(recipe)):
        return None, "chunks_unavailable"
    try:
        return _materialize(store, recipe, context_dir, identity), ""
    except Exception as exc:  # noqa: BLE001 - never fail the build
        log.warning("session snapshot restore failed for %s: %s",
                    context_dir, exc)
        return None, "corrupt"


def _load_shard(chunks, recipe: dict, name: str):
    row = recipe["shards"].get(name)
    if row is None:
        return None
    return json.loads(chunks.get(str(row["chunk"])).decode())


def _materialize(store: SnapshotStore, recipe: dict, context_dir: str,
                 identity: str):
    from makisu_tpu_torch.worker import session as session_mod
    chunks = store.chunk_store()
    session = session_mod.BuildSession(context_dir, identity)
    session.portable_identity = recipe["portable_identity"]
    session.builds = int(recipe.get("builds", 0) or 0)
    session._ignore_sig = recipe.get("ignore_sig")
    session.pending_dirty = {str(p) for p in
                             recipe.get("pending_dirty") or []}

    scan = _load_shard(chunks, recipe, "scan") or []
    for src, cin, out, files, nbytes in scan:
        session.scan_memo[(str(src), int(cin))] = (
            int(out), int(files), int(nbytes))

    stat_entries: dict[str, list] = {}
    for b in range(STAT_BUCKETS):
        shard = _load_shard(chunks, recipe, f"stat/{b}")
        if isinstance(shard, dict):
            stat_entries.update(shard)
    session._restored_stat_entries = stat_entries or None

    walk_doc = recipe.get("walk")
    if isinstance(walk_doc, dict) and recipe.get("exact"):
        sigs: dict[str, tuple] = {}
        for b in range(WALK_BUCKETS):
            shard = _load_shard(chunks, recipe, f"walk/{b}")
            if isinstance(shard, dict):
                for path, sig in shard.items():
                    sigs[str(path)] = tuple(sig)
        session.snapshot = session_mod.walk_mod.TreeSnapshot(
            str(walk_doc.get("root", context_dir)),
            int(walk_doc.get("captured_ns", 0) or 0),
            sigs,
            {str(p) for p in walk_doc.get("fresh") or []},
            int(walk_doc.get("est_bytes", 0) or 0))
        session.exact = True
        session._gap_delta_pending = True

    for name, key in (recipe.get("layer_keys") or {}).items():
        doc = _load_shard(chunks, recipe, name)
        if doc is None or not isinstance(key, list) or len(key) != 2:
            continue
        session.replay_store((str(key[0]), str(key[1])),
                             _entries_from_doc(doc))

    # The restored shards are the last checkpoint: carry their chunks
    # forward so the first checkpoint after the restore is incremental.
    session._snap_shards = {n: dict(r) for n, r
                            in recipe["shards"].items()}
    session._snap_scan_dirty = False
    session._snap_stat_all = True  # the local cache may hold more keys
    session._snap_walk_all = False
    session.restored = True
    session._restore_fresh = True
    return session
