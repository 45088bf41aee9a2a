"""The port's content store (``makisu_tpu_torch/storage/contentstore.py``)
on the CPU, held against the JAX package's.

Every case of ``tests/test_contentstore.py`` runs against the port:
refcount pins, the one eviction policy shared by the dry run and the
evictor, budget eviction, and hot/cold pack tiering with a refetch that
checks every carved chunk against its digest. Then the two packages meet
on one numpy-seeded storage dir: both evictors name the same victims at
the same budget, and a chunk demoted by either package is refetched by
the other byte for byte. Gap T2 has its own case: ``ensure_available``
restores demoted chunks from the zpack twin with no peer and no registry
attached.
"""

import hashlib
import json
import os

import numpy as np
import pytest

from makisu_tpu.cache import chunks as ref_chunks
from makisu_tpu.storage import contentstore as ref_contentstore
from makisu_tpu_torch.cache import census as census_mod
from makisu_tpu_torch.cache import chunks as chunks_mod
from makisu_tpu_torch.cache.chunks import ChunkStore
from makisu_tpu_torch.fleet import peers as fleet_peers
from makisu_tpu_torch.serve import recipe as recipe_mod
from makisu_tpu_torch.storage import contentstore
from makisu_tpu_torch.utils import events, zstdio


def _pair(seed):
    from makisu_tpu_torch.docker.image import (
        MEDIA_TYPE_LAYER, Descriptor, Digest, DigestPair)
    return DigestPair(
        tar_digest=Digest.from_hex(f"{seed:02x}" * 32),
        gzip_descriptor=Descriptor(
            MEDIA_TYPE_LAYER, 10,
            Digest.from_hex(f"{seed + 1:02x}" * 32)))


def _publish(tmp_path, payloads=None):
    """One published layer over ``payloads`` chunks (pack + zpack twin
    when zstd is available). Returns (storage, store, doc, fps,
    payloads)."""
    storage = str(tmp_path / "storage")
    store = ChunkStore(os.path.join(storage, "chunks"))
    rs = recipe_mod.RecipeStore(os.path.join(storage, "serve"),
                                os.path.join(storage, "chunks"))
    if payloads is None:
        payloads = [b"a" * 1000, b"b" * 3000, b"c" * 2000]
    fps = [hashlib.sha256(p).hexdigest() for p in payloads]
    for fp, data in zip(fps, payloads):
        store.put(fp, data)
    triples = []
    off = 0
    for fp, data in zip(fps, payloads):
        triples.append((off, len(data), fp))
        off += len(data)
    doc = rs.publish(_pair(0x10), triples, None, store)
    assert doc is not None
    return storage, store, doc, fps, payloads


def _chunk_path(storage, fp):
    return os.path.join(storage, "chunks", fp[:2], fp)


def _triples(payloads, fps):
    out, off = [], 0
    for fp, data in zip(fps, payloads):
        out.append((off, len(data), fp))
        off += len(data)
    return out


# -- parity: the dry-run IS the evictor's plan --------------------------------


def test_dry_run_and_evictor_share_one_candidate_set(tmp_path):
    """``doctor --storage --eviction-budget N`` and the real evictor
    consume one EvictionPolicy: identical candidate sets on a seeded
    store, and the evictor deletes exactly what the dry run itemized."""
    storage, store, doc, fps, payloads = _publish(tmp_path)
    budget = 2500  # keeps about the newest chunk, evicts the rest
    dry = census_mod.StorageCensus(storage).eviction_dry_run(budget)
    assert not dry["refused"]
    predicted = [(v["plane"], v["object"])
                 for v in dry["would_evict"]]
    cstore = contentstore.store_for(storage)
    plan = cstore.plan(budget_bytes=budget, include_candidates=True)
    planned = [(p, n) for p, n, _, _, _ in plan["candidates"]]
    assert predicted == planned
    before = {fp for fp in fps
              if os.path.isfile(_chunk_path(storage, fp))}
    result = cstore.evict(budget_bytes=budget)
    after = {fp for fp in fps
             if os.path.isfile(_chunk_path(storage, fp))}
    deleted = {("chunks", fp) for fp in before - after}
    assert deleted == set(planned)
    assert result["evicted"] == dry["evict_count"]
    assert result["remaining_bytes"] <= budget


def test_policy_quota_victims_evict_first():
    """Per-tenant soft quota: an over-quota tenant's cold objects order
    ahead of a global-LRU victim that is even colder."""
    rows = [
        (100.0, 1000, "chunks", "aa" * 32),  # coldest, no tenant
        (200.0, 1000, "chunks", "bb" * 32),  # over-quota tenant
        (300.0, 1000, "chunks", "cc" * 32),  # in-quota tenant
    ]
    policy = contentstore.EvictionPolicy(
        tenant_of={("chunks", "bb" * 32): "greedy",
                   ("chunks", "cc" * 32): "frugal"},
        over_quota={"greedy"})
    plan = policy.plan(rows, budget_bytes=2000)
    assert [v["object"] for v in plan["would_evict"]] == ["bb" * 32]
    assert plan["would_evict"][0]["tenant"] == "greedy"
    # Without the quota, pure LRU.
    lru = contentstore.EvictionPolicy().plan(rows, budget_bytes=2000)
    assert [v["object"] for v in lru["would_evict"]] == ["aa" * 32]


def test_policy_holds_budget_steady_state():
    rows = [(float(i), 100, "chunks", f"{i:02d}" * 32)
            for i in range(50)]
    plan = contentstore.EvictionPolicy().plan(rows, budget_bytes=1000)
    assert plan["remaining_bytes"] <= 1000
    assert plan["evict_count"] == 40
    # Oldest recency first.
    assert plan["would_evict"][0]["object"] == "00" * 32


# -- refcount plane: pins win races -------------------------------------------


def test_pin_under_read_survives_eviction(tmp_path):
    """A chunk under an in-flight open_stream read is never evicted
    mid-read, even at a budget of about 0."""
    storage, store, doc, fps, payloads = _publish(tmp_path)
    stream = store.open_stream([(0, 1000, fps[0]), (1000, 3000, fps[1]),
                                (4000, 2000, fps[2])])
    first = stream.read(500)  # mid-chunk: fps[0] is pinned
    assert first == payloads[0][:500]
    cstore = contentstore.store_for(storage)
    result = cstore.evict(budget_bytes=1)
    assert result["pinned_skipped"] >= 1
    assert os.path.isfile(_chunk_path(storage, fps[0]))
    # The stream finishes byte-identically: later chunks were evicted
    # but the tier refetch (through has()) restores them.
    rest = stream.read()
    stream.close()
    assert first + rest == b"".join(payloads)
    # Closing releases the pin; nothing stays pinned.
    assert cstore.board.count() == 0


def test_peer_serve_read_pins_member(tmp_path):
    """A peer pack-range read in flight keeps its member chunks."""
    storage, store, doc, fps, payloads = _publish(tmp_path)
    pack_hex = doc["chunks"][0][2]
    rs = recipe_mod.RecipeStore(os.path.join(storage, "serve"),
                                os.path.join(storage, "chunks"))
    chunks_mod.register_serving_store(store)
    try:
        size = rs.pack_size(pack_hex)
        it = rs.iter_pack_range(pack_hex, 0, size, piece_size=256)
        got = [next(it)]  # generator entered: first member pinned
        board = contentstore.board_for(storage)
        assert board.count() == 1
        contentstore.store_for(storage).evict(budget_bytes=1)
        for piece in it:
            got.append(piece)
        raw = b"".join(got)
        assert hashlib.sha256(raw).hexdigest() == pack_hex
        assert board.count() == 0
    finally:
        with chunks_mod._serving_lock:
            chunks_mod._serving_stores.pop(
                os.path.realpath(store.cas.root), None)


def test_cas_count_lru_skips_pinned(tmp_path):
    store = ChunkStore(str(tmp_path / "chunks"), max_entries=2)
    payloads = [b"x" * 100, b"y" * 100, b"z" * 100]
    fps = [hashlib.sha256(p).hexdigest() for p in payloads]
    store.put(fps[0], payloads[0])
    store.pins.pin("chunks", fps[0])
    try:
        store.put(fps[1], payloads[1])
        store.put(fps[2], payloads[2])  # over cap: LRU would take #0
        assert store.cas.exists(fps[0])
    finally:
        store.pins.unpin("chunks", fps[0])


def test_snapshot_recipe_chunks_pinned_through_eviction(tmp_path):
    """Session-snapshot recipes pin their shard chunks: evict at a tiny
    budget, then every shard chunk is still present and byte-identical
    (a warm restore after kill -9 cannot miss)."""
    storage, store, doc, fps, payloads = _publish(tmp_path)
    snap_dir = os.path.join(storage, "serve", "snapshots")
    os.makedirs(snap_dir, exist_ok=True)
    with open(os.path.join(snap_dir, "ctx.json"), "w",
              encoding="utf-8") as f:
        json.dump({"schema": "test", "context": "/ctx",
                   "shards": {"statcache": {"chunk": fps[0]},
                              "memo": {"chunk": fps[2]}}}, f)
    cstore = contentstore.store_for(storage)
    result = cstore.evict(budget_bytes=1)
    assert result["evicted"] >= 1
    for i in (0, 2):  # snapshot shards: protected
        assert os.path.isfile(_chunk_path(storage, fps[i]))
        assert store.get(fps[i]) == payloads[i]
    # The unpinned middle chunk was evictable.
    assert result["pinned_skipped"] == 2
    # Restoring goes through ensure_available byte-identically, the
    # evicted chunk included (tier refetch when zstd, else reported
    # missing: never silently wrong bytes).
    triples = [(0, 1000, fps[0]), (1000, 3000, fps[1]),
               (4000, 2000, fps[2])]
    if zstdio.available():
        assert store.ensure_available(triples)
        for fp, data in zip(fps, payloads):
            assert store.get(fp) == data


# -- tiering: demote → refetch round trips ------------------------------------


@pytest.mark.skipif(not zstdio.available(), reason="no zstd")
def test_demote_refetch_round_trip_zpack_tier(tmp_path):
    """Budget eviction demotes chunks to pack membership (zpack twin);
    refetch restores byte-identical chunks and counts the bytes moved."""
    storage, store, doc, fps, payloads = _publish(tmp_path)
    cstore = contentstore.store_for(storage)
    before = contentstore.counters()["refetch_bytes"]
    result = cstore.evict(budget_bytes=1)
    assert result["evicted"] == 3
    assert result["reasons"].get("demote", 0) == 3
    for fp in fps:
        assert not os.path.isfile(_chunk_path(storage, fp))
    # The zpack twin stayed: hot bytes gone, the pack tier holds them.
    tiers = cstore.tier_bytes(publish=False)
    assert tiers["hot"] == 0 and tiers["pack"] > 0
    # ensure_available promotes them back, checked by put().
    triples = [(0, 1000, fps[0]), (1000, 3000, fps[1]),
               (4000, 2000, fps[2])]
    assert store.ensure_available(triples)
    for fp, data in zip(fps, payloads):
        assert store.get(fp) == data
    assert contentstore.counters()["refetch_bytes"] > before


def test_demote_refetch_round_trip_raw_pack_tier(tmp_path,
                                                 monkeypatch):
    """With no compressed twin (a libzstd-less publisher), cold packs
    demote to the remote tier as materialized raw packs and refetch
    ranged and digest-checked from there."""
    monkeypatch.setattr(zstdio, "available", lambda: False)
    storage, store, doc, fps, payloads = _publish(tmp_path)
    assert not os.path.isdir(os.path.join(storage, "serve",
                                          "zpacks")) \
        or not os.listdir(os.path.join(storage, "serve", "zpacks"))
    remote = str(tmp_path / "remote")
    monkeypatch.setenv("MAKISU_TPU_STORAGE_REMOTE", remote)
    cstore = contentstore.store_for(storage)
    result = cstore.evict(budget_bytes=1)
    assert result["evicted"] == 3
    pack_hex = doc["chunks"][0][2]
    rawpack = os.path.join(remote, "packs", f"{pack_hex}.pack")
    assert os.path.isfile(rawpack)
    with open(rawpack, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == pack_hex
    for fp in fps:
        assert not os.path.isfile(_chunk_path(storage, fp))
    triples = [(0, 1000, fps[0]), (1000, 3000, fps[1]),
               (4000, 2000, fps[2])]
    assert store.ensure_available(triples)
    for fp, data in zip(fps, payloads):
        assert store.get(fp) == data


@pytest.mark.skipif(not zstdio.available(), reason="no zstd")
def test_cold_zpack_demotes_to_remote_and_serves_refetch(
        tmp_path, monkeypatch):
    """Cold packs (compressed twins) demote to the remote tier when
    hot+pack exceeds the budget; refetch decompresses straight from the
    remote zpack."""
    storage, store, doc, fps, payloads = _publish(tmp_path)
    remote = str(tmp_path / "remote")
    monkeypatch.setenv("MAKISU_TPU_STORAGE_REMOTE", remote)
    cstore = contentstore.store_for(storage)
    result = cstore.evict(budget_bytes=1)
    assert result["packs_demoted"] == 1
    pack_hex = doc["chunks"][0][2]
    assert os.path.isfile(os.path.join(remote, "zpacks",
                                       f"{pack_hex}.zst"))
    assert not os.path.isfile(os.path.join(storage, "serve", "zpacks",
                                           f"{pack_hex}.zst"))
    triples = [(0, 1000, fps[0]), (1000, 3000, fps[1]),
               (4000, 2000, fps[2])]
    assert store.ensure_available(triples)
    for fp, data in zip(fps, payloads):
        assert store.get(fp) == data


def test_audit_clean_after_demotion(tmp_path, monkeypatch):
    """A post-eviction ``doctor --storage`` audit reports no error:
    demoted chunks are classified, not flagged."""
    if not zstdio.available():
        remote = str(tmp_path / "remote")
        monkeypatch.setenv("MAKISU_TPU_STORAGE_REMOTE", remote)
    storage, store, doc, fps, payloads = _publish(tmp_path)
    contentstore.store_for(storage).evict(budget_bytes=1)
    out = census_mod.StorageCensus(storage).audit()
    errors = [f for f in out["findings"]
              if f.get("severity") == "error"]
    assert errors == []
    assert out["classification"]["chunks"]["demoted"] >= 1


def test_unbudgeted_store_never_evicts(tmp_path):
    storage, store, doc, fps, payloads = _publish(tmp_path)
    cstore = contentstore.store_for(storage)
    assert cstore.evict() == {"skipped": "unbudgeted"}
    assert cstore.maybe_evict() is None
    for fp in fps:
        assert os.path.isfile(_chunk_path(storage, fp))


# -- the pin board moved: one board per storage root --------------------------


def test_one_board_per_storage_root(tmp_path):
    """Every ChunkStore of a root, the content store and the recipe
    store's pack synthesis share one board, keyed by the storage dir
    whether they are handed the dir or its ``chunks/`` CAS."""
    storage = tmp_path / "storage"
    a = ChunkStore(str(storage / "chunks"))
    b = ChunkStore(str(storage / "chunks"))
    assert a.pins is b.pins
    assert a.pins is contentstore.board_for(str(storage))
    assert a.pins is contentstore.store_for(str(storage)).board
    assert a.pins is contentstore.board_for_chunk_root(
        str(storage / "chunks"))
    other = ChunkStore(str(tmp_path / "other" / "chunks"))
    assert other.pins is not a.pins
    assert not hasattr(chunks_mod, "board_for_chunk_root")
    assert not hasattr(chunks_mod, "_Pins")


# -- gap T2: the tier refetch comes before any wire ---------------------------


@pytest.mark.skipif(not zstdio.available(), reason="no zstd")
def test_ensure_available_refetches_from_zpack_with_no_wire(tmp_path):
    """Demoted chunks come back from their pack's zstd twin with no
    peer and no registry attached: one ``chunk_fetch`` event on the
    ``tier`` route, and the chunk-CAS decision is a partial hit."""
    rng = np.random.default_rng(11)
    payloads = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in rng.integers(2000, 9000, 6)]
    storage, store, doc, fps, payloads = _publish(tmp_path, payloads)
    fleet_peers.reset()
    assert not fleet_peers.available()
    assert store.registry is None
    result = contentstore.store_for(storage).evict(budget_bytes=1)
    assert result["reasons"] == {"demote": 6}
    seen = []
    token = events.add_sink(seen.append)
    try:
        assert store.ensure_available(_triples(payloads, fps))
    finally:
        events.reset_sink(token)
    fetches = [e for e in seen if e.get("type") == "chunk_fetch"]
    assert [e["route"] for e in fetches] == ["tier"]
    assert fetches[0]["fetched"] == 6 and fetches[0]["bytes"] > 0
    for fp, data in zip(fps, payloads):
        with open(_chunk_path(storage, fp), "rb") as f:
            assert f.read() == data


# -- the two packages on one storage dir --------------------------------------


def _seeded_storage(tmp_path, seed=5, n=12):
    """A numpy-seeded published layer with spread mtimes (recency is
    the policy's first key)."""
    rng = np.random.default_rng(seed)
    payloads = [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
                for k in rng.integers(1000, 6000, n)]
    storage, store, doc, fps, payloads = _publish(tmp_path, payloads)
    now = os.path.getmtime(_chunk_path(storage, fps[0]))
    for i, fp in enumerate(fps):
        past = now - float(rng.integers(0, 10_000)) - i
        os.utime(_chunk_path(storage, fp), (past, past))
    return storage, store, doc, fps, payloads


@pytest.mark.parametrize("budget_fraction", [0.0, 0.3, 0.7])
def test_both_evictors_choose_the_same_victims(tmp_path,
                                               budget_fraction):
    storage, store, doc, fps, payloads = _seeded_storage(tmp_path)
    total = sum(len(p) for p in payloads)
    budget = int(total * budget_fraction)
    port = contentstore.store_for(storage).plan(
        budget_bytes=budget, include_candidates=True)
    ref = ref_contentstore.store_for(storage).plan(
        budget_bytes=budget, include_candidates=True)
    for doc_ in (port, ref):
        for v in doc_["would_evict"]:
            v.pop("age_seconds")  # the wall clock of each plan
    assert port == ref
    assert port["evict_count"] > 0


@pytest.mark.skipif(not zstdio.available(), reason="no zstd")
@pytest.mark.parametrize("demoter", ["port", "reference"])
def test_a_demoted_chunk_comes_back_in_the_other_package(tmp_path,
                                                         demoter):
    storage, store, doc, fps, payloads = _seeded_storage(tmp_path, seed=7)
    evictor = (contentstore if demoter == "port" else ref_contentstore)
    result = evictor.store_for(storage).evict(budget_bytes=1)
    assert result["evicted"] == len(fps)
    assert result["reasons"] == {"demote": len(fps)}
    for fp in fps:
        assert not os.path.isfile(_chunk_path(storage, fp))
    cas = os.path.join(storage, "chunks")
    if demoter == "port":
        from makisu_tpu.utils import events as reader_events
        reader = ref_chunks.ChunkStore(cas)
    else:
        reader_events = events
        reader = ChunkStore(cas)
    seen = []
    token = reader_events.add_sink(seen.append)
    try:
        assert reader.ensure_available(_triples(payloads, fps))
    finally:
        reader_events.reset_sink(token)
    for fp, data in zip(fps, payloads):
        with open(_chunk_path(storage, fp), "rb") as f:
            assert f.read() == data
    # Every chunk of the one pack was demoted, so the refetch reads the
    # whole twin: the bytes moved are the zpack's size in both packages.
    (fetch,) = [e for e in seen if e.get("type") == "chunk_fetch"]
    assert fetch["route"] == "tier" and fetch["fetched"] == len(fps)
    pack_hex = doc["chunks"][0][2]
    assert fetch["bytes"] == os.path.getsize(os.path.join(
        storage, "serve", "zpacks", f"{pack_hex}.zst"))
