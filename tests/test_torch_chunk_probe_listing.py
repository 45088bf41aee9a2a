"""The chunk store's dedup probes answered from shard listings
(``makisu_tpu_torch/cache/chunks.py``), on the CPU.

Within one commit-to-index window a CAS shard that the window sent
``list_shard_at(names)`` digests or more (``names``: the size of the
last shard listed) is listed once, and its probes answer from that
listing; other shards stat, as before. The index stores the same chunks
as the reference's stat-per-chunk index; a listing never outlives its
window, nor answers a hit once an entry has left the CAS since it was
read; a stale batch's listing is discarded; and the counter
``makisu_chunk_probes_total{route}`` counts every answer.
"""

import collections
import gzip
import hashlib
import os
import threading
import time

import numpy as np
import pytest

from makisu_tpu.cache import chunks as ref_chunks
from makisu_tpu_torch.cache import ChunkStore, chunks
from makisu_tpu_torch.utils import metrics

# Stores below the CAS's eager-seed cap list their shards at
# construction, not on a background thread: the listdir counts below
# are the probes' alone.
SMALL = 4000


class SyncPool:
    """A pool that runs each task at once, on the caller's thread."""

    def submit(self, fn):
        fn()


class HeldPool:
    """A pool that keeps each task until the test runs it."""

    def __init__(self) -> None:
        self.queued = []

    def submit(self, fn):
        self.queued.append(fn)


def list_at(monkeypatch, k: int) -> None:
    """List a shard once the window has sent it ``k`` digests, whatever
    its size."""
    monkeypatch.setattr(chunks, "list_shard_at", lambda names: k)


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def make_layer(tmp_path, seed: int, n_distinct: int = 600,
               n_chunks: int = 1500):
    """A seeded layer blob of ``n_chunks`` chunks drawn from
    ``n_distinct`` pieces (so digests repeat within the layer); returns
    the pieces, the chunk triples and the blob's path."""
    rng = np.random.default_rng(seed)
    pieces = [rng.integers(0, 256, size=int(rng.integers(64, 512)),
                           dtype=np.uint8).tobytes()
              for _ in range(n_distinct)]
    triples, stream, off = [], [], 0
    for i in rng.integers(0, n_distinct, size=n_chunks):
        data = pieces[int(i)]
        triples.append((off, len(data), sha(data)))
        stream.append(data)
        off += len(data)
    blob = tmp_path / f"layer-{seed}.gz"
    blob.write_bytes(gzip.compress(b"".join(stream), mtime=0))
    return pieces, triples, blob


def cas_names(root) -> set[str]:
    return {name for shard in os.listdir(root) if shard != "_tmp"
            for name in os.listdir(os.path.join(root, shard))}


def demand(triples) -> collections.Counter:
    """Distinct digests per shard."""
    return collections.Counter(h[:2] for h in {h for _, _, h in triples})


class FsCalls:
    """Counts ``os.listdir`` of the CAS's shard directories and
    ``os.path.isfile`` of its chunk paths, by shard and by name."""

    def __init__(self, monkeypatch, root: str) -> None:
        self.root = root
        self.listed = collections.Counter()
        self.stats = collections.Counter()
        listdir, isfile = os.listdir, os.path.isfile

        def counted_listdir(path="."):
            head, shard = os.path.split(str(path))
            if head == root:
                self.listed[shard] += 1
            return listdir(path)

        def counted_isfile(path):
            shard_dir, name = os.path.split(str(path))
            if os.path.dirname(shard_dir) == root:
                self.stats[name] += 1
            return isfile(path)

        monkeypatch.setattr(os, "listdir", counted_listdir)
        monkeypatch.setattr(os.path, "isfile", counted_isfile)


@pytest.fixture
def registry():
    reg = metrics.MetricsRegistry()
    token = metrics.set_build_registry(reg)
    yield reg
    metrics.reset_build_registry(token)


def answers(reg) -> dict[str, int]:
    return {route: int(n) for route, n in reg.counter_by_label(
        metrics.CHUNK_PROBES, "route").items()}


@pytest.mark.parametrize("k", [1, 2, 3, 1 << 30])
@pytest.mark.parametrize("noted", [0, 0.5, 1.0])
@pytest.mark.parametrize("block", [97, 4096, 1 << 20])
def test_index_matches_a_stat_per_chunk_oracle(tmp_path, monkeypatch,
                                               k, noted, block):
    """The same added list and the same CAS files as the reference's
    index (a stat per chunk, a read per chunk), with a share of the
    digests streamed through the observer first and the rest answered
    by the index, and the stream read in blocks smaller and larger than
    a chunk."""
    list_at(monkeypatch, k)
    monkeypatch.setattr(chunks.concurrency, "hash_pool", SyncPool)
    monkeypatch.setattr(ChunkStore, "PROBE_BATCH", 32)
    monkeypatch.setattr(ChunkStore, "INDEX_READ_BLOCK", block)
    pieces, triples, blob = make_layer(tmp_path, 11)
    store = ChunkStore(str(tmp_path / "chunks"))
    ref = ref_chunks.ChunkStore(str(tmp_path / "ref"))
    held = np.random.default_rng(12).random(len(pieces)) < 0.7
    for data, keep in zip(pieces, held):
        if keep:
            store.put(sha(data), data)
            ref.put(sha(data), data)
    for _, _, h in triples[:int(noted * len(triples))]:
        store.note_fingerprint(h)
    added = store.index_layer(str(blob), triples)
    assert added == ref.index_layer(str(blob), triples)
    assert len(added) == len(set(added)) > 0  # repeats stored once
    assert cas_names(tmp_path / "chunks") == cas_names(tmp_path / "ref")
    store.reset_fingerprint_memo()
    assert store.index_layer(str(blob), triples) == []


def test_a_bad_chunk_list_fails_the_index(tmp_path, monkeypatch):
    monkeypatch.setattr(ChunkStore, "INDEX_READ_BLOCK", 1000)
    _, triples, blob = make_layer(tmp_path, 61, n_distinct=50,
                                  n_chunks=80)
    store = ChunkStore(str(tmp_path / "chunks"))
    end = triples[-1][0] + triples[-1][1]
    with pytest.raises(ValueError, match="not offset-sorted"):
        store.index_layer(str(blob), [triples[1], triples[0]])
    for past in ([(end, 10, triples[0][2])],
                 triples + [(end, 10, triples[0][2])]):
        with pytest.raises(ValueError, match=f"stream ended at {end}"):
            ChunkStore(str(tmp_path / "fresh")).index_layer(str(blob), past)


def test_one_listing_per_shard_and_no_stat_in_a_listed_shard(
        tmp_path, monkeypatch):
    """Every digest is noted before a batch runs, so each shard's count
    is final when its first probe is answered."""
    list_at(monkeypatch, 2)
    pool = HeldPool()
    monkeypatch.setattr(chunks.concurrency, "hash_pool", lambda: pool)
    monkeypatch.setattr(ChunkStore, "PROBE_BATCH", 64)
    pieces, triples, blob = make_layer(tmp_path, 21)
    root = str(tmp_path / "chunks")
    store = ChunkStore(root, max_entries=SMALL)
    for data in pieces[::2]:
        store.put(sha(data), data)
    calls = FsCalls(monkeypatch, root)
    for _, _, h in triples:
        store.note_fingerprint(h)
    assert len(pool.queued) > 4
    for task in pool.queued:
        task()
    added = store.index_layer(str(blob), triples)
    per_shard = demand(triples)
    listed = {s for s, n in per_shard.items() if n >= 2}
    assert set(calls.listed) == listed
    assert all(n == 1 for n in calls.listed.values())
    for _, _, h in triples:
        if h[:2] in listed:
            # Only the commit of a new chunk looks at its path (first
            # writer wins), never a probe.
            assert calls.stats[h] == (1 if h in added else 0), h
    stat_shards = {h[:2] for h in calls.stats if h not in added}
    assert stat_shards and not stat_shards & listed


def test_a_chunk_deleted_between_windows_is_stored_again(tmp_path,
                                                         monkeypatch):
    list_at(monkeypatch, 1)
    monkeypatch.setattr(chunks.concurrency, "hash_pool", SyncPool)
    _, triples, blob = make_layer(tmp_path, 31, n_distinct=300,
                                  n_chunks=600)
    root = tmp_path / "chunks"
    store = ChunkStore(str(root), max_entries=SMALL)
    first = store.index_layer(str(blob), triples)
    assert set(first) == {h for _, _, h in triples}
    store.reset_fingerprint_memo()
    gone = first[7]
    os.unlink(root / gone[:2] / gone)
    calls = FsCalls(monkeypatch, str(root))
    assert store.index_layer(str(blob), triples) == [gone]
    assert (root / gone[:2] / gone).is_file()
    assert calls.listed[gone[:2]] == 1
    # Without the reset, the window's listing would still hold it.
    store.reset_fingerprint_memo()
    store.index_layer(str(blob), triples)
    os.unlink(root / gone[:2] / gone)
    assert store.index_layer(str(blob), triples) == []


def test_a_stale_batch_lists_nothing_and_keeps_no_listing(tmp_path,
                                                          monkeypatch):
    """A batch queued before the reset lists nothing; one whose window
    ends while it lists leaves no listing and no memo behind; the next
    window lists afresh."""
    list_at(monkeypatch, 1)
    store = ChunkStore(str(tmp_path / "chunks"), max_entries=SMALL)
    data = [bytes([i % 256, i // 256]) * 50
            for i in range(store.PROBE_BATCH)]
    names = [sha(d) for d in data]
    for name, d in zip(names, data):
        store.put(name, d)
    pool = HeldPool()
    monkeypatch.setattr(chunks.concurrency, "hash_pool", lambda: pool)
    calls = FsCalls(monkeypatch, str(tmp_path / "chunks"))
    for name in names:
        store.note_fingerprint(name)
    store.reset_fingerprint_memo()
    pool.queued.pop()()  # the old window's batch lands late
    assert not calls.listed and store._exists_memo == {}
    assert store._listings == {}

    for name in names:
        store.note_fingerprint(name)
    list_shard = store.cas.list_shard

    def reset_while_listing(shard):
        store.reset_fingerprint_memo()
        return list_shard(shard)

    monkeypatch.setattr(store.cas, "list_shard", reset_while_listing)
    pool.queued.pop()()
    assert store._listings == {} and store._exists_memo == {}
    monkeypatch.setattr(store.cas, "list_shard", list_shard)

    for name in names:
        store.note_fingerprint(name)
    listed_before = sum(calls.listed.values())
    pool.queued.pop()()
    assert all(store._exists_memo[n] for n in names)
    assert sum(calls.listed.values()) - listed_before == len(
        {n[:2] for n in names})


def test_shards_below_the_threshold_stat(tmp_path, monkeypatch, registry):
    list_at(monkeypatch, 4)
    monkeypatch.setattr(chunks.concurrency, "hash_pool", SyncPool)
    pieces, triples, blob = make_layer(tmp_path, 41, n_distinct=700,
                                       n_chunks=900)
    root = str(tmp_path / "chunks")
    store = ChunkStore(root, max_entries=SMALL)
    for data in pieces[:350]:
        store.put(sha(data), data)
    calls = FsCalls(monkeypatch, root)
    added = store.index_layer(str(blob), triples)
    per_shard = demand(triples)
    below = {s for s, n in per_shard.items() if n < 4}
    assert below and set(calls.listed) == set(per_shard) - below
    occurrences = collections.Counter(h for _, _, h in triples)
    for h, n in occurrences.items():
        if h[:2] in below:
            # One stat a chunk, plus the commit of a new one.
            assert calls.stats[h] == n + (h in added), h
    routes = answers(registry)
    assert routes["stat"] == sum(n for h, n in occurrences.items()
                                 if h[:2] in below)
    assert routes["listing"] == len(triples) - routes["stat"]
    # The reference's tally stays one count per chunk.
    assert registry.counter_total("makisu_chunk_exists_prefetch_total",
                                  result="probe") == len(triples)


def test_the_routes_add_up_to_the_answers(tmp_path, monkeypatch, registry):
    """Pool batches (on the real pool, counting into the build's
    registry) and the index's own answers: listing + stat is every
    answer given; listings are counted once each."""
    list_at(monkeypatch, 2)
    monkeypatch.setattr(ChunkStore, "PROBE_BATCH", 100)
    pieces, triples, blob = make_layer(tmp_path, 51)
    root = str(tmp_path / "chunks")
    store = ChunkStore(root, max_entries=SMALL)
    for data in pieces[::3]:
        store.put(sha(data), data)
    calls = FsCalls(monkeypatch, root)
    distinct = list(dict.fromkeys(h for _, _, h in triples))
    for h in distinct:
        store.note_fingerprint(h)
    batched = len(distinct) // 100 * 100
    deadline = time.monotonic() + 30
    while sum(answers(registry).values()) < batched:
        assert time.monotonic() < deadline, answers(registry)
        time.sleep(0.01)
    memo = dict(store._exists_memo)
    store.index_layer(str(blob), triples)
    store.reset_fingerprint_memo()
    probes = registry.counter_total("makisu_chunk_exists_prefetch_total",
                                    result="probe")
    hits = registry.counter_total("makisu_chunk_exists_prefetch_total",
                                  result="hit")
    assert probes + hits == len(triples)
    # The index answers each chunk whose digest the batches did not find.
    assert sum(answers(registry).values()) == batched + sum(
        not memo.get(h) for _, _, h in triples)
    assert registry.counter_total(metrics.CHUNK_SHARD_LISTINGS) == sum(
        calls.listed.values()) == len(calls.listed)
    assert answers(registry)["listing"] > 0


def test_concurrent_batches_share_one_listing_per_shard(tmp_path,
                                                        monkeypatch):
    """More batches than cores at once, with a short switch interval:
    each shard is listed once, the others wait for it, and every stored
    digest is memoized."""
    import sys
    list_at(monkeypatch, 1)
    root = str(tmp_path / "chunks")
    store = ChunkStore(root, max_entries=SMALL)
    n_batches = (os.cpu_count() or 1) + 4
    data = [i.to_bytes(4, "big") * 40
            for i in range(n_batches * store.PROBE_BATCH)]
    names = [sha(d) for d in data]
    for name, d in zip(names[::2], data[::2]):
        store.put(name, d)
    pool = HeldPool()
    monkeypatch.setattr(chunks.concurrency, "hash_pool", lambda: pool)
    calls = FsCalls(monkeypatch, root)
    list_shard = store.cas.list_shard

    def slow_list(shard):
        time.sleep(0.002)
        return list_shard(shard)

    monkeypatch.setattr(store.cas, "list_shard", slow_list)
    for name in names:
        store.note_fingerprint(name)
    assert len(pool.queued) == n_batches
    threads = [threading.Thread(target=fn) for fn in pool.queued]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert set(calls.listed) == {n[:2] for n in names}
    assert all(n == 1 for n in calls.listed.values())
    assert {n for n, hit in store._exists_memo.items() if hit} == set(
        names[::2])


@pytest.mark.parametrize("how", ["delete", "evict"])
def test_a_chunk_removed_after_its_shard_was_listed_is_stored(
        tmp_path, monkeypatch, registry, how):
    """A listing read before an entry left the CAS (the budget
    evictor's delete, or the CAS's own LRU eviction) answers no hit for
    it afterwards: the index stats, finds the chunk gone and stores it
    again."""
    list_at(monkeypatch, 1)
    monkeypatch.setattr(chunks.concurrency, "hash_pool", SyncPool)
    monkeypatch.setattr(ChunkStore, "PROBE_BATCH", 1)
    pieces, triples, blob = make_layer(tmp_path, 81, n_distinct=300,
                                       n_chunks=600)
    root = tmp_path / "chunks"
    store = ChunkStore(str(root), max_entries=len(pieces))
    for data in pieces:
        store.put(sha(data), data)
    shard = next(s for s, n in demand(triples).items() if n > 1)
    noted, gone = [h for h in dict.fromkeys(h for _, _, h in triples)
                   if h[:2] == shard][:2]
    store.note_fingerprint(noted)  # its batch lists the shard
    assert store._listings[shard].ready.is_set()
    assert gone in store._listings[shard].names
    if how == "delete":
        store.cas.delete(gone)
    else:
        store.cas._last_access[gone] = 0.0  # the oldest entry
        extra = b"one entry past the cap"
        store.cas.write_bytes(sha(extra), extra)
        store.cas.max_entries = 1 << 20
    assert not (root / shard / gone).exists()
    assert store.index_layer(str(blob), triples) == [gone]
    assert (root / shard / gone).is_file()
    assert answers(registry)["stat"] > 0


def test_the_listing_threshold_grows_with_the_shard():
    """The card's measurement in the constants: a shard the size of the
    edit cell's (~67 names) is listed at 5 digests; at the chunk CAS's
    full size (MAX_ENTRIES / 256 names a shard) a layer that sends a
    shard ~8 digests (2k chunks) or ~127 (a 256 MiB layer) stats, and
    one that sends ~2k (a 4 GiB layer) lists."""
    sizes = [0, 16, 67, 256, 1024, 4096, 16384]
    ks = [chunks.list_shard_at(n) for n in sizes]
    assert ks == sorted(ks) and ks[0] == 1
    assert chunks.list_shard_at(67) == 5
    assert 127 < chunks.list_shard_at(ChunkStore.MAX_ENTRIES // 256) < 2000


def test_the_threshold_follows_the_last_listing(tmp_path, monkeypatch):
    """The store sizes its shards by its last listing, across windows:
    once it has listed a shard that is larger than a sparse window's
    demand pays for, the other shards stat, in that window and the
    next."""
    monkeypatch.setattr(chunks, "list_shard_at",
                        lambda names: 2 if names < 5 else 100)
    monkeypatch.setattr(chunks.concurrency, "hash_pool", SyncPool)
    _, triples, blob = make_layer(tmp_path, 71)
    root = str(tmp_path / "chunks")
    store = ChunkStore(root, max_entries=SMALL)
    rng = np.random.default_rng(72)
    for _ in range(3000):  # ~12 names a shard
        data = rng.bytes(64)
        store.put(sha(data), data)
    calls = FsCalls(monkeypatch, root)
    distinct = list(dict.fromkeys(h for _, _, h in triples))
    assert store.index_layer(str(blob), triples) == distinct
    assert len(calls.listed) == 1 and store._shard_names > 5
    store.reset_fingerprint_memo()
    assert store.index_layer(str(blob), triples) == []
    assert len(calls.listed) == 1
