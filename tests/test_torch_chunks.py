"""The port's chunk dedup (``makisu_tpu_torch/cache/chunks.py``) against
the JAX package's, on the CPU.

The chunk CAS is shared state: a storage dir built by either builder
gives the other a chunk-route hit once a layer blob is gone, and the
blob reconstituted for ``--dest`` is byte-identical to the deleted one.
Built from the same contexts into separate storages, both builders index
the same chunk files and report the same counts. The local-plane cases
of ``tests/test_chunk_dedup.py`` are mirrored on the port's
``ChunkStore``.
"""

import gzip
import hashlib
import io
import json
import os
import tarfile
import threading
import time
import tracemalloc

import numpy as np
import pytest

from makisu_tpu import tario as ref_tario
from makisu_tpu.cache import chunks as ref_chunks
from makisu_tpu.snapshot import memfs as ref_memfs
from makisu_tpu.storage import cas as ref_cas
from makisu_tpu_torch.cache import (
    CacheManager,
    ChunkStore,
    MemoryStore,
    attach_chunk_dedup,
    chunks,
)
from makisu_tpu_torch.chunker import cdc
from makisu_tpu_torch.chunker.hasher import GPUHasher
from makisu_tpu_torch.docker.image import (
    MEDIA_TYPE_LAYER,
    Descriptor,
    Digest,
    DigestPair,
)
from makisu_tpu_torch.snapshot import memfs
from makisu_tpu_torch.storage import ImageStore
from makisu_tpu_torch.storage.cas import CASStore
from makisu_tpu_torch.utils import mountinfo
from tests.test_torch_build import (  # noqa: F401 - fresh_sessions
    DOCKERFILE_COPY,
    count_lines,
    fresh_sessions,
    kv_entries,
    load_image,
    make_context,
    port_build,
    ref_build,
)


@pytest.fixture(autouse=True)
def _close_sessions():
    """The builds' resident sessions (both packages' process-wide
    managers) close after each test, releasing their inotify instances:
    a per-user budget of 128 that every test process shares."""
    yield
    from makisu_tpu.worker import session as ref_session_mod
    from makisu_tpu_torch.worker import session as session_mod
    session_mod.manager().reset()
    ref_session_mod.manager().reset()


@pytest.fixture(autouse=True)
def _no_mounts():
    """Tmp build roots must not inherit the host's mount table."""
    mountinfo.set_mountpoints_for_testing(set())
    yield
    mountinfo.set_mountpoints_for_testing(None)


@pytest.fixture
def no_sync_wait(monkeypatch):
    """Skip MemFS's one-second wait before each commit (COPY-only builds
    do not need it)."""
    monkeypatch.setattr(memfs.MemFS, "_sync", lambda self: None)
    monkeypatch.setattr(ref_memfs.MemFS, "_sync", lambda self: None)


BUILDERS = {"reference": ref_build, "port": port_build}


def small_context(path, seed):
    make_context(path, seed=seed, nfiles=10, blob_kb=(96, 16))
    (path / "Dockerfile").write_text(DOCKERFILE_COPY)


def edit_context(path, seed):
    """Append 16 bytes to a few text files and insert 10 bytes at offset
    4,096 of one binary."""
    rng = np.random.default_rng(seed)
    texts = sorted((path / "app").rglob("*.js"))
    for k in rng.choice(len(texts), size=2, replace=False):
        with open(texts[int(k)], "ab") as f:
            f.write(b"// edited 0123\n")
    blob = path / "blob0.bin"
    data = blob.read_bytes()
    blob.write_bytes(data[:4096] + b"EDITEDEDIT" + data[4096:])


def layer_blob(storage, hex_digest):
    return storage / "layers" / hex_digest[:2] / hex_digest


def cas_files(root):
    """name -> bytes of every file of a chunk CAS."""
    out = {}
    for shard in os.listdir(root):
        if shard == "_tmp":
            continue
        for name in os.listdir(root / shard):
            out[name] = (root / shard / name).read_bytes()
    return out


def indexed_counts(log_path):
    """cache id -> count of each "indexed N new chunks for ID" line."""
    out = {}
    with open(log_path) as f:
        for line in f:
            msg = json.loads(line)["msg"]
            if msg.startswith("indexed "):
                words = msg.split()
                out[words[-1]] = int(words[1])
    return out


def make_pair(tar: bytes, blob: bytes) -> DigestPair:
    return DigestPair(Digest.of_bytes(tar),
                      Descriptor(MEDIA_TYPE_LAYER, len(blob),
                                 Digest.of_bytes(blob)))


def tile(payload: bytes, sizes) -> list:
    """(offset, length, hex) triples tiling ``payload`` in ``sizes``."""
    triples, pos = [], 0
    for n in sizes:
        piece = payload[pos:pos + n]
        triples.append((pos, len(piece), hashlib.sha256(piece).hexdigest()))
        pos += len(piece)
    assert pos == len(payload)
    return triples


# -- the chunk CAS shared across builders ------------------------------------

@pytest.mark.parametrize("first", ["reference", "port"])
def test_chunk_route_hit_across_builders(tmp_path, no_sync_wait, first):
    ctx = tmp_path / "ctx"
    small_context(ctx, seed=11)
    second = "port" if first == "reference" else "reference"
    storage = tmp_path / "storage"
    for d in ("r1", "r2"):
        (tmp_path / d).mkdir()
    log1, log2 = tmp_path / "first.log", tmp_path / "second.log"
    assert BUILDERS[first](ctx, storage, tmp_path / "r1", log=log1) == 0
    manifest, config = load_image(storage)
    assert count_lines(log1, "indexed ") == len(manifest["layers"]) == 3
    deleted = {}
    for desc in manifest["layers"]:
        hex_digest = desc["digest"].split(":")[1]
        deleted[hex_digest] = layer_blob(storage, hex_digest).read_bytes()
        layer_blob(storage, hex_digest).unlink()

    dest = tmp_path / "image.tar"
    assert BUILDERS[second](ctx, storage, tmp_path / "r2", "--dest",
                            str(dest), log=log2) == 0
    assert count_lines(log2, "committed layer") == 0
    assert count_lines(log2, "(lazy: ") == 3
    assert count_lines(log2, "chunks (no blob, no gzip)") == 3
    assert count_lines(log2, "reconstituted layer") == 3
    rebuilt, rebuilt_config = load_image(storage)
    assert rebuilt["layers"] == manifest["layers"]
    assert rebuilt_config["rootfs"] == config["rootfs"]
    for hex_digest, blob in deleted.items():
        assert layer_blob(storage, hex_digest).read_bytes() == blob
    with tarfile.open(dest) as tf:
        [export] = json.load(tf.extractfile("manifest.json"))
        diff_ids = ["sha256:" + hashlib.sha256(
            tf.extractfile(name).read()).hexdigest()
            for name in export["Layers"]]
    assert diff_ids == config["rootfs"]["diff_ids"]


def test_builders_index_the_same_chunks(tmp_path, no_sync_wait):
    """v1, then an edited v2, into separate storages: the two chunk CASes
    hold the same files, and every "indexed N new chunks" count agrees."""
    ctx = tmp_path / "ctx"
    small_context(ctx, seed=12)
    for d in ("r1", "r2", "r3", "r4"):
        (tmp_path / d).mkdir()
    logs = {}
    for version, roots in (("v1", ("r1", "r2")), ("v2", ("r3", "r4"))):
        if version == "v2":
            edit_context(ctx, seed=13)
        for name, root in zip(("reference", "port"), roots):
            log = tmp_path / f"{name}-{version}.log"
            assert BUILDERS[name](ctx, tmp_path / name, tmp_path / root,
                                  log=log) == 0
            logs[name, version] = indexed_counts(log)
    ref_files = cas_files(tmp_path / "reference" / "chunks")
    port_files = cas_files(tmp_path / "port" / "chunks")
    assert sorted(port_files) == sorted(ref_files)
    assert port_files == ref_files
    assert all(hashlib.sha256(b).hexdigest() == n
               for n, b in port_files.items())
    for version in ("v1", "v2"):
        assert logs["port", version] == logs["reference", version]
        assert logs["port", version]
    assert kv_entries(tmp_path / "port") == kv_entries(tmp_path / "reference")
    # The edits miss the first step, so v2 recommits all three layers and
    # indexes only what the edits made new; the line's fields account
    # for every byte.
    with open(tmp_path / "port-v2.log") as f:
        recs = [r for r in map(json.loads, f)
                if r["msg"].startswith("indexed ")]
    assert len(recs) == 3
    for r in recs:
        assert r["bytes_added"] + r["bytes_reused"] == r["bytes_total"]
        assert r["msg"].startswith(f"indexed {r['added']} new chunks")
    assert any(0 < r["added"] < r["chunks"] for r in recs)
    assert 0 < sum(r["bytes_added"] for r in recs) \
        < 0.5 * sum(r["bytes_total"] for r in recs)


def test_coverage_after_small_edit(tmp_path, no_sync_wait):
    """An edited context built into a second storage: most of its layer's
    bytes are already chunks of the first storage's CAS."""
    ctx = tmp_path / "ctx"
    small_context(ctx, seed=16)
    for d in ("r1", "r2"):
        (tmp_path / d).mkdir()
    assert port_build(ctx, tmp_path / "s1", tmp_path / "r1") == 0
    edit_context(ctx, seed=17)
    assert port_build(ctx, tmp_path / "s2", tmp_path / "r2") == 0
    old = ChunkStore(str(tmp_path / "s1" / "chunks"))
    ref_old = ref_chunks.ChunkStore(str(tmp_path / "s1" / "chunks"))
    lists = [[tuple(c) for c in e["chunks"]]
             for e in kv_entries(tmp_path / "s2").values()
             if isinstance(e, dict)]
    covers = [old.coverage(c) for c in lists]
    assert covers == [ref_old.coverage(c) for c in lists]
    assert max(covers) > 0.5 and min(covers) < 1.0


def test_lazy_cache_disabled_materializes_at_pull(tmp_path, no_sync_wait,
                                                  monkeypatch):
    ctx = tmp_path / "ctx"
    small_context(ctx, seed=18)
    for d in ("r1", "r2"):
        (tmp_path / d).mkdir()
    storage = tmp_path / "storage"
    assert port_build(ctx, storage, tmp_path / "r1") == 0
    manifest, _ = load_image(storage)
    blobs = {}
    for desc in manifest["layers"]:
        path = layer_blob(storage, desc["digest"].split(":")[1])
        blobs[path] = path.read_bytes()
        path.unlink()
    monkeypatch.setenv("MAKISU_TPU_LAZY_CACHE", "0")
    log = tmp_path / "log"
    assert port_build(ctx, storage, tmp_path / "r2", log=log) == 0
    assert count_lines(log, "(lazy: ") == 3
    assert count_lines(log, "reconstituted layer") == 3
    assert count_lines(log, "committed layer") == 0
    # Eager: the blobs are back with no --dest and no materialize call,
    # so the layers were applied from the blobs, not from chunks.
    assert count_lines(log, "(no blob, no gzip)") == 0
    assert all(p.read_bytes() == b for p, b in blobs.items())


def test_unusable_gzip_id_degrades_to_a_miss(tmp_path, no_sync_wait):
    ctx = tmp_path / "ctx"
    small_context(ctx, seed=19)
    for d in ("r1", "r2"):
        (tmp_path / d).mkdir()
    storage = tmp_path / "storage"
    assert port_build(ctx, storage, tmp_path / "r1") == 0
    manifest, _ = load_image(storage)
    kv_path = storage / "cache_key_value.json"
    raw = json.loads(kv_path.read_text())
    for key, (value, ts) in raw.items():
        if value.startswith("{"):
            entry = json.loads(value)
            entry["gz"] = "zstd-6"
            raw[key] = [json.dumps(entry, separators=(",", ":")), ts]
    kv_path.write_text(json.dumps(raw))
    for desc in manifest["layers"]:
        layer_blob(storage, desc["digest"].split(":")[1]).unlink()
    log = tmp_path / "log"
    assert port_build(ctx, storage, tmp_path / "r2", log=log) == 0
    assert count_lines(log, "gzip backend 'zstd-6' not replayable") == 1
    assert count_lines(log, " -> ") == 0
    assert count_lines(log, "committed layer") == 3
    assert load_image(storage)[0]["layers"] == manifest["layers"]
    for desc in manifest["layers"]:
        assert layer_blob(storage, desc["digest"].split(":")[1]).exists()


# -- ChunkStore units, each against the reference's --------------------------

def test_put_verifies_digest(tmp_path):
    store = ChunkStore(str(tmp_path / "chunks"))
    with pytest.raises(ValueError):
        store.put("00" * 32, b"not matching")
    with pytest.raises(ValueError):
        ref_chunks.ChunkStore(str(tmp_path / "ref")).put(
            "00" * 32, b"not matching")
    data = b"matching"
    hex_digest = hashlib.sha256(data).hexdigest()
    assert not store.has(hex_digest)
    store.put(hex_digest, data)
    assert store.has(hex_digest) and store.get(hex_digest) == data
    assert store.cas.max_entries == 1 << 20


@pytest.mark.parametrize("fault", ["missing", "gap"])
def test_reconstitute_refuses(tmp_path, fault):
    data = b"x" * 1000
    hex_digest = hashlib.sha256(data).hexdigest()
    pair = make_pair(data * 2, b"")
    triples = [(0, 1000, hex_digest), (1000, 1000, "ab" * 32)] \
        if fault == "missing" else [(0, 1000, hex_digest),
                                    (1500, 1000, hex_digest)]
    store = ChunkStore(str(tmp_path / "chunks"))
    store.put(hex_digest, data)
    ref = ref_chunks.ChunkStore(str(tmp_path / "ref"))
    ref.put(hex_digest, data)
    assert store.reconstitute(pair, triples) is None
    assert ref.reconstitute(pair, triples) is None
    assert os.listdir(tmp_path / "chunks" / "_tmp") == []
    with pytest.raises((ValueError, FileNotFoundError)):
        with store.open_stream(triples) as stream:
            stream.read()


def test_reconstitute_streams_with_bounded_memory(tmp_path):
    """A 64 MiB layer at zlib-1 rebuilds with a heap peak under 16 MiB,
    byte-identical to the reference writer's blob."""
    total, chunk_len = 64 * 1024 * 1024, 256 * 1024
    payload = np.random.default_rng(7).integers(
        0, 256, size=total, dtype=np.uint8).tobytes()
    backend = "zlib-1"
    buf = io.BytesIO()
    with ref_tario.gzip_writer(buf, backend_id=backend) as gz:
        gz.write(payload)
    blob = buf.getvalue()
    pair = make_pair(payload, blob)
    store = ChunkStore(str(tmp_path / "chunks"))
    triples = tile(payload, [chunk_len] * (total // chunk_len))
    for offset, length, hex_digest in triples:
        store.put(hex_digest, payload[offset:offset + length])
    del payload, buf
    tracemalloc.start()
    tracemalloc.reset_peak()
    path = store.reconstitute_to_path(pair, triples, gz_backend=backend)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert path is not None
    try:
        assert os.path.dirname(path) == str(tmp_path / "chunks" / "_tmp")
        with open(path, "rb") as f:
            assert f.read() == blob
    finally:
        os.unlink(path)
    assert peak < 16 * 1024 * 1024, f"peak heap {peak} bytes"


@pytest.mark.parametrize("level", [0, 6])
def test_reconstitute_and_stream_match_the_reference(tmp_path, level):
    """Uneven chunk sizes and a repeated chunk: the same blob as the
    reference's reconstitution (level 0 goes through the fixed-granularity
    writer), and open_stream gives back the tar bytes in any read size."""
    rng = np.random.default_rng(level)
    part = rng.integers(0, 256, size=70_000, dtype=np.uint8).tobytes()
    payload = part + rng.integers(0, 256, size=123_457,
                                  dtype=np.uint8).tobytes() + part
    sizes = [70_000, 1, 65_535, 57_921, 70_000]
    triples = tile(payload, sizes)
    backend = f"zlib-{level}"
    buf = io.BytesIO()
    gz = ref_tario.gzip_writer(buf, backend_id=backend)
    for i in range(0, len(payload), 10_240):  # the tar writer's pieces
        gz.write(payload[i:i + 10_240])
    gz.close()
    blob = buf.getvalue()
    pair = make_pair(payload, blob)
    store = ChunkStore(str(tmp_path / "chunks"))
    ref = ref_chunks.ChunkStore(str(tmp_path / "ref"))
    for offset, length, hex_digest in triples:
        store.put(hex_digest, payload[offset:offset + length])
        ref.put(hex_digest, payload[offset:offset + length])
    assert store.reconstitute(pair, triples, gz_backend=backend) == blob
    assert ref.reconstitute(pair, triples, gz_backend=backend) == blob
    for step in (-1, 1, 4096, 1 << 20):
        with store.open_stream(triples) as stream:
            out = []
            while True:
                piece = stream.read(step)
                out.append(piece)
                if not piece or step < 0:
                    break
        assert b"".join(out) == payload
    assert store.pins.snapshot() == {}


def test_index_layer_matches_the_reference(tmp_path):
    rng = np.random.default_rng(3)
    part = rng.integers(0, 256, size=20_000, dtype=np.uint8).tobytes()
    payload = part + bytes(90_000) + part + rng.integers(
        0, 256, size=50_000, dtype=np.uint8).tobytes()
    triples = tile(payload, [20_000, 45_000, 45_000, 20_000, 50_000])
    blob_path = tmp_path / "layer.gz"
    blob_path.write_bytes(gzip.compress(payload, mtime=0))
    store = ChunkStore(str(tmp_path / "chunks"))
    ref = ref_chunks.ChunkStore(str(tmp_path / "ref"))
    added = store.index_layer(str(blob_path), triples)
    assert added == ref.index_layer(str(blob_path), triples)
    assert len(added) == 3  # the repeats are stored once
    assert cas_files(tmp_path / "chunks") == cas_files(tmp_path / "ref")
    assert store.index_layer(str(blob_path), triples) == []
    # A corrupt trailer fails the index (the drain checks the CRC).
    bad = bytearray(blob_path.read_bytes())
    bad[-6] ^= 0xFF
    blob_path.write_bytes(bytes(bad))
    with pytest.raises(gzip.BadGzipFile):
        ChunkStore(str(tmp_path / "fresh")).index_layer(str(blob_path),
                                                        triples)


def test_ensure_available_counts_a_repeated_digest_once(tmp_path,
                                                        monkeypatch):
    store = ChunkStore(str(tmp_path / "chunks"))
    data = b"x" * 10
    hex_digest = hashlib.sha256(data).hexdigest()
    triples = [(0, 10, hex_digest), (10, 10, hex_digest),
               (20, 10, hex_digest)]
    stats = []
    exists = store.cas.exists
    monkeypatch.setattr(store.cas, "exists",
                        lambda h: stats.append(h) or exists(h))
    assert not store.ensure_available(triples)
    assert stats == [hex_digest]
    store.put(hex_digest, data)
    stats.clear()
    assert store.ensure_available(triples)
    assert stats == [hex_digest]


# -- the fingerprint observer -------------------------------------------------

@pytest.mark.parametrize("workers", ["1", "2"])
def test_observer_bound_with_more_than_one_worker(tmp_path, monkeypatch,
                                                  workers):
    import contextvars
    monkeypatch.setenv("MAKISU_TPU_HASH_WORKERS", workers)
    mgr = CacheManager(MemoryStore(), ImageStore(str(tmp_path / "s")))

    def attach_and_read():
        store = attach_chunk_dedup(mgr, str(tmp_path / "chunks"))
        return store, cdc._chunk_observer.get()

    store, observer = contextvars.copy_context().run(attach_and_read)
    if workers == "1":
        assert observer is None
    else:
        assert observer == store.note_fingerprint
    assert cdc._chunk_observer.get() is None  # the copy kept it


@pytest.mark.parametrize("index", ["indexed", "blob_missing", "corrupt"])
def test_memo_cleared_after_each_push(tmp_path, monkeypatch, index):
    """The streamed memo is reset after every index, even one that
    failed, and the sessions' fingerprints reached it."""
    import contextvars
    monkeypatch.setenv("MAKISU_TPU_HASH_WORKERS", "2")
    monkeypatch.setattr(ChunkStore, "PROBE_BATCH", 4)
    image_store = ImageStore(str(tmp_path / "s"))
    mgr = CacheManager(MemoryStore(), image_store)
    payload = np.random.default_rng(5).integers(
        0, 256, size=200_000, dtype=np.uint8).tobytes()

    def commit_and_push():
        store = attach_chunk_dedup(mgr, str(tmp_path / "chunks"))
        out = io.BytesIO()
        sink = GPUHasher(device="cpu").open_layer(out)
        sink.write(payload)
        commit = sink.finish()
        assert len(store._exists_memo) == len(
            {c.hex_digest for c in commit.chunks}) > 4
        hex_digest = commit.digest_pair.gzip_descriptor.digest.hex()
        blob = out.getvalue()
        if index == "corrupt":
            blob = blob[:-8] + bytes(8)
        if index != "blob_missing":
            image_store.layers.write_bytes(hex_digest, blob)
        gen = store._memo_gen
        if index == "corrupt":
            with pytest.raises(gzip.BadGzipFile):
                mgr.push_cache("id", commit.digest_pair, commit)
        else:
            mgr.push_cache("id", commit.digest_pair, commit)
        assert store._exists_memo == {} and store._probe_queue == []
        assert store._memo_gen == gen + 1
        return store, commit

    store, commit = contextvars.copy_context().run(commit_and_push)
    held = set(cas_files(tmp_path / "chunks"))
    if index == "indexed":
        assert held == {c.hex_digest for c in commit.chunks}
    else:
        assert held <= {c.hex_digest for c in commit.chunks}


def test_stale_probe_batch_is_discarded(tmp_path, monkeypatch):
    store = ChunkStore(str(tmp_path / "chunks"))
    data = [bytes([i]) * 100 for i in range(store.PROBE_BATCH)]
    names = [hashlib.sha256(d).hexdigest() for d in data]
    for name, d in zip(names, data):
        store.put(name, d)
    queued = []

    class HeldPool:
        def submit(self, fn):
            queued.append(fn)

    monkeypatch.setattr(chunks.concurrency, "hash_pool", lambda: HeldPool())
    for name in names:
        store.note_fingerprint(name)
    assert len(queued) == 1
    store.reset_fingerprint_memo()  # the next layer's window begins
    queued[0]()  # the old generation's probe lands late
    assert store._exists_memo == {}
    # A batch of the current generation does land.
    for name in names:
        store.note_fingerprint(name)
    queued[1]()
    assert all(store._exists_memo[n] for n in names)


# -- the CAS: seeding and pins ------------------------------------------------

@pytest.mark.parametrize("cap", [4095, 4096])
def test_cas_seeds_large_stores_in_the_background(tmp_path, cap):
    root = tmp_path / "cas"
    old = CASStore(str(root), cap)
    for i in range(5):
        old.write_bytes(f"{i:02d}name", b"x")
    store = CASStore(str(root), cap)
    ref = ref_cas.CASStore(str(root), cap)
    if cap < 4096:
        assert store._seeded and len(store._last_access) == 5
    else:
        assert not store._seeded and store._last_access == {}
        store.write_bytes("99name", b"y")  # arms the seed
        deadline = time.monotonic() + 30
        while not store._seeded and time.monotonic() < deadline:
            time.sleep(0.01)
        assert store._seeded and len(store._last_access) == 6
    assert ref._seeded == (cap < 4096)
    assert store.size("00name") == 1
    store.delete("00name")
    assert not store.exists("00name") and "00name" not in store._last_access


def test_the_background_seed_lists_names_and_stats_only_to_evict(
        tmp_path, monkeypatch):
    """A large store's seed lists the stored names with no stat each
    (None recency); an eviction then reads their mtimes and ranks by
    them, as the eager seed's map would."""
    root = tmp_path / "cas"
    old = CASStore(str(root), 4096)
    for i in range(5):
        old.write_bytes(f"{i:02d}name", b"x")
        os.utime(root / f"{i:02d}"[:2] / f"{i:02d}name", (100 + i,) * 2)
    store = CASStore(str(root), 4096)
    real, stats = os.path.getmtime, []

    def getmtime(path):
        stats.append(path)
        return real(path)

    monkeypatch.setattr(os.path, "getmtime", getmtime)
    store.write_bytes("99name", b"y")  # arms the seed
    deadline = time.monotonic() + 30
    while not store._seeded and time.monotonic() < deadline:
        time.sleep(0.01)
    assert store._seeded and len(store._last_access) == 6
    assert stats == []
    assert set(store.recency()) == {"99name"}
    assert store.seed_state() == {"state": "seeded", "seeded_entries": 6}
    with store._lock:
        store.max_entries = 3
        store._evict_locked()
    assert len(stats) == 5
    assert sorted(store.keys()) == ["03name", "04name", "99name"]
    assert store.recency() == {"03name": 103.0, "04name": 104.0,
                               "99name": store._last_access["99name"]}


def test_eviction_skips_pinned_entries(tmp_path):
    """Count-LRU with a pin: the oldest unpinned entry goes, as in the
    reference's CAS with the same pin predicate."""
    kept = {}
    for name, cls in (("port", CASStore), ("reference", ref_cas.CASStore)):
        cas = cls(str(tmp_path / name), max_entries=2)
        cas.pin_check = lambda n: n == "a0"
        for k in ("a0", "b0", "c0"):
            cas.write_bytes(k, k.encode())
            time.sleep(0.01)
        kept[name] = sorted(cas.keys())
    assert kept["port"] == kept["reference"] == ["a0", "c0"]

    store = ChunkStore(str(tmp_path / "chunks"), max_entries=2)
    data = [bytes([i]) * 50 for i in range(3)]
    names = [hashlib.sha256(d).hexdigest() for d in data]
    store.put(names[0], data[0])
    time.sleep(0.01)
    store.put(names[1], data[1])
    with store.pins.pinned("chunks", names[0]):
        time.sleep(0.01)
        store.put(names[2], data[2])
    assert sorted(store.cas.keys()) == sorted([names[0], names[2]])


def test_pins_survive_concurrent_readers(tmp_path):
    """Many threads pinning and unpinning the same names leave no count
    behind."""
    import sys
    store = ChunkStore(str(tmp_path / "chunks"))
    names = [f"{i:064x}" for i in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def reader():
            for _ in range(500):
                for n in names:
                    with store.pins.pinned("chunks", n):
                        assert store.pins.chunk_pinned(n)

        threads = [threading.Thread(target=reader) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert store.pins.snapshot() == {}


# -- a malformed packs map from another host's KV entry -----------------------


class _NoWireRegistry:
    """A registry client that fails the test if any request is made."""

    def __getattr__(self, name):
        raise AssertionError(f"registry.{name} called")


@pytest.mark.parametrize("packs", [
    pytest.param([["ab" * 32]], id="row-without-members"),
    pytest.param([["ab" * 32, 5]], id="members-not-a-list"),
    pytest.param(["ab" * 32], id="row-not-a-pair"),
    pytest.param([["ab" * 32, [0, 9]]], id="index-out-of-range"),
])
def test_malformed_packs_map_takes_the_blob_route(tmp_path, packs):
    """A ``packs`` value that is not a list of (hex, [index, ...]) rows
    reports the layer unavailable (so the pull takes the blob route)
    instead of raising, and asks the registry nothing."""
    store = ChunkStore(str(tmp_path / "chunks"))
    store.registry = _NoWireRegistry()
    data = [b"p" * 300, b"q" * 200]
    triples = []
    off = 0
    for d in data:
        triples.append((off, len(d), hashlib.sha256(d).hexdigest()))
        off += len(d)
    assert store.ensure_available(triples, packs=packs) is False
    assert store._fetch_from_packs(triples, packs,
                                   [t[2] for t in triples]) == ([], True)
