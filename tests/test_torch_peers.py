"""The port's peer chunk exchange (``makisu_tpu_torch/fleet/peers.py``)
and the worker's serving surface on the CPU, held against the JAX
package's.

The peer cases of ``tests/test_fleet.py`` and the two fleet cases of
``tests/test_serve.py`` run on in-process port workers
(``WorkerServer(..., device="cpu")``): the fleet front door is not
ported, so the peer map is published to each worker with ``POST
/peers``, as the scheduler would, and the relocated build is simply
sent to the other worker. Then the wire both ways (a port worker fetches
a reference worker's chunks and the reverse), a snapshot staged over the
peer wire, a dead peer skipped, and the slice as a whole: a ``MiniRedis``
KV, the port's ``MiniRegistry``, worker A building and pushing, worker B
hitting A's Redis entries and taking every chunk from A by recipe and
ranged packs, images equal to a reference build of the same context, and
a ``pull --delta`` of an edited version that fetches only its novel
chunks. Byte equality throughout.
"""

import contextvars
import hashlib
import json
import os
import time

import numpy as np
import pytest

from makisu_tpu import cli as ref_cli
from makisu_tpu.fleet import peers as ref_peers
from makisu_tpu.serve import server as ref_serve_server
from makisu_tpu.snapshot import memfs as ref_memfs
from makisu_tpu.utils import metrics as ref_metrics
from makisu_tpu.worker import WorkerServer as RefWorkerServer
from makisu_tpu_torch import cli
from makisu_tpu_torch.cache import chunks as chunks_mod
from makisu_tpu_torch.docker.image import ImageName
from makisu_tpu_torch.fleet import peers as fleet_peers
from makisu_tpu_torch.fleet.kv import SharedKVServer
from makisu_tpu_torch.serve import server as serve_server
from makisu_tpu_torch.snapshot import memfs
from makisu_tpu_torch.storage import ImageStore
from makisu_tpu_torch.tools.miniregistry import MiniRegistry
from makisu_tpu_torch.utils import metrics, mountinfo
from makisu_tpu_torch.worker import WorkerClient, WorkerServer
from makisu_tpu_torch.worker import snapshots as snapshots_mod
from makisu_tpu_torch.worker.client import _UnixHTTPConnection


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
def _clean_planes(monkeypatch):
    """Each test starts with empty peer maps and serve-store registries
    in both packages, publishing on, the session-snapshot plane off (its
    shards ride the per-chunk wire by design; the layer exchange is
    pinned here in isolation), no host mount table, no one-second wait
    before a commit, and MAKISU_TPU_SHARED_HASH restored after the
    workers set it."""
    monkeypatch.setenv("MAKISU_TPU_SERVE", "1")
    monkeypatch.setenv("MAKISU_TPU_SESSION_SNAPSHOT", "0")
    monkeypatch.setenv("MAKISU_TPU_SHARED_HASH", "0")
    for mod in (serve_server, ref_serve_server):
        monkeypatch.setattr(mod, "_publishing", mod._publishing)
    monkeypatch.setattr(memfs.MemFS, "_sync", lambda self: None)
    monkeypatch.setattr(ref_memfs.MemFS, "_sync", lambda self: None)
    mountinfo.set_mountpoints_for_testing(set())
    for mod in (fleet_peers, ref_peers):
        mod.reset()
    for mod in (serve_server, ref_serve_server):
        mod.reset_stores()
    yield
    for mod in (fleet_peers, ref_peers):
        mod.reset()
    for mod in (serve_server, ref_serve_server):
        mod.reset_stores()
    mountinfo.set_mountpoints_for_testing(None)


def _make_ctx(tmp_path, name="ctx", files=4, random_kb=0):
    """test_fleet.py's context; with ``random_kb``, each file is that
    many KiB of seeded random bytes instead (a layer of many chunks)."""
    ctx = tmp_path / name
    (ctx / "src").mkdir(parents=True)
    (ctx / "Dockerfile").write_text("FROM scratch\nCOPY src/ /src/\n")
    rng = np.random.default_rng(len(name))
    for i in range(files):
        if random_kb:
            (ctx / "src" / f"m{i}.bin").write_bytes(rng.integers(
                0, 256, random_kb << 10, dtype=np.uint8).tobytes())
        else:
            (ctx / "src" / f"m{i}.py").write_text(
                f"# {name} {i}\n" + "x=1\n" * 120)
    return ctx


def _build_argv(tmp_path, ctx, worker, kv_addr, hasher="gpu", extra=()):
    root = tmp_path / f"root-{worker}"
    root.mkdir(exist_ok=True)
    argv = ["--log-level", "error", "build", str(ctx),
            "-t", f"fleet/{ctx.name}:1", "--hasher", hasher,
            "--root", str(root),
            "--storage", str(tmp_path / f"{worker}-storage")]
    if kv_addr:
        argv += ["--http-cache-addr", kv_addr]
    return argv + list(extra)


def _digests(storage, tag):
    with ImageStore(str(storage)) as store:
        manifest = store.manifests.load(ImageName.parse(tag))
        return [layer.digest.hex() for layer in manifest.layers]


def _post_peers(sock, peers, version=None):
    conn = _UnixHTTPConnection(sock, 10.0)
    try:
        body = {"peers": list(peers)}
        if version is not None:
            body["version"] = version
        conn.request("POST", "/peers", body=json.dumps(body).encode())
        resp = conn.getresponse()
        assert resp.status == 200
        return json.loads(resp.read())
    finally:
        conn.close()


def _get(sock, path):
    conn = _UnixHTTPConnection(sock, 10.0)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class _Pair:
    """Two in-process workers (A, B), each with its own storage, a shared
    HTTP KV, and the peer map [A, B] published to both."""

    def __init__(self, tmp_path, kinds=("port", "port")):
        self.kv = SharedKVServer()
        self.kv_addr = self.kv.start()
        self.servers = {}
        self.threads = []
        for name, kind in zip("ab", kinds):
            sock = str(tmp_path / f"{name}.sock")
            server = (WorkerServer(sock, device="cpu") if kind == "port"
                      else RefWorkerServer(sock))
            self.threads.append(server.serve_background())
            self.servers[name] = server
        socks = [s.socket_path for s in self.servers.values()]
        for sock in socks:
            assert _post_peers(sock, socks, 1)["applied"] is True

    def client(self, name):
        return WorkerClient(self.servers[name].socket_path)

    def close(self):
        for server in self.servers.values():
            server.shutdown()
            server.server_close()
        for thread in self.threads:
            thread.join(timeout=5)
        self.kv.stop()


@pytest.fixture
def pair(tmp_path):
    p = _Pair(tmp_path)
    yield p
    p.close()


def _serve_counts(g):
    return {
        "peer_hits": g.counter_total(metrics.FLEET_PEER_CHUNK_HITS),
        "pack_requests": g.counter_total(metrics.SERVE_PEER_PACK_REQUESTS),
        "chunk_serves": g.counter_total(metrics.FLEET_CHUNK_SERVES,
                                        result="hit"),
        "packs_served": sum(
            g.counter_total(metrics.SERVE_PACK_REQUESTS, kind=k)
            for k in ("range", "full", "zrange", "zfull")),
    }


def _delta(g, before):
    now = _serve_counts(g)
    return {k: now[k] - before[k] for k in now}


# -- the peer cases of tests/test_fleet.py ---------------------------------------


def test_worker_chunk_endpoint_validates_and_serves(tmp_path):
    server = WorkerServer(str(tmp_path / "w.sock"), device="cpu")
    thread = server.serve_background()
    try:
        store = chunks_mod.ChunkStore(str(tmp_path / "chunk-cas"))
        chunks_mod.register_serving_store(store)
        data = b"peer exchange payload"
        hex_digest = hashlib.sha256(data).hexdigest()
        store.put(hex_digest, data)
        # A registered store the server does not own is not served (an
        # in-process sibling's bytes must not fake the cross-host
        # exchange).
        assert _get(server.socket_path, f"/chunks/{hex_digest}")[0] == 404
        server.add_served_chunk_root(str(tmp_path / "chunk-cas"))
        assert _get(server.socket_path, f"/chunks/{hex_digest}") == \
            (200, data)
        assert _get(server.socket_path, "/chunks/" + "0" * 64)[0] == 404
        assert _get(server.socket_path, "/chunks/../../etc/passwd")[0] == 400
        assert _get(server.socket_path, "/chunks/ABCD")[0] == 400
        # Each answer is a row of the access ring.
        status, body = _get(server.socket_path, "/serve/access")
        rows = json.loads(body)["entries"]
        assert status == 200
        assert [(r["kind"], r["status"]) for r in rows] == [
            ("chunk", 404), ("chunk", 200), ("chunk", 404)]
        assert rows[1]["bytes"] == len(data)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)


def test_peer_map_version_adopted_after_restart(tmp_path):
    """A worker holding map v7 (a previous publisher's) refuses a stale
    v1 and says which version it holds; a publisher republishing past it
    is applied, and /peers and /healthz report the new map."""
    server = WorkerServer(str(tmp_path / "w.sock"), device="cpu")
    thread = server.serve_background()
    try:
        fleet_peers.set_peers(["/tmp/stale-old-worker.sock"], 7)
        resp = _post_peers(server.socket_path, [server.socket_path], 1)
        assert resp == {"applied": False, "version": 7}
        assert fleet_peers.peers() == ("/tmp/stale-old-worker.sock",)
        resp = _post_peers(server.socket_path, [server.socket_path],
                           resp["version"] + 1)
        assert resp == {"applied": True, "version": 8}
        status, body = _get(server.socket_path, "/peers")
        assert status == 200 and json.loads(body) == {
            "version": 8, "peers": [server.socket_path]}
        assert WorkerClient(server.socket_path).healthz()[
            "peer_map_version"] == 8
        # An unversioned map is applied and bumps the version.
        assert _post_peers(server.socket_path, ["x.sock", "x.sock"]) == \
            {"applied": True, "version": 9}
        assert fleet_peers.peers() == ("x.sock",)
        conn = _UnixHTTPConnection(server.socket_path, 10.0)
        conn.request("POST", "/peers", body=b"not json")
        assert conn.getresponse().status == 400
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)


def test_peer_chunk_fetch_hits_before_registry(tmp_path, pair):
    """B builds what A built: it hits the shared KV, misses every chunk
    locally and fetches them from A. No registry is configured at all,
    so the peer route is the only way those bytes could have come."""
    g = metrics.global_registry()
    before = _serve_counts(g)
    ctx = _make_ctx(tmp_path, "peer-ctx")
    assert pair.client("a").build(
        _build_argv(tmp_path, ctx, "a", pair.kv_addr)) == 0
    assert pair.client("b").build(
        _build_argv(tmp_path, ctx, "b", pair.kv_addr)) == 0
    moved = _delta(g, before)
    assert moved["peer_hits"] > 0, "no chunk came from a peer"
    assert moved["chunk_serves"] + moved["packs_served"] > 0, \
        "no worker served a peer fetch"
    tag = f"fleet/{ctx.name}:1"
    assert _digests(tmp_path / "a-storage", tag) == \
        _digests(tmp_path / "b-storage", tag)


# -- the fleet cases of tests/test_serve.py ----------------------------------------


def test_fleet_peer_exchange_is_pack_granular(tmp_path, pair):
    """The relocated build's chunks arrive as ranged pack fetches (the
    peer pack counter; /packs on the serving side), not as per-chunk GETs,
    in fewer requests than chunks; the holder's /healthz counts the
    recipe it published."""
    g = metrics.global_registry()
    before = _serve_counts(g)
    ctx = _make_ctx(tmp_path, "packpeer-ctx", files=6, random_kb=24)
    assert pair.client("a").build(
        _build_argv(tmp_path, ctx, "a", pair.kv_addr)) == 0
    assert pair.client("a").healthz()["serve"]["recipes"] >= 1
    assert pair.client("b").build(
        _build_argv(tmp_path, ctx, "b", pair.kv_addr)) == 0
    moved = _delta(g, before)
    assert moved["pack_requests"] >= 1, "peer exchange never used packs"
    assert moved["packs_served"] >= 1, "no worker served a /packs request"
    assert moved["chunk_serves"] == 0, \
        "per-chunk GETs used despite a published recipe"
    assert moved["pack_requests"] < moved["peer_hits"]
    tag = f"fleet/{ctx.name}:1"
    assert _digests(tmp_path / "a-storage", tag) == \
        _digests(tmp_path / "b-storage", tag)
    # A's ring names each request B's build made, with B's trace id.
    status, body = _get(pair.servers["a"].socket_path, "/serve/access")
    kinds = {r["kind"] for r in json.loads(body)["entries"]}
    assert status == 200 and {"recipe"} <= kinds
    assert kinds & {"pack", "zpack"}


def test_fleet_peer_falls_back_per_chunk_without_recipe(tmp_path, pair,
                                                        monkeypatch):
    """Publishing off (no recipe anywhere): the per-chunk GET route still
    moves the chunks, and no pack request is made."""
    monkeypatch.setenv("MAKISU_TPU_SERVE", "0")
    g = metrics.global_registry()
    before = _serve_counts(g)
    ctx = _make_ctx(tmp_path, "oldpeer-ctx")
    assert pair.client("a").build(
        _build_argv(tmp_path, ctx, "a", pair.kv_addr)) == 0
    assert pair.client("b").build(
        _build_argv(tmp_path, ctx, "b", pair.kv_addr)) == 0
    moved = _delta(g, before)
    assert moved["chunk_serves"] > 0, "per-chunk fallback never served"
    assert moved["pack_requests"] == 0
    tag = f"fleet/{ctx.name}:1"
    assert _digests(tmp_path / "a-storage", tag) == \
        _digests(tmp_path / "b-storage", tag)


# -- the wire both ways, rotation, snapshots ----------------------------------------


@pytest.mark.parametrize("holder,fetcher", [("reference", "port"),
                                            ("port", "reference")],
                         ids=["port-fetches-from-ref",
                              "ref-fetches-from-port"])
def test_peer_wire_both_ways(tmp_path, holder, fetcher):
    """A worker of one package builds (gpu hasher on the port, tpu on
    the reference: the same chunks and cache keys); a worker of the other
    hits its KV entry and takes every chunk over the first's /recipes and
    /packs. The images are equal."""
    pair = _Pair(tmp_path, kinds=(holder, fetcher))
    try:
        ctx = _make_ctx(tmp_path, "wire-ctx", files=6, random_kb=24)
        hashers = {"port": "gpu", "reference": "tpu"}
        # Each package counts its own fetches (the same metric names).
        g = (metrics if fetcher == "port" else ref_metrics).global_registry()
        before = g.counter_total(metrics.SERVE_PEER_PACK_REQUESTS)
        hits = g.counter_total(metrics.FLEET_PEER_CHUNK_HITS)
        assert pair.client("a").build(_build_argv(
            tmp_path, ctx, "a", pair.kv_addr, hashers[holder])) == 0
        assert pair.client("b").build(_build_argv(
            tmp_path, ctx, "b", pair.kv_addr, hashers[fetcher])) == 0
        assert g.counter_total(metrics.SERVE_PEER_PACK_REQUESTS) > before
        assert g.counter_total(metrics.FLEET_PEER_CHUNK_HITS) > hits
        tag = f"fleet/{ctx.name}:1"
        assert _digests(tmp_path / "a-storage", tag) == \
            _digests(tmp_path / "b-storage", tag)
    finally:
        pair.close()


def test_dead_peer_is_skipped_and_backed_off(tmp_path, pair):
    """A peer socket that refuses connections, placed first in the
    rotation, is marked dead and backed off; the chunks come from the
    live peer, by recipe and packs."""
    ctx = _make_ctx(tmp_path, "dead-ctx", random_kb=24)
    assert pair.client("a").build(
        _build_argv(tmp_path, ctx, "a", pair.kv_addr)) == 0
    layer_hex = _digests(tmp_path / "a-storage", f"fleet/{ctx.name}:1")[0]
    rows = _recipe_fps(str(tmp_path / "a-storage"), layer_hex)
    dead = str(tmp_path / "dead.sock")
    live = pair.servers["a"].socket_path
    first_dead = int(layer_hex[:8], 16) % 2 == 0
    fleet_peers.set_peers([dead, live] if first_dead else [live, dead])
    assert fleet_peers._candidates(int(layer_hex[:8], 16))[0] == dead
    store = chunks_mod.ChunkStore(str(tmp_path / "c-storage" / "chunks"))
    got = fleet_peers.fetch_chunks(store.put, sorted(rows), rows,
                                   layer_hex=layer_hex)
    assert got == set(rows)
    assert fleet_peers._dead_until.get(dead, 0) > time.monotonic()
    assert fleet_peers._candidates(0) == [live]
    assert all(store.cas.exists(fp) for fp in rows)


def test_snapshot_stage_pulls_shards_over_the_peer_wire(tmp_path, pair,
                                                        monkeypatch):
    """POST /sessions/restore on B of a recipe whose shard chunks only A
    holds: the stage fetches them from A and lands the recipe."""
    monkeypatch.setenv("MAKISU_TPU_SESSION_SNAPSHOT", "1")
    ctx = _make_ctx(tmp_path, "snap-ctx")
    assert pair.client("a").build(
        _build_argv(tmp_path, ctx, "a", pair.kv_addr)) == 0
    recipe = pair.client("a").session_snapshot(str(ctx))
    assert recipe["shards"]
    b_storage = str(tmp_path / "b-storage")
    os.makedirs(b_storage)
    store_b = snapshots_mod.SnapshotStore(b_storage)
    plan = store_b.shard_plan(recipe)
    assert not any(store_b.chunk_store().cas.exists(h) for _, _, h in plan)
    # Without peers the stage is refused; with them it lands.
    fleet_peers.reset()
    assert store_b.stage(recipe) == (False, "chunks_unavailable")
    socks = [s.socket_path for s in pair.servers.values()]
    fleet_peers.set_peers(socks)
    assert store_b.stage(recipe) == (True, "")
    assert all(store_b.chunk_store().cas.exists(h) for _, _, h in plan)
    assert store_b.load_for_context(str(ctx))["shards"] == recipe["shards"]


# -- the slice as a whole -----------------------------------------------------------


def _write_services(ctx, rng, services=2, files=6):
    ctx.mkdir()
    (ctx / "Dockerfile").write_text("FROM scratch\n" + "".join(
        f"COPY svc{k}/ /srv/svc{k}/ #!COMMIT\n" for k in range(services)))
    for k in range(services):
        (ctx / f"svc{k}").mkdir(parents=True)
        for i in range(files):
            size = int(rng.integers(4_096, 40_000))
            (ctx / f"svc{k}" / f"f{i}.bin").write_bytes(
                rng.integers(0, 256, size, dtype=np.uint8).tobytes())


def _recipe_fps(storage, layer_hex):
    with open(os.path.join(storage, "serve", "recipes",
                           f"{layer_hex}.json")) as f:
        return {row[0]: row[1] for row in json.load(f)["chunks"]}


def test_distribution_slice_end_to_end(tmp_path):
    """Redis KV, loopback registry, workers A and B. A builds v1 and
    pushes; B builds v1 from A's Redis entries alone, every chunk from A
    by recipe and ranged packs (no per-chunk GET); both images equal a
    reference build of the same context. One file of one service edited:
    A builds v2 and pushes, B builds v2 taking only the dirty layer's
    novel chunks from A, and a fresh storage's ``pull --delta`` of v1
    then v2 (A's socket as the serve endpoint) fetches exactly v2's novel
    chunks; its layers equal the registry's digests."""
    from tests.test_torch_redis_store import MiniRedis
    secret = "slice-redis-pw"
    redis = MiniRedis(password=secret)
    pair = _Pair(tmp_path)
    g = metrics.global_registry()
    try:
        with MiniRegistry() as reg:
            ctx = tmp_path / "mono"
            _write_services(ctx, np.random.default_rng(9))
            kv = ["--redis-cache-addr", redis.addr,
                  "--redis-cache-password", secret]

            def build(worker, tag, push):
                root = tmp_path / f"root-{worker}-{tag}"
                root.mkdir()
                argv = ["--log-level", "error", "build", str(ctx), "-t",
                        f"slice/app:{tag}", "--hasher", "gpu",
                        "--commit", "explicit", "--storage",
                        str(tmp_path / f"{worker}-storage"),
                        "--root", str(root)] + kv
                if push:
                    argv += ["--push", reg.addr]
                return pair.client(worker).build(argv)

            assert build("a", "1", True) == 0
            before = _serve_counts(g)
            assert build("b", "1", False) == 0
            moved = _delta(g, before)
            assert moved["pack_requests"] >= 1 and moved["chunk_serves"] == 0
            assert moved["peer_hits"] > moved["pack_requests"]
            a_storage = str(tmp_path / "a-storage")
            v1 = _digests(a_storage, "slice/app:1")
            assert len(v1) == 2
            assert _digests(tmp_path / "b-storage", "slice/app:1") == v1
            assert any(c[0] == b"AUTH" for c in redis.commands)
            # The reference's build of the same context: the same layers.
            (tmp_path / "ref-root").mkdir()
            # In a copy of the context, as a process of its own would:
            # the reference's main binds its chunk observer in place.
            assert contextvars.copy_context().run(ref_cli.main, [
                "build", str(ctx), "-t", "slice/app:1", "--hasher", "tpu",
                "--commit", "explicit", "--storage",
                str(tmp_path / "ref-storage"),
                "--root", str(tmp_path / "ref-root")]) == 0
            assert _digests(tmp_path / "ref-storage", "slice/app:1") == v1

            # Edit one file of svc1: only the second layer changes.
            path = ctx / "svc1" / "f3.bin"
            path.write_bytes(path.read_bytes()[:1000] + b"EDITED" +
                             path.read_bytes()[1000:])
            assert build("a", "2", True) == 0
            v2 = _digests(a_storage, "slice/app:2")
            assert v2[0] == v1[0] and v2[1] != v1[1]
            held = {}
            for hx in v1:
                held.update(_recipe_fps(a_storage, hx))
            novel = {fp: n for fp, n in _recipe_fps(a_storage, v2[1]).items()
                     if fp not in held}
            assert novel
            before = _serve_counts(g)
            assert build("b", "2", False) == 0
            moved = _delta(g, before)
            assert moved["peer_hits"] == len(novel)
            assert moved["chunk_serves"] == 0
            assert _digests(tmp_path / "b-storage", "slice/app:2") == v2

            # Delta pulls into a fresh storage, A's socket serving.
            reports = []
            for tag in ("1", "2"):
                report = str(tmp_path / f"pull{tag}.json")
                assert cli.main([
                    "--log-level", "error", "pull",
                    f"{reg.addr}/slice/app:{tag}", "--storage",
                    str(tmp_path / "c-storage"), "--delta",
                    pair.servers["a"].socket_path, "--report-out",
                    report]) == 0
                reports.append(json.load(open(report)))
            assert reports[0]["delta_layers"] == 2
            rows = {r["layer"]: r for r in reports[1]["layers"]}
            assert rows[v2[0]]["route"] == "local"
            assert rows[v2[1]]["route"] == "delta"
            assert rows[v2[1]]["chunks_missing"] == len(novel)
            # v2's publish packed exactly its novel chunks: the wire moves
            # at most their bytes (fewer where zstd frames win).
            assert 0 < reports[1]["bytes_fetched"] <= sum(novel.values())
            assert reports[1]["fetched_fraction"] < 0.5
            with ImageStore(str(tmp_path / "c-storage")) as store:
                for hx in v2:
                    with store.layers.open(hx) as f:
                        assert hashlib.sha256(f.read()).hexdigest() == hx
    finally:
        pair.close()
        redis.close()
