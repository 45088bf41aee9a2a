"""The port's KV stores (``makisu_tpu_torch/cache/kv.py``) against an
in-process RESP server and an HTTP KV endpoint, held against the JAX
package's.

Every case of ``tests/test_redis_store.py`` runs against the port's
``RedisStore`` over the same ``MiniRedis`` double (copied here: a TCP
server speaking enough RESP2 for AUTH/GET/SET..EX/TTL/PING, with a clock
that fast-forwards), and the HTTP KV cases of
``tests/test_trace_propagation.py`` against the port's ``HTTPStore``.
Then the two packages share one Redis and one HTTP KV: an entry written
by either is read by the other as the same string and decodes to the
same layer, and a cache manager of either hits the other's push. The
build flags that choose the store are accepted and select Redis, then
HTTP, then the storage's file; and ``--redis-cache-password``'s value
lands in no artifact of a worker build. Every server here is on
127.0.0.1.
"""

import io
import json
import os
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from makisu_tpu.cache import CacheManager as RefCacheManager
from makisu_tpu.cache import kv as ref_kv
from makisu_tpu.cache import manager as ref_manager
from makisu_tpu.chunker import CPUHasher as RefCPUHasher
from makisu_tpu.registry import RegistryClient as RefRegistryClient
from makisu_tpu.registry import RegistryConfig as RefRegistryConfig
from makisu_tpu.storage import ImageStore as RefImageStore
from makisu_tpu_torch import cli
from makisu_tpu_torch.cache import CacheManager, FSStore, HTTPStore
from makisu_tpu_torch.cache import MemoryStore, RedisError, RedisStore
from makisu_tpu_torch.cache import kv as kv_mod
from makisu_tpu_torch.cache import manager as manager_mod
from makisu_tpu_torch.cache.kv import _RespConnection
from makisu_tpu_torch.chunker import CPUHasher
from makisu_tpu_torch.fleet.kv import SharedKVServer
from makisu_tpu_torch.registry import (
    RegistryClient,
    RegistryConfig,
    RegistryFixture,
)
from makisu_tpu_torch.storage import ImageStore
from makisu_tpu_torch.utils import metrics, mountinfo

TRACEPARENT_RE = re.compile(r"^00-([0-9a-f]{32})-([0-9a-f]{16})-01$")


class MiniRedis:
    """Tiny RESP2 server: string keys with per-key expiry, optional
    password, fast-forwardable clock (miniredis's FastForward)."""

    def __init__(self, password: str = "") -> None:
        self.password = password
        self.data: dict[bytes, tuple[bytes, float | None]] = {}
        self.clock_offset = 0.0
        self.stall_once = 0.0  # delay the next reply (timeout tests)
        self.commands: list[list[bytes]] = []
        self._lock = threading.Lock()
        self._server = socket.create_server(("127.0.0.1", 0))
        self.port = self._server.getsockname()[1]
        self._accepting = True
        threading.Thread(target=self._accept_loop, daemon=True).start()

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    def now(self) -> float:
        return time.time() + self.clock_offset

    def fast_forward(self, seconds: float) -> None:
        with self._lock:
            self.clock_offset += seconds

    def close(self) -> None:
        self._accepting = False
        self._server.close()

    # -- protocol ---------------------------------------------------------

    def _accept_loop(self) -> None:
        while self._accepting:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        buf = b""
        authed = not self.password

        def read_line() -> bytes | None:
            nonlocal buf
            while b"\r\n" not in buf:
                piece = conn.recv(65536)
                if not piece:
                    return None
                buf += piece
            line, buf = buf.split(b"\r\n", 1)
            return line

        def read_exact(n: int) -> bytes | None:
            nonlocal buf
            while len(buf) < n + 2:
                piece = conn.recv(65536)
                if not piece:
                    return None
                buf += piece
            data, buf = buf[:n], buf[n + 2:]
            return data

        with conn:
            while True:
                try:
                    line = read_line()
                except OSError:
                    return
                if line is None:
                    return
                assert line[:1] == b"*", line
                parts = []
                for _ in range(int(line[1:])):
                    hdr = read_line()
                    assert hdr[:1] == b"$", hdr
                    parts.append(read_exact(int(hdr[1:])))
                with self._lock:
                    self.commands.append(parts)
                    reply = self._dispatch(parts, authed)
                if parts[0].upper() == b"AUTH" and reply == b"+OK\r\n":
                    authed = True
                stall, self.stall_once = self.stall_once, 0.0
                if stall:
                    time.sleep(stall)
                try:
                    conn.sendall(reply)
                except OSError:
                    return

    def _dispatch(self, parts: list[bytes], authed: bool) -> bytes:
        cmd = parts[0].upper()
        if cmd == b"AUTH":
            if parts[1].decode() == self.password:
                return b"+OK\r\n"
            return b"-WRONGPASS invalid username-password pair\r\n"
        if not authed:
            return b"-NOAUTH Authentication required.\r\n"
        if cmd == b"PING":
            return b"+PONG\r\n"
        if cmd == b"GET":
            hit = self.data.get(parts[1])
            if hit is None:
                return b"$-1\r\n"
            value, expire_at = hit
            if expire_at is not None and self.now() >= expire_at:
                del self.data[parts[1]]
                return b"$-1\r\n"
            return b"$%d\r\n%s\r\n" % (len(value), value)
        if cmd == b"SET":
            expire_at = None
            if len(parts) >= 5 and parts[3].upper() == b"EX":
                expire_at = self.now() + int(parts[4])
            self.data[parts[1]] = (parts[2], expire_at)
            return b"+OK\r\n"
        if cmd == b"TTL":
            hit = self.data.get(parts[1])
            if hit is None:
                return b":-2\r\n"
            _, expire_at = hit
            if expire_at is None:
                return b":-1\r\n"
            return b":%d\r\n" % max(0, round(expire_at - self.now()))
        return b"-ERR unknown command\r\n"


@pytest.fixture
def mini():
    server = MiniRedis()
    yield server
    server.close()


# -- the cases of tests/test_redis_store.py on the port's store ----------------


def test_get_put_roundtrip_and_miss(mini):
    store = RedisStore(mini.addr, ttl_seconds=3600)
    assert store.get("absent") is None
    store.put("cache-id", "entry-value")
    assert store.get("cache-id") == "entry-value"
    store.put("cache-id", "updated")
    assert store.get("cache-id") == "updated"
    store.close()


def test_put_sets_ttl_and_keys_expire(mini):
    store = RedisStore(mini.addr, ttl_seconds=600)
    store.put("k", "v")
    conn = _RespConnection("127.0.0.1", mini.port)
    assert 0 < conn.command("TTL", "k") <= 600
    mini.fast_forward(599)
    assert store.get("k") == "v"
    mini.fast_forward(2)
    assert store.get("k") is None
    conn.close()
    store.close()


def test_auth_required_and_wrong_password(mini):
    mini.password = "sekrit"
    ok = RedisStore(mini.addr, ttl_seconds=60, password="sekrit")
    ok.put("k", "v")
    assert ok.get("k") == "v"
    ok.close()
    with pytest.raises(RedisError, match="WRONGPASS"):
        RedisStore(mini.addr, ttl_seconds=60, password="nope")
    # No password at all: the server refuses commands.
    anon = RedisStore(mini.addr, ttl_seconds=60)
    with pytest.raises(RedisError, match="NOAUTH"):
        anon.put("k", "v")
    anon.close()


def test_concurrent_puts_serialize_on_one_connection(mini):
    store = RedisStore(mini.addr, ttl_seconds=3600)
    errors = []

    def writer(i: int) -> None:
        try:
            for j in range(20):
                store.put(f"key-{i}-{j}", f"val-{i}-{j}")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for i in range(4):
        for j in range(20):
            assert store.get(f"key-{i}-{j}") == f"val-{i}-{j}"
    store.close()


def _commit(hasher, data: bytes):
    out = io.BytesIO()
    sink = hasher.open_layer(out, backend_id="zlib-6")
    sink.write(data)
    commit = sink.finish()
    return commit, out.getvalue()


PACKAGES = {
    "port": (RedisStore, CacheManager, ImageStore, RegistryClient,
             RegistryConfig, CPUHasher),
    "reference": (ref_kv.RedisStore, RefCacheManager, RefImageStore,
                  RefRegistryClient, RefRegistryConfig, RefCPUHasher),
}
PAIRS = [("port", "port"), ("port", "reference"), ("reference", "port")]


@pytest.mark.parametrize("a,b", PAIRS,
                         ids=["port", "port-to-ref", "ref-to-port"])
def test_cache_manager_over_redis_roundtrip(mini, tmp_path, a, b):
    """One builder pushes a layer commit through a redis-backed cache
    manager, a second builder (its own store) pulls it: the reference's
    cross-builder sharing scenario over the wire protocol, also with the
    two builders from different packages."""
    registry = RegistryFixture()  # the shared blob plane; redis holds KV
    kv_cls, mgr_cls, store_cls, client_cls, config_cls, hasher_cls = \
        PACKAGES[a]
    kv_a = kv_cls(mini.addr, ttl_seconds=3600)
    store_a = store_cls(str(tmp_path / "a"))
    mgr_a = mgr_cls(kv_a, store_a, registry_client=client_cls(
        store_a, "registry.test", "team/cache", config=config_cls(),
        transport=registry))
    commit, blob = _commit(hasher_cls(),
                           b"layer bytes for the redis cache plane test")
    store_a.layers.write_bytes(
        commit.digest_pair.gzip_descriptor.digest.hex(), blob)
    mgr_a.push_cache("cache-id-1", commit.digest_pair, commit)
    mgr_a.wait_for_push()

    kv_cls, mgr_cls, store_cls, client_cls, config_cls, _ = PACKAGES[b]
    kv_b = kv_cls(mini.addr, ttl_seconds=3600)
    store_b = store_cls(str(tmp_path / "b"))
    mgr_b = mgr_cls(kv_b, store_b, registry_client=client_cls(
        store_b, "registry.test", "team/cache", config=config_cls(),
        transport=registry))
    pair = mgr_b.pull_cache("cache-id-1")
    assert pair is not None
    assert pair.tar_digest.hex() == commit.digest_pair.tar_digest.hex()
    assert (pair.gzip_descriptor.digest.hex()
            == commit.digest_pair.gzip_descriptor.digest.hex())
    kv_a.close()
    kv_b.close()


def test_dropped_connection_recovers_on_next_command(mini):
    """A dead socket does not kill the cache plane: the failing command
    raises (the cache manager reads a miss) and the next one re-dials."""
    store = RedisStore(mini.addr, ttl_seconds=60)
    store.put("k", "v1")
    store._conn._sock.close()  # the connection drops
    with pytest.raises(OSError):
        store.get("k")
    assert store.get("k") == "v1"  # re-dialled
    store.close()


def test_timeout_mid_reply_never_desyncs(mini):
    """A reply that arrives after the client timed out is never read as
    the answer to a later command: the connection is dropped on timeout,
    so the next GETs run on a fresh socket and map keys to their own
    values."""
    store = RedisStore(mini.addr, ttl_seconds=60, timeout=0.3)
    store.put("a", "value-a")
    store.put("b", "value-b")
    mini.stall_once = 1.0  # the server answers the next command late
    with pytest.raises(OSError):  # socket.timeout is an OSError
        store.get("a")
    assert store.get("b") == "value-b"
    assert store.get("a") == "value-a"
    store.close()


def test_malformed_reply_discards_connection(mini):
    """Garbage framing from the server raises and drops the connection,
    never hangs or misparses."""
    store = RedisStore(mini.addr, ttl_seconds=60)
    store.put("k", "v")
    rogue = socket.create_server(("127.0.0.1", 0))

    def answer_garbage():
        conn, _ = rogue.accept()
        conn.recv(65536)
        conn.sendall(b"NOT RESP AT ALL\r\n")
        conn.close()

    threading.Thread(target=answer_garbage, daemon=True).start()
    conn = _RespConnection("127.0.0.1", rogue.getsockname()[1])
    with pytest.raises((ConnectionError, OSError)):
        conn.command("GET", "k")
    assert conn._sock is None  # dropped, not reused
    rogue.close()
    store.close()


# -- both packages on one Redis ------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_redis_entries_shared_both_ways(mini, writer):
    """A KV entry written by one package's encoder and store reads back
    through the other's as the same string, decoding to the same layer,
    chunk list and gzip backend; both send the same SET command."""
    from types import SimpleNamespace
    base, _ = _commit(CPUHasher(), b"shared entry payload " * 64)
    chunks = [[0, 700, "ab" * 32], [700, 644, "cd" * 32]]
    commit = SimpleNamespace(gzip_backend_id="zlib-6", chunks=[
        SimpleNamespace(offset=o, length=n, hex_digest=h)
        for o, n, h in chunks])
    port_pair = base.digest_pair
    ref_pair = ref_manager.decode_entry_full(
        manager_mod.encode_entry(port_pair, commit))[0]
    stores = {"port": RedisStore(mini.addr, ttl_seconds=120),
              "reference": ref_kv.RedisStore(mini.addr, ttl_seconds=120)}
    entries = {"port": manager_mod.encode_entry(port_pair, commit),
               "reference": ref_manager.encode_entry(ref_pair, commit)}
    assert entries["port"] == entries["reference"]
    reader = "reference" if writer == "port" else "port"
    stores[writer].put("cid", entries[writer])
    got = stores[reader].get("cid")
    assert got == entries[writer]
    decode = {"port": manager_mod.decode_entry_full,
              "reference": ref_manager.decode_entry_full}[reader]
    pair, got_chunks, gz, packs = decode(got)
    assert pair.gzip_descriptor.digest.hex() == \
        port_pair.gzip_descriptor.digest.hex()
    assert pair.tar_digest.hex() == port_pair.tar_digest.hex()
    assert (got_chunks, gz, packs) == (chunks, "zlib-6", [])
    sets = [c for c in mini.commands if c[0] == b"SET"]
    assert sets == [[b"SET", b"cid", got.encode(), b"EX", b"120"]]
    for store in stores.values():
        store.close()


# -- the HTTP store --------------------------------------------------------------


class _RecordingKVServer:
    """A tiny HTTP KV (GET/PUT by path) that records each request's
    method, path and traceparent."""

    def __init__(self) -> None:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _record(self):
                with outer.lock:
                    outer.requests.append(
                        (self.command, self.path,
                         self.headers.get("traceparent", "")))

            def do_GET(self):
                self._record()
                with outer.lock:
                    value = outer.data.get(self.path)
                if value is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(value)))
                self.end_headers()
                self.wfile.write(value)

            def do_PUT(self):
                self._record()
                n = int(self.headers.get("Content-Length") or 0)
                with outer.lock:
                    outer.data[self.path] = self.rfile.read(n)
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.data: dict[str, bytes] = {}
        self.requests: list[tuple[str, str, str]] = []
        self.lock = threading.Lock()
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def addr(self) -> str:
        host, port = self.server.server_address[:2]
        return f"{host}:{port}"

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


@pytest.fixture
def kv_server():
    server = _RecordingKVServer()
    yield server
    server.stop()


def test_http_kv_store_carries_traceparent(kv_server):
    reg = metrics.MetricsRegistry()
    token = metrics.set_build_registry(reg)
    try:
        store = HTTPStore(kv_server.addr)
        store.put("k1", "v1")
        assert store.get("k1") == "v1"
    finally:
        metrics.reset_build_registry(token)
    assert len(kv_server.requests) == 2
    for _method, _path, header in kv_server.requests:
        match = TRACEPARENT_RE.match(header)
        assert match and match.group(1) == reg.trace_id


def test_http_kv_store_configured_headers_win(kv_server):
    store = HTTPStore(kv_server.addr,
                      headers={"traceparent": "pinned-by-operator"})
    store.put("k2", "v2")
    assert kv_server.requests[-1][2] == "pinned-by-operator"


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_http_kv_entries_shared_both_ways(kv_server, writer):
    """The same request lines from both packages' HTTP stores, and an
    entry PUT by one reads back through the other; a miss is None."""
    stores = {"port": HTTPStore(kv_server.addr, headers={"X-Auth": "t"}),
              "reference": ref_kv.HTTPStore(kv_server.addr,
                                            headers={"X-Auth": "t"})}
    reader = "reference" if writer == "port" else "port"
    stores[writer].put("cid-http", "entry-from-" + writer)
    assert stores[reader].get("cid-http") == "entry-from-" + writer
    assert stores[reader].get("absent") is None
    assert [r[:2] for r in kv_server.requests] == [
        ("PUT", "/cid-http"), ("GET", "/cid-http"), ("GET", "/absent")]


def test_shared_kv_server_matches_the_reference_wire(tmp_path):
    """The port's SharedKVServer answers both packages' HTTP stores:
    200 with the value, 404 (None) for a miss, and counts its entries."""
    server = SharedKVServer()
    addr = server.start()
    try:
        HTTPStore(addr).put("a", "1")
        ref_kv.HTTPStore(addr).put("b", "2")
        assert ref_kv.HTTPStore(addr).get("a") == "1"
        assert HTTPStore(addr).get("b") == "2"
        assert HTTPStore(addr).get("c") is None
        assert server.entry_count() == 2
    finally:
        server.stop()


# -- the store interface and the CLI's choice --------------------------------------


def test_every_store_has_the_reference_interface(tmp_path, mini, kv_server):
    """get, put and cleanup on all four stores, as the reference's; the
    file store's cleanup drops expired entries and persists the rest in
    the reference's format."""
    stores = [MemoryStore(), FSStore(str(tmp_path / "kv.json"), 60),
              RedisStore(mini.addr, 60), HTTPStore(kv_server.addr)]
    for store in stores:
        store.put("k", "v")
        assert store.get("k") == "v"
        assert store.cleanup() is None
        assert store.get("k") == "v"
    for name in ("MemoryStore", "FSStore", "RedisStore", "HTTPStore"):
        for method in ("get", "put", "cleanup"):
            assert callable(getattr(getattr(kv_mod, name), method))
            assert callable(getattr(getattr(ref_kv, name), method))
    path = str(tmp_path / "ttl.json")
    fs = FSStore(path, ttl_seconds=1000)
    fs.put("old", "x")
    fs.put("new", "y")
    fs._data["old"] = ("x", time.time() - 2000)
    fs.cleanup()
    assert set(json.load(open(path))) == {"new"}
    assert ref_kv.FSStore(path, ttl_seconds=1000).get("new") == "y"
    stores[2].close()


def _args(argv):
    return cli.make_parser().parse_args(argv)


def test_cli_accepts_the_cache_plane_flags_and_picks_the_store(
        tmp_path, mini, kv_server):
    """--redis-cache-addr wins over --http-cache-addr, which wins over
    the storage's file (even with --local-cache-ttl 0); pull --delta and
    --report-out, and serve, parse."""
    store = ImageStore(str(tmp_path / "storage"))
    base = ["build", "ctx", "-t", "a:1"]
    args = _args(base + ["--redis-cache-addr", mini.addr,
                         "--redis-cache-password", "",
                         "--http-cache-addr", kv_server.addr])
    assert isinstance(cli._new_cache_manager(args, store).kv, RedisStore)
    args = _args(base + ["--http-cache-addr", kv_server.addr,
                         "--http-cache-header", "X-Auth: tok",
                         "--http-cache-header", "X-Two:2",
                         "--local-cache-ttl", "0"])
    kv = cli._new_cache_manager(args, store).kv
    assert isinstance(kv, HTTPStore)
    assert kv.headers == {"X-Auth": " tok", "X-Two": "2"}
    args = _args(base)
    assert isinstance(cli._new_cache_manager(args, store).kv, FSStore)
    assert cli._new_cache_manager(_args(base + ["--local-cache-ttl", "0"]),
                                  store) is None
    pull = _args(["pull", "r/x:1", "--delta", "/tmp/s.sock",
                  "--report-out", "r.json"])
    assert (pull.delta, pull.report_out) == ("/tmp/s.sock", "r.json")
    serve = _args(["serve", "--socket", "/tmp/s.sock", "--storage", "d"])
    assert (serve.command, serve.socket, serve.storage) == \
        ("serve", "/tmp/s.sock", "d")


def test_redis_password_in_no_artifact_of_a_worker_build(tmp_path):
    """--redis-cache-password's value appears in no event, history
    record, metrics report, ledger, trace, flight-recorder bundle,
    /builds row or log line of a worker build, failed or not."""
    from makisu_tpu_torch.worker import WorkerClient, WorkerServer
    secret = "s3cr3t-PASSWORD-x9"
    redis = MiniRedis(password=secret)
    mountinfo.set_mountpoints_for_testing(set())
    server = WorkerServer(str(tmp_path / "w.sock"), device="cpu")
    thread = server.serve_background()
    try:
        ctx = tmp_path / "ctx"
        ctx.mkdir()
        (ctx / "Dockerfile").write_text("FROM scratch\nCOPY f /f\n")
        (ctx / "f").write_bytes(np.random.default_rng(5).integers(
            0, 256, 40_000, dtype=np.uint8).tobytes())
        art = tmp_path / "art"
        art.mkdir()
        lines = []
        client = WorkerClient(server.socket_path)
        for i, target in enumerate(("", "no-such-stage")):
            root = tmp_path / f"root{i}"
            root.mkdir()
            argv = []
            for k in ("metrics", "events", "explain", "history", "trace",
                      "profile", "diag"):
                argv += [f"--{k}-out", str(art / f"{k}{i}.out")]
            argv += ["build", str(ctx), "-t", "sec/app:1", "--hasher", "gpu",
                     "--storage", str(tmp_path / "storage"),
                     "--root", str(root), "--redis-cache-addr", redis.addr,
                     "--redis-cache-password", secret]
            if target:
                argv += ["--target", target]
            code = client.build(argv, on_line=lines.append,
                                on_event=lines.append)
            assert code == (1 if target else 0)
        assert any(c[0] == b"AUTH" for c in redis.commands)
        assert any(c[0] == b"SET" and c[3:4] == [b"EX"]
                   for c in redis.commands)
        written = sorted(p.name for p in art.iterdir())
        assert {"metrics0.out", "events0.out", "history0.out",
                "diag1.out"} <= set(written), written
        for path in art.iterdir():
            assert secret not in path.read_text(errors="replace"), path.name
        for path in (tmp_path / "storage").rglob("*.json"):
            assert secret not in path.read_text(errors="replace"), path
        assert secret not in json.dumps(lines, default=str)
        assert secret not in json.dumps(client.builds(), default=str)
        assert secret not in json.dumps(client.healthz(), default=str)
        # The worker's own flight recorder, as a SIGTERM dump would write.
        assert secret not in json.dumps(
            server.recorder.bundle("signal"), default=str)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
        redis.close()
        mountinfo.set_mountpoints_for_testing(None)
