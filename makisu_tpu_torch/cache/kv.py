"""Key-value stores backing the layer cache.

Copy of ``makisu_tpu/cache/kv.py``: the in-memory store, the file store
(``<storage>/cache_key_value.json``, the same format, so a storage dir is
shared with makisu_tpu builds), the Redis store (RESP2 over a socket)
and the HTTP store, which share their entries with makisu_tpu builders
pointed at the same Redis or HTTP endpoint. Reference:
lib/cache/keyvalue/ (the Store interface store.go:22-26; fsStore with
TTL eviction + atomic writes fs_store.go:44-121; redisStore; httpStore
with custom headers). All stores map cache-ID strings to entry strings
and expose ``get``, ``put`` and ``cleanup``.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request

from makisu_tpu_torch.utils import fileio, metrics


class MemoryStore:
    """In-memory store (tests and single-process builds)."""

    def __init__(self) -> None:
        self._data: dict[str, str] = {}
        self._lock = threading.Lock()

    def get(self, key: str) -> str | None:
        with self._lock:
            return self._data.get(key)

    def put(self, key: str, value: str) -> None:
        with self._lock:
            self._data[key] = value

    def cleanup(self) -> None:
        pass


class FSStore:
    """Single-JSON-file store with TTL eviction on load and atomic
    tmp+rename persistence (reference: fs_store.go)."""

    def __init__(self, path: str, ttl_seconds: float = 336 * 3600) -> None:
        self.path = path
        self.ttl = ttl_seconds
        self._lock = threading.Lock()
        self._data: dict[str, tuple[str, float]] = {}
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return
        now = time.time()
        for key, (value, ts) in raw.items():
            if now - ts < self.ttl:
                self._data[key] = (value, ts)

    def _persist_locked(self) -> None:
        # Atomic + fsynced (unique temp, rename): a SIGTERM mid-save
        # must not truncate the whole KV file — every cached entry of
        # every build sharing this storage dir dies with it. The old
        # fixed ".tmp" name also cross-clobbered under concurrent
        # writers; write_json_atomic's pid+tid temp name cannot.
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fileio.write_json_atomic(self.path, self._data)

    def get(self, key: str) -> str | None:
        with self._lock:
            hit = self._data.get(key)
            if hit is None:
                return None
            value, ts = hit
            if time.time() - ts >= self.ttl:
                del self._data[key]
                return None
            return value

    def put(self, key: str, value: str) -> None:
        with self._lock:
            # Merge-on-write: another process (worker + CLI sharing a
            # storage dir) may have persisted entries since our load;
            # last-writer-wins per KEY instead of per file.
            current = dict(self._data)
            self._data = {}
            self._load()
            self._data.update(current)
            self._data[key] = (value, time.time())
            self._persist_locked()

    def cleanup(self) -> None:
        """Drop expired entries and persist what is left."""
        with self._lock:
            now = time.time()
            self._data = {k: v for k, v in self._data.items()
                          if now - v[1] < self.ttl}
            self._persist_locked()


class RedisError(Exception):
    """Server-reported redis error (a RESP '-' reply)."""


class _RespConnection:
    """Minimal RESP2 client connection: enough protocol for the cache
    plane (AUTH, GET, SET..EX) with no client library. One request and
    reply at a time; callers serialise through their own lock.

    Any transport failure (a timeout mid-reply, a dropped socket) leaves
    the stream position unknowable, so the socket and buffer are dropped
    at once and the next command re-dials. Reusing them would pair a
    retried GET with the stale reply to the previous command, and every
    later reply would be off by one: the wrong cache entry for a key."""

    def __init__(self, host: str, port: int, password: str = "",
                 timeout: float = 10.0) -> None:
        self._host = host
        self._port = port
        self._password = password
        self._timeout = timeout
        self._sock = None
        self._buf = b""
        self._connect()  # fail fast on a bad address or credentials

    def _connect(self) -> None:
        import socket
        self._buf = b""
        self._sock = socket.create_connection(
            (self._host, self._port), timeout=self._timeout)
        if self._password:
            try:
                self._exchange("AUTH", self._password)
            except Exception:
                self._teardown()
                raise

    def _teardown(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:  # pragma: no cover - best effort
                pass
        self._sock = None
        self._buf = b""

    def close(self) -> None:
        self._teardown()

    def command(self, *parts: str | bytes):
        if self._sock is None:
            self._connect()
        try:
            return self._exchange(*parts)
        except RedisError:
            raise  # a server-level error; the stream stays in step
        except Exception:
            # Timeout, reset or malformed framing: the connection's state
            # is unknown, so it is never reused.
            self._teardown()
            raise

    def _exchange(self, *parts: str | bytes):
        out = [b"*%d\r\n" % len(parts)]
        for p in parts:
            if isinstance(p, str):
                p = p.encode()
            out.append(b"$%d\r\n%s\r\n" % (len(p), p))
        self._sock.sendall(b"".join(out))
        return self._read_reply()

    def _read_until_crlf(self) -> bytes:
        while b"\r\n" not in self._buf:
            piece = self._sock.recv(65536)
            if not piece:
                raise ConnectionError("redis connection closed mid-reply")
            self._buf += piece
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:  # the payload and its CRLF
            piece = self._sock.recv(65536)
            if not piece:
                raise ConnectionError("redis connection closed mid-bulk")
            self._buf += piece
        data, self._buf = self._buf[:n], self._buf[n + 2:]
        return data

    def _read_reply(self):
        line = self._read_until_crlf()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RedisError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            return None if n == -1 else self._read_exact(n)
        if kind == b"*":
            n = int(rest)
            return (None if n == -1
                    else [self._read_reply() for _ in range(n)])
        raise ConnectionError(f"malformed RESP reply {line[:40]!r}")


class RedisStore:
    """Redis-backed store with a TTL (reference: redis_store.go, tested
    there against an embedded miniredis). It speaks RESP2 over a socket:
    the cache plane needs only GET, SET..EX and AUTH."""

    def __init__(self, addr: str, ttl_seconds: float = 336 * 3600,
                 password: str = "", timeout: float = 10.0) -> None:
        host, _, port = addr.partition(":")
        self._conn = _RespConnection(host, int(port) if port else 6379,
                                     password=password, timeout=timeout)
        self._lock = threading.Lock()
        self.ttl = int(ttl_seconds)

    def get(self, key: str) -> str | None:
        with self._lock:
            val = self._conn.command("GET", key)
        return val.decode() if val is not None else None

    def put(self, key: str, value: str) -> None:
        with self._lock:
            self._conn.command("SET", key, value, "EX", str(self.ttl))

    def cleanup(self) -> None:
        pass  # redis expires keys itself

    def close(self) -> None:
        self._conn.close()


class HTTPStore:
    """GET and PUT cache entries against an HTTP endpoint (reference:
    http_store.go). ``address`` is ``host:port`` or a URL; the extra
    headers serve caches behind an authenticating proxy."""

    def __init__(self, address: str, headers: dict[str, str] | None = None,
                 timeout: float = 10.0) -> None:
        self.base = address if "://" in address else "http://" + address
        self.headers = dict(headers or {})
        self.timeout = timeout

    def _url(self, key: str) -> str:
        return f"{self.base.rstrip('/')}/{key}"

    def _request_headers(self) -> dict[str, str]:
        # A traceparent on every KV exchange, so a slow lookup correlates
        # with the KV server's request log; the configured headers win on
        # a collision (a proxied cache may pin its own).
        headers = {"traceparent": metrics.current_traceparent()}
        headers.update(self.headers)
        return headers

    def get(self, key: str) -> str | None:
        req = urllib.request.Request(self._url(key),
                                     headers=self._request_headers())
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.read().decode()
        except OSError:
            return None

    def put(self, key: str, value: str) -> None:
        req = urllib.request.Request(
            self._url(key), data=value.encode(), method="PUT",
            headers=self._request_headers())
        with urllib.request.urlopen(req, timeout=self.timeout):
            pass

    def cleanup(self) -> None:
        pass
