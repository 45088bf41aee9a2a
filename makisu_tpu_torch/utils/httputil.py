"""HTTP plumbing for the registry/cache clients.

Copy of ``makisu_tpu/utils/httputil.py``, its request and connection
counters, ``traceparent`` header and progress clock included. Reference
capability: lib/utils/httputil/ (option-pattern Send:286 with
accepted-status checking, retry/backoff on 408/5xx and network errors,
TLS client config, https→http fallback :403-421, NetworkError
classification).

The ``Transport`` seam is what makes the registry client hermetically
testable: the real transport speaks http.client over a per-origin
keep-alive connection pool; fixtures replay canned responses in-process
(reference: mocks/net/http + registry fixtures).
"""

from __future__ import annotations

import dataclasses
import http.client
import socket
import ssl
import threading
import time
import urllib.parse
from typing import BinaryIO

from makisu_tpu_torch.utils import metrics

RETRYABLE_CODES = {408, 502, 503, 504}

# Idle keep-alive connections kept per (scheme, host, port). Sized to
# the transfer engine's default concurrency: more idle sockets than
# concurrent requests would just hold fds a registry's LB will time out
# anyway.
POOL_MAX_IDLE = 16


class HTTPError(Exception):
    def __init__(self, status: int, url: str, body: bytes = b"") -> None:
        super().__init__(f"HTTP {status} for {url}: {body[:200]!r}")
        self.status = status
        self.url = url
        self.body = body


class NetworkError(Exception):
    pass


class _StaleConnection(Exception):
    """Internal: a pooled keep-alive connection failed before the
    server can have processed the request (send error, or closed with
    zero response bytes) — retry once on a fresh connection."""


@dataclasses.dataclass
class Response:
    status: int
    headers: dict[str, str]
    body: bytes
    # sha256 of the bytes written to ``stream_to`` (set only when the
    # body streamed to a file) — lets callers verify content digests
    # without a second full read of a multi-GB blob.
    stream_sha256: str = ""

    def header(self, name: str) -> str:
        return self.headers.get(name.lower(), "")


class Transport:
    """Performs one HTTP exchange over a per-origin keep-alive pool.

    Bodies are fully materialized; layer blobs stream via chunked PATCH
    uploads so each exchange stays bounded. Connections are reused
    across requests to the same (scheme, host, port): a registry pull
    of N blobs used to pay N TCP+TLS handshakes — with parallel chunk
    fetches that is thousands of handshakes per build, and handshake
    RTTs, not bytes, dominated the wire time. 3xx responses are
    returned to the caller, never followed (upload Location flows).
    Thread-safe: a connection is checked out for exactly one exchange.

    Known limitation vs the previous urllib transport: http(s)_proxy
    environment variables are not honored — connections go straight to
    the registry host. Registries only reachable through an egress
    proxy need a network-layer proxy (or a transport subclass).
    """

    def __init__(self, tls_verify: bool = True,
                 ca_cert: str | None = None,
                 client_cert: "tuple[str, str | None] | None" = None)\
            -> None:
        # client_cert: (cert_path, key_path); key None = embedded in the
        # cert PEM (load_cert_chain semantics).
        self.tls_verify = tls_verify
        self.ca_cert = ca_cert
        self.client_cert = client_cert
        self._pool: dict[tuple[str, str, int],
                         list[http.client.HTTPConnection]] = {}
        self._pool_lock = threading.Lock()
        self._ssl_ctx: ssl.SSLContext | None = None

    def _ssl_context(self) -> ssl.SSLContext:
        # Cached: one context serves every pooled connection (building
        # one per request would also defeat TLS session resumption).
        if self._ssl_ctx is None:
            ctx = ssl.create_default_context(cafile=self.ca_cert)
            if not self.tls_verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            if self.client_cert:
                ctx.load_cert_chain(*self.client_cert)
            self._ssl_ctx = ctx
        return self._ssl_ctx

    def _origin(self, url: str) -> tuple[str, str, int, str]:
        parts = urllib.parse.urlsplit(url)
        scheme = parts.scheme or "http"
        host = parts.hostname or ""
        port = parts.port or (443 if scheme == "https" else 80)
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        return scheme, host, port, path

    def _checkout(self, scheme: str, host: str, port: int,
                  timeout: float) -> tuple[http.client.HTTPConnection,
                                           bool]:
        """Pop an idle keep-alive connection for the origin, or open a
        fresh one. Returns (conn, reused)."""
        key = (scheme, host, port)
        with self._pool_lock:
            idle = self._pool.get(key)
            if idle:
                conn = idle.pop()
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
                return conn, True
        return self._new_conn(scheme, host, port, timeout), False

    def _new_conn(self, scheme: str, host: str, port: int,
                  timeout: float) -> http.client.HTTPConnection:
        if scheme == "https":
            return _NoDelayHTTPSConnection(host, port, timeout=timeout,
                                           context=self._ssl_context())
        return _NoDelayHTTPConnection(host, port, timeout=timeout)

    def _checkin(self, scheme: str, host: str, port: int,
                 conn: http.client.HTTPConnection) -> None:
        key = (scheme, host, port)
        with self._pool_lock:
            idle = self._pool.setdefault(key, [])
            if len(idle) < POOL_MAX_IDLE:
                idle.append(conn)
                return
        conn.close()

    def _flush_origin(self, scheme: str, host: str, port: int) -> None:
        with self._pool_lock:
            idle = self._pool.pop((scheme, host, port), [])
        for conn in idle:
            conn.close()

    def close(self) -> None:
        """Close every idle pooled connection (tests, engine teardown)."""
        with self._pool_lock:
            pools, self._pool = self._pool, {}
        for idle in pools.values():
            for conn in idle:
                conn.close()

    def round_trip(self, method: str, url: str, headers: dict[str, str],
                   body: bytes | BinaryIO | None = None,
                   timeout: float = 60.0,
                   stream_to: str | None = None) -> Response:
        """One exchange. With ``stream_to`` set, a 2xx body streams to
        that file path in 1MiB chunks (Response.body stays empty) so
        multi-GB blobs never materialize in memory."""
        if hasattr(body, "read"):
            body = body.read()
        scheme, host, port, path = self._origin(url)
        conn, reused = self._checkout(scheme, host, port, timeout)
        try:
            return self._exchange(conn, scheme, host, port, method, path,
                                  headers, body, stream_to,
                                  retry_stale=reused)
        except _StaleConnection:
            # The pooled connection had been quietly closed by the
            # server (keep-alive timeout): either the send itself
            # failed, or zero response bytes arrived — in both cases
            # the server did not process the request, so one retry is
            # safe for any method. The origin's remaining idle sockets
            # aged identically and are just as likely dead — flush
            # them now rather than paying one failed round trip each —
            # and the retry opens a genuinely fresh connection.
            self._flush_origin(scheme, host, port)
            conn = self._new_conn(scheme, host, port, timeout)
            try:
                return self._exchange(conn, scheme, host, port, method,
                                      path, headers, body, stream_to,
                                      retry_stale=False)
            except (http.client.HTTPException, OSError, ssl.SSLError) as e:
                conn.close()
                raise NetworkError(f"{method} {url}: {e}") from e
        except (http.client.HTTPException, OSError, ssl.SSLError) as e:
            raise NetworkError(f"{method} {url}: {e}") from e

    def _exchange(self, conn: http.client.HTTPConnection, scheme: str,
                  host: str, port: int, method: str, path: str,
                  headers: dict[str, str], body: bytes | None,
                  stream_to: str | None, retry_stale: bool) -> Response:
        fresh = conn.sock is None
        try:
            conn.request(method, path, body=body, headers=headers)
        except (http.client.HTTPException, OSError, ssl.SSLError):
            conn.close()
            if retry_stale:
                raise _StaleConnection() from None
            raise
        metrics.counter_add(metrics.HTTP_REQUESTS_TOTAL)
        if fresh:
            # request() opened the socket lazily; count the handshake
            # only once it actually happened.
            metrics.counter_add(metrics.HTTP_CONNECTIONS_TOTAL,
                                scheme=scheme)
        try:
            resp = conn.getresponse()
        except http.client.RemoteDisconnected:
            # Closed without ANY response bytes: the stale-keep-alive
            # signature. Errors mid-response (IncompleteRead etc.) are
            # NOT retried at this layer — the server may have acted on
            # a non-idempotent request; send()'s status-aware retry
            # owns that decision.
            conn.close()
            if retry_stale:
                raise _StaleConnection() from None
            raise
        except (http.client.HTTPException, OSError, ssl.SSLError):
            conn.close()
            raise
        resp_headers = {k.lower(): v for k, v in resp.getheaders()}
        try:
            if (stream_to is not None and resp.status // 100 == 2
                    and method != "HEAD"):
                import hashlib
                from makisu_tpu_torch.utils import events as events_mod
                digest = hashlib.sha256()
                with open(stream_to, "wb") as out:
                    while True:
                        chunk = resp.read(1 << 20)
                        if not chunk:
                            break
                        digest.update(chunk)
                        out.write(chunk)
                        # Each landed buffer stamps the progress clock:
                        # a slow multi-GB streaming pull is PROGRESS,
                        # not a stall, even between telemetry events.
                        events_mod.note_progress()
                result = Response(resp.status, resp_headers, b"",
                                  stream_sha256=digest.hexdigest())
            else:
                result = Response(resp.status, resp_headers, resp.read())
        except BaseException:
            conn.close()  # a half-read body must never be pooled
            raise
        finally:
            resp.close()
        if resp.will_close:
            conn.close()
        else:
            self._checkin(scheme, host, port, conn)
        return result


# TCP_NODELAY on every client socket: http.client writes headers and
# body in separate sends, and Nagle holding the second send for the
# delayed ACK of the first costs ~40ms PER REQUEST. Chunk-granular
# dedup issues thousands of small blob requests per layer — measured
# ~50x wall-clock on the chunk push/fetch planes.


class _NoDelayHTTPConnection(http.client.HTTPConnection):
    def connect(self) -> None:
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class _NoDelayHTTPSConnection(http.client.HTTPSConnection):
    def connect(self) -> None:
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


def send(transport: Transport, method: str, url: str,
         headers: dict[str, str] | None = None,
         body: bytes | None = None,
         accepted: tuple[int, ...] = (200,),
         retries: int = 3, backoff: float = 0.5,
         timeout: float = 60.0,
         allow_http_fallback: bool = False,
         stream_to: str | None = None) -> Response:
    """One request with retry/backoff on retryable statuses and network
    errors, optional https→http downgrade for plain-HTTP registries.

    Every request carries a W3C ``traceparent`` header naming the
    active build's trace and the innermost open span, so registry and
    cache-KV server logs correlate with the build's span tree /
    ``--trace-out`` export. Retries of one logical request reuse the
    same header — they ARE the same operation."""
    headers = dict(headers or {})
    headers.setdefault("traceparent", metrics.current_traceparent())
    last: Exception | None = None
    for attempt in range(retries):
        try:
            kwargs = {} if stream_to is None else {"stream_to": stream_to}
            resp = transport.round_trip(method, url, headers, body, timeout,
                                        **kwargs)
        except NetworkError as e:
            last = e
            if allow_http_fallback and url.startswith("https://"):
                url = "http://" + url[len("https://"):]
                continue
            time.sleep(backoff * (2 ** attempt))
            continue
        if resp.status in accepted:
            return resp
        if resp.status in RETRYABLE_CODES and attempt < retries - 1:
            time.sleep(backoff * (2 ** attempt))
            continue
        raise HTTPError(resp.status, url, resp.body)
    assert last is not None
    raise last
