"""Shared cache-KV endpoint for multi-worker harnesses.

Copy of ``makisu_tpu/fleet/kv.py``. Workers share a cache plane only
through a shared KV: worker B hits the entry worker A wrote for the same
context, and B's chunk CAS then asks its peers (and then the registry)
for the chunks instead of rebuilding. Deployments bring their own
(``--redis-cache-addr`` or ``--http-cache-addr`` against a real
service); tests and drives use this minimal in-process HTTP server,
which speaks exactly the wire ``cache/kv.py HTTPStore`` consumes
(``GET /<key>`` -> 200 value or 404, ``PUT /<key>`` -> 200) over a dict,
on loopback TCP because HTTPStore dials ``host:port``.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _KVHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args) -> None:  # quiet
        pass

    def do_GET(self) -> None:
        value = self.server.kv_get(self.path.lstrip("/"))
        if value is None:
            self._respond(404, b"")
            return
        self._respond(200, value.encode())

    def do_PUT(self) -> None:
        length = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(length).decode()
        self.server.kv_put(self.path.lstrip("/"), body)
        self._respond(200, b"ok")

    def _respond(self, status: int, body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)


class SharedKVServer(ThreadingHTTPServer):
    """``start()`` returns the ``host:port`` address to pass as every
    build's ``--http-cache-addr``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        super().__init__((host, port), _KVHandler)
        self._data: dict[str, str] = {}
        self._mu = threading.Lock()
        self._thread: threading.Thread | None = None

    def kv_get(self, key: str) -> str | None:
        with self._mu:
            return self._data.get(key)

    def kv_put(self, key: str, value: str) -> None:
        with self._mu:
            self._data[key] = value

    def entry_count(self) -> int:
        with self._mu:
            return len(self._data)

    @property
    def address(self) -> str:
        host, port = self.server_address[:2]
        return f"{host}:{port}"

    def start(self) -> str:
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True, name="fleet-shared-kv")
        self._thread.start()
        return self.address

    def stop(self) -> None:
        self.shutdown()
        self.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
