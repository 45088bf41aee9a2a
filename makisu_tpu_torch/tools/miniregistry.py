"""A minimal, spec-faithful OCI distribution registry server.

Copy of ``makisu_tpu/tools/miniregistry.py`` for the port: the smoke and
the port's tests push and pull through it over loopback TCP. It is an
independent implementation of the distribution spec's pull+push subset,
written from the spec semantics and separate from
``registry/fixtures.py`` (which grew up beside the client and could
share its blind spots). It keeps every blob in memory.

Implemented surface (what `registry:2` serves):
- ``GET  /v2/``                               — API version check
- ``HEAD/GET /v2/<name>/blobs/<digest>``      — blob pull
- ``POST /v2/<name>/blobs/uploads/``          — start upload
  (``?digest=`` monolithic or ``?mount=&from=`` cross-repo mount)
- ``PATCH/PUT /v2/<name>/blobs/uploads/<id>`` — chunked upload + commit
- ``GET  /v2/<name>/blobs/uploads/<id>``      — upload progress
- ``HEAD/GET /v2/<name>/manifests/<ref>``     — manifest pull (tag or
  digest), media type preserved
- ``PUT  /v2/<name>/manifests/<ref>``         — manifest push; referenced
  config/layer blobs must exist (MANIFEST_BLOB_UNKNOWN otherwise),
  matching registry:2's validation
- ``GET  /v2/<name>/tags/list``
- errors in the spec's ``{"errors": [{code, message, detail}]}`` form

Run standalone: ``python -m makisu_tpu_torch.tools.miniregistry --port 5001``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import threading
import uuid as uuidlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_NAME = r"[a-z0-9]+(?:[._-][a-z0-9]+)*(?:/[a-z0-9]+(?:[._-][a-z0-9]+)*)*"
_ROUTES = [
    ("base", re.compile(r"^/v2/?$")),
    ("uploads", re.compile(rf"^/v2/({_NAME})/blobs/uploads/?$")),
    ("upload", re.compile(rf"^/v2/({_NAME})/blobs/uploads/([0-9a-f-]+)$")),
    ("blob", re.compile(rf"^/v2/({_NAME})/blobs/(sha256:[0-9a-f]{{64}})$")),
    ("manifest", re.compile(rf"^/v2/({_NAME})/manifests/([^/]+)$")),
    ("tags", re.compile(rf"^/v2/({_NAME})/tags/list$")),
]

_DIGEST_RE = re.compile(r"^sha256:[0-9a-f]{64}$")
_TAG_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9._-]{0,127}$")

MANIFEST_TYPES = (
    "application/vnd.docker.distribution.manifest.v2+json",
    "application/vnd.docker.distribution.manifest.list.v2+json",
    "application/vnd.oci.image.manifest.v1+json",
    "application/vnd.oci.image.index.v1+json",
)
_LIST_TYPES = (
    "application/vnd.docker.distribution.manifest.list.v2+json",
    "application/vnd.oci.image.index.v1+json",
)


def _parse_range(header: str | None, size: int) -> tuple[int, int] | None:
    """``bytes=a-b`` (inclusive) -> [a, b+1), clamped; None = serve the
    whole blob (absent/malformed/multi-range — 200 is always a legal
    answer to a Range request, so unsupported shapes degrade to it)."""
    if not header or not header.startswith("bytes="):
        return None
    spec = header[len("bytes="):]
    if "," in spec or "-" not in spec:
        return None
    first, last = spec.split("-", 1)
    if not first or not last:  # suffix/open-ended: not needed here
        return None
    try:
        start, end = int(first), int(last) + 1
    except ValueError:
        return None
    if start < 0 or end <= start or start >= size:
        # Includes unsatisfiable starts: serving the whole blob (200)
        # is always a legal answer to a Range request; an empty 206
        # would not be.
        return None
    return start, min(end, size)


def _digest_of(data: bytes) -> str:
    return "sha256:" + hashlib.sha256(data).hexdigest()


class _Repo:
    def __init__(self) -> None:
        self.blobs: dict[str, bytes] = {}
        # ref (tag or digest) -> (media_type, raw bytes)
        self.manifests: dict[str, tuple[str, bytes]] = {}
        self.tags: set[str] = set()


class _State:
    def __init__(self) -> None:
        self.repos: dict[str, _Repo] = {}
        self.uploads: dict[str, tuple[str, bytearray]] = {}
        self.lock = threading.Lock()
        # Simulated wire bandwidth for blob bodies (0 = unthrottled):
        # lets benchmarks model a real link (the reference's own default
        # push rate limit is 100 MB/s, lib/registry/config.go:86-88)
        # instead of loopback's fantasy bandwidth.
        self.throttle_mbps = 0.0
        # Fixed per-request latency (0 = none): models round-trip time
        # so tests/benchmarks can PROVE transfer overlap — N requests
        # overlapped take ~1 latency, serial take ~N.
        self.latency_s = 0.0
        # When False, Range headers are ignored and blob GETs always
        # answer 200 (a legal response to any Range request) — tests
        # exercise the client's whole-blob fallback against it.
        self.serve_ranges = True
        # Byte accounting for benchmarks: blob bytes served / accepted.
        self.blob_bytes_out = 0
        self.blob_bytes_in = 0
        # Request log: (method, path, traceparent header or ""), what a
        # real registry's access log would hold; tests and the smoke
        # read which blobs a build fetched from it.
        self.requests: list[tuple[str, str, str]] = []

    def repo(self, name: str) -> _Repo:
        return self.repos.setdefault(name, _Repo())

    def wire_delay(self, nbytes: int) -> None:
        if self.throttle_mbps > 0 and nbytes > 0:
            import time
            time.sleep(nbytes / (self.throttle_mbps * 1e6))


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "makisu-tpu-miniregistry/1.0"

    def log_message(self, *args) -> None:  # quiet by default
        if getattr(self.server, "verbose", False):
            super().log_message(*args)

    # -- plumbing ---------------------------------------------------------

    @property
    def st(self) -> _State:
        return self.server.state

    def _route(self) -> tuple[str, tuple, str]:
        path, _, query = self.path.partition("?")
        for kind, rx in _ROUTES:
            m = rx.match(path)
            if m:
                return kind, m.groups(), query
        return "", (), query

    def _query(self, query: str) -> dict[str, str]:
        out: dict[str, str] = {}
        for part in query.split("&"):
            if "=" in part:
                k, _, v = part.partition("=")
                out[k] = v
        return out

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        data = self.rfile.read(n) if n else b""
        if data and "/blobs/" in self.path:
            self.st.wire_delay(len(data))
            with self.st.lock:
                self.st.blob_bytes_in += len(data)
        return data

    def _reply(self, status: int, body: bytes = b"",
               headers: dict[str, str] | None = None) -> None:
        self.send_response(status)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if self.command != "HEAD" and body:
            self.wfile.write(body)

    def _error(self, status: int, code: str, message: str,
               detail: str = "") -> None:
        body = json.dumps({"errors": [{
            "code": code, "message": message, "detail": detail,
        }]}).encode()
        self._reply(status, body,
                    {"Content-Type": "application/json"})

    # -- verbs ------------------------------------------------------------

    def do_GET(self) -> None:
        self._dispatch("GET")

    def do_HEAD(self) -> None:
        self._dispatch("HEAD")

    def do_POST(self) -> None:
        self._dispatch("POST")

    def do_PATCH(self) -> None:
        self._dispatch("PATCH")

    def do_PUT(self) -> None:
        self._dispatch("PUT")

    def _dispatch(self, verb: str) -> None:
        with self.st.lock:
            self.st.requests.append(
                (verb, self.path.split("?")[0],
                 self.headers.get("traceparent", "")))
        if self.st.latency_s > 0:
            import time
            time.sleep(self.st.latency_s)
        kind, groups, query = self._route()
        handler = getattr(self, f"_{verb.lower()}_{kind}", None)
        if kind == "" or handler is None:
            self._error(404, "UNSUPPORTED", f"no route for {verb} "
                        f"{self.path.split('?')[0]}")
            return
        handler(*groups, **({"query": query}
                            if kind in ("uploads", "upload") else {}))

    # -- /v2/ -------------------------------------------------------------

    def _get_base(self) -> None:
        self._reply(200, b"{}", {
            "Content-Type": "application/json",
            "Docker-Distribution-Api-Version": "registry/2.0",
        })

    _head_base = _get_base

    # -- blobs ------------------------------------------------------------

    def _head_blob(self, name: str, digest: str) -> None:
        with self.st.lock:
            data = self.st.repo(name).blobs.get(digest)
        if data is None:
            self._error(404, "BLOB_UNKNOWN", "blob unknown to registry",
                        digest)
            return
        status = 200
        headers = {
            "Content-Type": "application/octet-stream",
            "Docker-Content-Digest": digest,
        }
        if self.command == "GET":
            total = len(data)
            rng = (_parse_range(self.headers.get("Range"), total)
                   if self.st.serve_ranges else None)
            if rng is not None:
                start, end = rng
                data = data[start:end]
                status = 206
                # RFC 9110 §14.4: 206 MUST carry Content-Range naming
                # the satisfied span and the complete length.
                headers["Content-Range"] = \
                    f"bytes {start}-{end - 1}/{total}"
            self.st.wire_delay(len(data))
            with self.st.lock:
                self.st.blob_bytes_out += len(data)
        self._reply(status, data, headers)

    _get_blob = _head_blob

    def _post_uploads(self, name: str, query: str = "") -> None:
        q = self._query(query)
        body = self._body()
        if "digest" in q:
            # Monolithic single-POST upload.
            digest = q["digest"]
            if not _DIGEST_RE.match(digest):
                self._error(400, "DIGEST_INVALID",
                            "provided digest did not parse", digest)
                return
            if _digest_of(body) != digest:
                self._error(400, "DIGEST_INVALID",
                            "provided digest did not match uploaded "
                            "content", digest)
                return
            with self.st.lock:
                self.st.repo(name).blobs[digest] = body
            self._reply(201, b"", {
                "Location": f"/v2/{name}/blobs/{digest}",
                "Docker-Content-Digest": digest,
            })
            return
        if "mount" in q and "from" in q:
            # Cross-repo mount; fall through to a fresh upload when the
            # source blob is missing (spec behavior).
            with self.st.lock:
                src = self.st.repos.get(q["from"])
                data = src.blobs.get(q["mount"]) if src else None
                if data is not None:
                    self.st.repo(name).blobs[q["mount"]] = data
            if data is not None:
                self._reply(201, b"", {
                    "Location": f"/v2/{name}/blobs/{q['mount']}",
                    "Docker-Content-Digest": q["mount"],
                })
                return
        upload_id = str(uuidlib.uuid4())
        with self.st.lock:
            self.st.uploads[upload_id] = (name, bytearray(body))
        self._reply(202, b"", {
            "Location": f"/v2/{name}/blobs/uploads/{upload_id}",
            "Docker-Upload-UUID": upload_id,
            "Range": "0-0",
        })

    def _patch_upload(self, name: str, upload_id: str,
                      query: str = "") -> None:
        with self.st.lock:
            entry = self.st.uploads.get(upload_id)
        if entry is None or entry[0] != name:
            self._error(404, "BLOB_UPLOAD_UNKNOWN",
                        "blob upload unknown to registry", upload_id)
            return
        _, buf = entry
        chunk = self._body()
        content_range = self.headers.get("Content-Range")
        if content_range:
            # Spec: chunks must be appended in order.
            m = re.match(r"^(\d+)-(\d+)$", content_range)
            if not m or int(m.group(1)) != len(buf):
                self._reply(416, b"", {
                    "Location": f"/v2/{name}/blobs/uploads/{upload_id}",
                    "Range": f"0-{max(len(buf) - 1, 0)}",
                })
                return
        with self.st.lock:
            buf.extend(chunk)
            size = len(buf)
        self._reply(202, b"", {
            "Location": f"/v2/{name}/blobs/uploads/{upload_id}",
            "Docker-Upload-UUID": upload_id,
            "Range": f"0-{max(size - 1, 0)}",
        })

    def _put_upload(self, name: str, upload_id: str,
                    query: str = "") -> None:
        q = self._query(query)
        digest = q.get("digest", "")
        if not _DIGEST_RE.match(digest):
            self._error(400, "DIGEST_INVALID",
                        "provided digest did not parse", digest)
            return
        with self.st.lock:
            entry = self.st.uploads.get(upload_id)
        if entry is None or entry[0] != name:
            self._error(404, "BLOB_UPLOAD_UNKNOWN",
                        "blob upload unknown to registry", upload_id)
            return
        _, buf = entry
        final = bytes(buf) + self._body()
        if _digest_of(final) != digest:
            self._error(400, "DIGEST_INVALID",
                        "provided digest did not match uploaded content",
                        digest)
            return
        with self.st.lock:
            self.st.repo(name).blobs[digest] = final
            del self.st.uploads[upload_id]
        self._reply(201, b"", {
            "Location": f"/v2/{name}/blobs/{digest}",
            "Docker-Content-Digest": digest,
        })

    def _get_upload(self, name: str, upload_id: str,
                    query: str = "") -> None:
        with self.st.lock:
            entry = self.st.uploads.get(upload_id)
        if entry is None or entry[0] != name:
            self._error(404, "BLOB_UPLOAD_UNKNOWN",
                        "blob upload unknown to registry", upload_id)
            return
        self._reply(204, b"", {
            "Docker-Upload-UUID": upload_id,
            "Range": f"0-{max(len(entry[1]) - 1, 0)}",
        })

    # -- manifests --------------------------------------------------------

    def _head_manifest(self, name: str, ref: str) -> None:
        with self.st.lock:
            entry = self.st.repo(name).manifests.get(ref)
        if entry is None:
            self._error(404, "MANIFEST_UNKNOWN", "manifest unknown", ref)
            return
        media_type, raw = entry
        self._reply(200, raw, {
            "Content-Type": media_type,
            "Docker-Content-Digest": _digest_of(raw),
        })

    _get_manifest = _head_manifest

    def _put_manifest(self, name: str, ref: str) -> None:
        raw = self._body()
        media_type = (self.headers.get("Content-Type")
                      or MANIFEST_TYPES[0]).split(";")[0].strip()
        try:
            doc = json.loads(raw)
        except ValueError:
            self._error(400, "MANIFEST_INVALID",
                        "manifest invalid", "not json")
            return
        if not (_DIGEST_RE.match(ref) or _TAG_RE.match(ref)):
            self._error(400, "TAG_INVALID", "manifest tag did not match",
                        ref)
            return
        digest = _digest_of(raw)
        if _DIGEST_RE.match(ref) and ref != digest:
            self._error(400, "DIGEST_INVALID",
                        "provided digest did not match uploaded content",
                        ref)
            return
        # registry:2 semantics: every referenced blob (or sub-manifest,
        # for an index) must already exist in this repository.
        with self.st.lock:
            repo = self.st.repo(name)
            missing = []
            if media_type in _LIST_TYPES:
                for m in doc.get("manifests") or []:
                    if m.get("digest") not in repo.manifests:
                        missing.append(m.get("digest", "?"))
            else:
                refs = list(doc.get("layers") or [])
                if isinstance(doc.get("config"), dict):
                    refs.append(doc["config"])
                for desc in refs:
                    if desc.get("digest") not in repo.blobs:
                        missing.append(desc.get("digest", "?"))
            if missing:
                pass  # reply outside the lock
            else:
                repo.manifests[digest] = (media_type, raw)
                repo.manifests[ref] = (media_type, raw)
                if not _DIGEST_RE.match(ref):
                    repo.tags.add(ref)
        if missing:
            self._error(400, "MANIFEST_BLOB_UNKNOWN",
                        "blob unknown to registry", ", ".join(missing))
            return
        self._reply(201, b"", {
            "Location": f"/v2/{name}/manifests/{digest}",
            "Docker-Content-Digest": digest,
        })

    # -- tags -------------------------------------------------------------

    def _get_tags(self, name: str) -> None:
        with self.st.lock:
            tags = sorted(self.st.repo(name).tags)
        self._reply(200, json.dumps(
            {"name": name, "tags": tags}).encode(),
            {"Content-Type": "application/json"})


class MiniRegistry:
    """An in-process distribution-spec registry over real TCP."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 verbose: bool = False,
                 throttle_mbps: float = 0.0,
                 latency_s: float = 0.0,
                 serve_ranges: bool = True) -> None:
        self._server = ThreadingHTTPServer((host, port), _Handler)
        # Nagle + delayed-ACK interaction costs ~40ms PER REQUEST on
        # loopback (the client's header/body write-write-read pattern);
        # chunk dedup issues thousands of small requests, so this
        # single flag is a ~50x throughput difference.
        self._server.disable_nagle_algorithm = True
        self._server.state = _State()
        self._server.state.throttle_mbps = throttle_mbps
        self._server.state.latency_s = latency_s
        self._server.state.serve_ranges = serve_ranges
        self._server.verbose = verbose
        self._server.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def addr(self) -> str:
        host, port = self._server.server_address[:2]
        return f"{host}:{port}"

    @property
    def state(self) -> _State:
        return self._server.state

    def start(self) -> "MiniRegistry":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="miniregistry")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=10)

    def __enter__(self) -> "MiniRegistry":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def main() -> int:
    ap = argparse.ArgumentParser(
        description="Minimal OCI distribution registry (pull+push)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=5001)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()
    reg = MiniRegistry(args.host, args.port, verbose=args.verbose)
    print(f"miniregistry serving on {reg.addr}")
    reg._server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
