"""Hermetic registry fixtures: the v2 protocol served in-process.

Copy of ``makisu_tpu/registry/fixtures.py``, for the port's own tests.
Reference test strategy: lib/registry/pull_fixture.go:23-138 (canned image
through a fake RoundTripper) and push_fixture.go:17-171 (full upload state
machine with per-URL response overrides for fault injection). This is what
makes distributed behavior unit-testable without a registry container.
"""

from __future__ import annotations

import gzip
import io
import json
import re
import tarfile

from makisu_tpu_torch.docker.image import (
    MEDIA_TYPE_CONFIG,
    MEDIA_TYPE_LAYER,
    Descriptor,
    Digest,
    DistributionManifest,
    ImageConfig,
)
from makisu_tpu_torch.utils.httputil import Response, Transport


def make_test_image(files: dict[str, bytes] | None = None,
                    env: list[str] | None = None):
    """Synthesize a one-layer image. Returns (manifest, config_blob,
    {hex: blob})."""
    files = files if files is not None else {"etc/base-release": b"test\n"}
    tar_buf = io.BytesIO()
    with tarfile.open(fileobj=tar_buf, mode="w|") as tw:
        dirs = sorted({n.rsplit("/", 1)[0] for n in files if "/" in n})
        for d in dirs:
            ti = tarfile.TarInfo(d)
            ti.type = tarfile.DIRTYPE
            ti.mode = 0o755
            tw.addfile(ti)
        for name, content in sorted(files.items()):
            ti = tarfile.TarInfo(name)
            ti.size = len(content)
            ti.mode = 0o644
            tw.addfile(ti, io.BytesIO(content))
    tar_bytes = tar_buf.getvalue()
    layer_blob = gzip.compress(tar_bytes, mtime=0)
    config = ImageConfig()
    if isinstance(env, str):
        raise TypeError("env must be a list of KEY=VAL strings")
    config.config.env = env or []
    config.rootfs.diff_ids = [str(Digest.of_bytes(tar_bytes))]
    config_blob = config.to_bytes()
    manifest = DistributionManifest(
        config=Descriptor(MEDIA_TYPE_CONFIG, len(config_blob),
                          Digest.of_bytes(config_blob)),
        layers=[Descriptor(MEDIA_TYPE_LAYER, len(layer_blob),
                           Digest.of_bytes(layer_blob))])
    blobs = {
        Digest.of_bytes(config_blob).hex(): config_blob,
        Digest.of_bytes(layer_blob).hex(): layer_blob,
    }
    return manifest, config_blob, blobs


class RegistryFixture(Transport):
    """In-process registry: blobs/manifests in dicts, full upload state
    machine, per-(method,url-regex) response overrides."""

    def __init__(self, require_token: str = "",
                 strict_media_types: bool = False) -> None:
        super().__init__()
        self.blobs: dict[str, bytes] = {}          # hex → blob
        self.manifests: dict[str, bytes] = {}      # "<repo>:<tag>" → json
        self.uploads: dict[str, bytearray] = {}    # uuid → partial blob
        self.overrides: list[tuple[str, str, Response]] = []
        self.requests: list[tuple[str, str]] = []  # log for assertions
        # Chunk pushes arrive from a thread pool; upload-session ids
        # must not collide under concurrency.
        import itertools
        self._upload_ids = itertools.count()
        # When set, /v2/ endpoints demand "Bearer <require_token>" and
        # 401-challenge to /token (exercises the auth dance).
        self.require_token = require_token
        # Strict registries (policy-enforcing Harbor/quay setups) reject
        # manifests whose layers carry media types they don't know —
        # including this framework's chunk-pin manifests. Tests flip
        # this on to prove builds degrade gracefully instead of failing.
        self.strict_media_types = strict_media_types

    _KNOWN_LAYER_TYPES = (
        MEDIA_TYPE_LAYER,
        "application/vnd.oci.image.layer.v1.tar+gzip",
        "application/vnd.docker.image.rootfs.foreign.diff.tar.gzip",
    )

    # -- test wiring ------------------------------------------------------

    def serve_image(self, repo: str, tag: str, manifest: DistributionManifest,
                    blobs: dict[str, bytes]) -> None:
        self.manifests[f"{repo}:{tag}"] = manifest.to_bytes()
        self.blobs.update(blobs)

    def override(self, method: str, url_pattern: str,
                 response: Response) -> None:
        """Next matching request returns this response (fault injection)."""
        self.overrides.append((method, url_pattern, response))

    def gc(self) -> list[str]:
        """Delete every blob not referenced by any manifest — what real
        registries' garbage collectors do. Returns the deleted digests
        (tests assert pinning kept the right blobs alive)."""
        referenced: set[str] = set()
        for raw in self.manifests.values():
            manifest = json.loads(raw)
            config = manifest.get("config") or {}
            if config.get("digest", "").startswith("sha256:"):
                referenced.add(config["digest"][len("sha256:"):])
            for layer in manifest.get("layers") or []:
                digest = layer.get("digest", "")
                if digest.startswith("sha256:"):
                    referenced.add(digest[len("sha256:"):])
        removed = [h for h in self.blobs if h not in referenced]
        for h in removed:
            del self.blobs[h]
        return removed

    # -- transport --------------------------------------------------------

    def round_trip(self, method, url, headers, body=None, timeout=60.0,
                   stream_to=None):  # fixtures return bytes directly
        self.requests.append((method, url))
        for i, (m, pattern, resp) in enumerate(self.overrides):
            if m == method and re.search(pattern, url):
                del self.overrides[i]
                return resp
        if hasattr(body, "read"):
            body = body.read()
        path = re.sub(r"^https?://[^/]+", "", url)

        if path.startswith("/token"):
            return Response(200, {}, json.dumps(
                {"token": self.require_token}).encode())
        if self.require_token and path.startswith("/v2/"):
            if headers.get("Authorization") != f"Bearer {self.require_token}":
                return Response(401, {
                    "www-authenticate":
                        'Bearer realm="https://registry.test/token",'
                        'service="registry.test",scope="repo:pull"',
                }, b"authentication required")

        m = re.fullmatch(r"/v2/(.+)/manifests/([^/]+)", path)
        if m:
            repo, tag = m.groups()
            key = f"{repo}:{tag}"
            if method == "GET":
                if key in self.manifests:
                    return Response(200, {}, self.manifests[key])
                return Response(404, {}, b"manifest unknown")
            if method == "PUT":
                payload = bytes(body or b"")
                if self.strict_media_types:
                    try:
                        parsed = json.loads(payload)
                    except ValueError:
                        return Response(400, {}, b"MANIFEST_INVALID")
                    bad = [l.get("mediaType")
                           for l in parsed.get("layers") or []
                           if l.get("mediaType")
                           not in self._KNOWN_LAYER_TYPES]
                    if bad:
                        return Response(
                            400, {},
                            json.dumps({"errors": [{
                                "code": "MANIFEST_INVALID",
                                "message": f"unknown layer media "
                                           f"types {bad[:3]}"}]}).encode())
                self.manifests[key] = payload
                return Response(201, {}, b"")
            if method == "HEAD":
                status = 200 if key in self.manifests else 404
                return Response(status, {}, b"")

        m = re.fullmatch(r"/v2/(.+)/blobs/sha256:([0-9a-f]{64})", path)
        if m:
            hex_digest = m.group(2)
            if method == "HEAD":
                return Response(200 if hex_digest in self.blobs else 404,
                                {}, b"")
            if method == "GET":
                if hex_digest in self.blobs:
                    data = self.blobs[hex_digest]
                    rng = headers.get("Range", "")
                    m_rng = re.fullmatch(r"bytes=(\d+)-(\d+)", rng)
                    if m_rng:
                        start = int(m_rng.group(1))
                        end = min(int(m_rng.group(2)) + 1, len(data))
                        if 0 <= start < end:
                            return Response(206, {}, data[start:end])
                    return Response(200, {}, data)
                return Response(404, {}, b"blob unknown")

        m = re.fullmatch(r"/v2/(.+)/blobs/uploads/", path)
        if m and method == "POST":
            uuid = f"upload-{next(self._upload_ids)}"
            self.uploads[uuid] = bytearray()
            return Response(
                202, {"location": f"/v2/{m.group(1)}/blobs/uploads/{uuid}"},
                b"")

        m = re.fullmatch(r"/v2/(.+)/blobs/uploads/([^?]+)(\?digest=(.+))?",
                         path)
        if m:
            repo, uuid, _, digest = m.groups()
            if method == "PATCH":
                if uuid not in self.uploads:
                    return Response(404, {}, b"upload unknown")
                content_range = headers.get("Content-Range", "")
                if content_range:
                    start = int(content_range.split("-")[0])
                    if start != len(self.uploads[uuid]):
                        return Response(416, {}, b"range mismatch")
                self.uploads[uuid].extend(body or b"")
                return Response(
                    202, {"location": f"/v2/{repo}/blobs/uploads/{uuid}"},
                    b"")
            if method == "PUT":
                data = bytes(self.uploads.pop(uuid, b"")) + bytes(body or b"")
                actual = Digest.of_bytes(data)
                if digest and digest != str(actual):
                    return Response(400, {}, b"digest mismatch")
                self.blobs[actual.hex()] = data
                return Response(201, {}, b"")

        return Response(404, {}, f"unhandled {method} {path}".encode())
