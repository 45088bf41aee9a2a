"""The port's registry plane: client, fixtures, miniregistry, and the
registry route of builds, against the JAX package's.

The cases of ``tests/test_registry.py`` run against the port's client and
``RegistryFixture``, and those of ``tests/test_miniregistry.py`` against
the port's ``tools/miniregistry.py``. Then both packages share one
loopback miniregistry: a base pushed by either is built ``FROM`` by the
other, both push the same context with equal layer blobs, packs and pin
manifests, chunks travel through the registry between builders of the
two packages (and survive its GC), and ``pull``/``push``/``diff``/
``--oci-dest`` give the same results. Every registry here is in-process
or on 127.0.0.1.
"""

import base64
import contextvars
import hashlib
import http.client
import io
import json
import os
import tarfile

import numpy as np
import pytest

from makisu_tpu import cli as ref_cli
from makisu_tpu.builder import BuildPlan as RefBuildPlan
from makisu_tpu.cache import CacheManager as RefCacheManager
from makisu_tpu.cache import MemoryStore
from makisu_tpu.cache.chunks import attach_chunk_dedup as ref_attach
from makisu_tpu.chunker import TPUHasher
from makisu_tpu.context import BuildContext as RefBuildContext
from makisu_tpu.docker.image import ImageName as RefImageName
from makisu_tpu.dockerfile import parse_file as ref_parse_file
from makisu_tpu.registry import RegistryClient as RefRegistryClient
from makisu_tpu.snapshot import memfs as ref_memfs
from makisu_tpu.storage import ImageStore as RefImageStore
from makisu_tpu_torch import cli
from makisu_tpu_torch.builder import BuildPlan
from makisu_tpu_torch.cache import CacheManager, attach_chunk_dedup
from makisu_tpu_torch.cache.chunks import PACK_MEDIA_TYPE
from makisu_tpu_torch.chunker.hasher import GPUHasher
from makisu_tpu_torch.context import BuildContext
from makisu_tpu_torch.docker.image import (
    MEDIA_TYPE_OCI_MANIFEST,
    Digest,
    ImageName,
)
from makisu_tpu_torch.dockerfile import parse_file
from makisu_tpu_torch.registry import (
    RegistryClient,
    RegistryConfig,
    RegistryFixture,
    make_test_image,
)
from makisu_tpu_torch.snapshot import memfs
from makisu_tpu_torch.storage import ImageStore
from makisu_tpu_torch.tools.miniregistry import MiniRegistry
from makisu_tpu_torch.utils import mountinfo
from makisu_tpu_torch.utils.httputil import HTTPError, Response
from tests.test_torch_build import (  # noqa: F401 - fresh_sessions
    count_lines,
    fresh_sessions,
    kv_entries,
    load_image,
    make_context,
    one_shot_main,
    timeless,
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


# -- the client against its fixture (tests/test_registry.py) ----------------

@pytest.fixture
def store(tmp_path):
    return ImageStore(str(tmp_path / "store"))


@pytest.fixture
def fixture():
    return RegistryFixture()


def client(store, fixture, repo="team/app", **cfg):
    return RegistryClient(store, "registry.test", repo,
                          config=RegistryConfig(**cfg), transport=fixture)


def test_pull_image(store, fixture):
    manifest, config_blob, blobs = make_test_image()
    fixture.serve_image("team/app", "v1", manifest, blobs)
    c = client(store, fixture)
    pulled = c.pull(ImageName("registry.test", "team/app", "v1"))
    assert pulled.digest() == manifest.digest()
    for digest in [manifest.config.digest] + manifest.layer_digests():
        assert store.layers.exists(digest.hex())
    assert store.manifests.exists(ImageName("registry.test", "team/app", "v1"))


def test_pull_missing_manifest_fails(store, fixture):
    with pytest.raises(HTTPError):
        client(store, fixture).pull_manifest("missing")


def test_push_image_roundtrip(store, fixture):
    manifest, config_blob, blobs = make_test_image()
    for hex_digest, blob in blobs.items():
        store.layers.write_bytes(hex_digest, blob)
    name = ImageName("registry.test", "team/app", "v2")
    store.manifests.save(name, manifest)
    c = client(store, fixture)
    c.push(name)
    assert fixture.manifests["team/app:v2"] == manifest.to_bytes()
    for hex_digest, blob in blobs.items():
        assert fixture.blobs[hex_digest] == blob


def test_push_chunked_upload(store, fixture):
    import numpy as np
    payload = np.random.default_rng(0).integers(
        0, 256, size=100_000, dtype=np.uint8).tobytes()
    manifest, config_blob, blobs = make_test_image({"big.bin": payload})
    for hex_digest, blob in blobs.items():
        store.layers.write_bytes(hex_digest, blob)
    name = ImageName("registry.test", "team/app", "v3")
    store.manifests.save(name, manifest)
    c = client(store, fixture, push_chunk=1024)
    c.push(name)
    patches = [u for m, u in fixture.requests if m == "PATCH"]
    assert len(patches) > 5  # actually chunked
    for hex_digest, blob in blobs.items():
        assert fixture.blobs[hex_digest] == blob


def test_push_skips_existing_blobs(store, fixture):
    manifest, config_blob, blobs = make_test_image()
    fixture.blobs.update(blobs)  # registry already has everything
    for hex_digest, blob in blobs.items():
        store.layers.write_bytes(hex_digest, blob)
    name = ImageName("registry.test", "team/app", "v4")
    store.manifests.save(name, manifest)
    client(store, fixture).push(name)
    assert not [u for m, u in fixture.requests if m == "POST"]


def test_push_retries_on_500(store, fixture):
    manifest, config_blob, blobs = make_test_image()
    for hex_digest, blob in blobs.items():
        store.layers.write_bytes(hex_digest, blob)
    name = ImageName("registry.test", "team/app", "v5")
    store.manifests.save(name, manifest)
    # First upload-start attempt for each blob 500s; retry succeeds.
    fixture.override("POST", r"/blobs/uploads/$", Response(500, {}, b"boom"))
    client(store, fixture).push(name)
    for hex_digest, blob in blobs.items():
        assert fixture.blobs[hex_digest] == blob


def test_pull_retries_on_503(store, fixture):
    manifest, config_blob, blobs = make_test_image()
    fixture.serve_image("team/app", "v6", manifest, blobs)
    fixture.override("GET", r"/manifests/v6", Response(503, {}, b"busy"))
    pulled = client(store, fixture).pull_manifest("v6")
    assert pulled.digest() == manifest.digest()


def test_bad_upload_digest_rejected(store, fixture):
    c = client(store, fixture)
    store.layers.write_bytes("ab" * 32, b"some data")
    with pytest.raises(HTTPError):
        c.push_layer(Digest.from_hex("ab" * 32))  # digest != content


def test_token_auth_dance(store):
    fx = RegistryFixture(require_token="tok-xyz")
    manifest, config_blob, blobs = make_test_image()
    fx.serve_image("team/app", "v7", manifest, blobs)
    c = client(store, fx)
    pulled = c.pull_manifest("v7")
    assert pulled.digest() == manifest.digest()
    # The client obtained the token and retried with Bearer auth.
    assert any("/token" in u for _, u in fx.requests)


def test_basic_auth_header_sent(store, fixture):
    from makisu_tpu_torch.registry import SecurityConfig
    manifest, config_blob, blobs = make_test_image()
    fixture.serve_image("team/app", "v8", manifest, blobs)
    cfg = RegistryConfig()
    cfg.security = SecurityConfig(basic_user="u", basic_password="p")
    c = RegistryClient(store, "registry.test", "team/app", config=cfg,
                       transport=fixture)

    seen = {}
    orig = fixture.round_trip

    def spy(method, url, headers, body=None, timeout=60.0):
        seen.setdefault("auth", headers.get("Authorization"))
        return orig(method, url, headers, body, timeout)

    fixture.round_trip = spy
    c.pull_manifest("v8")
    import base64
    assert seen["auth"] == "Basic " + base64.b64encode(b"u:p").decode()


def test_pull_oci_manifest(store, fixture):
    """OCI-typed manifests (schema2-compatible layout) pull fine."""
    import json as json_mod

    from makisu_tpu_torch.docker.image import (
        MEDIA_TYPE_OCI_CONFIG,
        MEDIA_TYPE_OCI_LAYER,
        MEDIA_TYPE_OCI_MANIFEST,
    )  # noqa: F811 (test-local clarity)
    manifest, config_blob, blobs = make_test_image()
    raw = json_mod.loads(manifest.to_bytes())
    raw["mediaType"] = MEDIA_TYPE_OCI_MANIFEST
    raw["config"]["mediaType"] = MEDIA_TYPE_OCI_CONFIG
    for layer in raw["layers"]:
        layer["mediaType"] = MEDIA_TYPE_OCI_LAYER
    fixture.manifests["team/app:oci"] = json_mod.dumps(raw).encode()
    fixture.blobs.update(blobs)
    c = client(store, fixture)
    orig = fixture.round_trip
    accepts = []

    def spy(method, url, headers, body=None, timeout=60.0, stream_to=None):
        if "/manifests/" in url:
            accepts.append(headers.get("Accept", ""))
        return orig(method, url, headers, body, timeout)

    fixture.round_trip = spy
    pulled = c.pull(ImageName("registry.test", "team/app", "oci"))
    # The Accept header advertises both manifest types (the product
    # change under test).
    assert accepts and MEDIA_TYPE_OCI_MANIFEST in accepts[0]
    assert "docker.distribution.manifest.v2" in accepts[0]
    assert len(pulled.layers) == 1
    # OCI media types normalize to docker equivalents on the way in.
    from makisu_tpu_torch.docker.image import MEDIA_TYPE_LAYER
    assert all(l.media_type == MEDIA_TYPE_LAYER for l in pulled.layers)
    for digest in [pulled.config.digest] + pulled.layer_digests():
        assert store.layers.exists(digest.hex())


def test_pull_corrupt_blob_fails_closed(store, fixture):
    """A registry returning wrong bytes for a digest must not poison the
    CAS (reference client.go:288-289, 620-627)."""
    manifest, config_blob, blobs = make_test_image()
    fixture.serve_image("team/app", "bad", manifest, blobs)
    layer_hex = manifest.layers[0].digest.hex()
    fixture.blobs[layer_hex] = b"corrupted bytes from a hostile registry"
    c = client(store, fixture)
    with pytest.raises(ValueError, match="digest mismatch"):
        c.pull(ImageName("registry.test", "team/app", "bad"))
    assert not store.layers.exists(layer_hex)


def test_pull_truncated_blob_fails_closed(store, fixture):
    manifest, config_blob, blobs = make_test_image()
    fixture.serve_image("team/app", "trunc", manifest, blobs)
    layer_hex = manifest.layers[0].digest.hex()
    fixture.blobs[layer_hex] = fixture.blobs[layer_hex][:-1]
    with pytest.raises(ValueError, match="digest mismatch"):
        client(store, fixture).pull_layer(manifest.layers[0].digest)
    assert not store.layers.exists(layer_hex)


def test_pull_redirect_body_never_stored(store, fixture):
    """A 307 blob redirect (Docker Hub, S3/GCS-backed registries) writes
    an HTML stub in its own body; only the redirect target's bytes may
    land in the CAS."""
    manifest, config_blob, blobs = make_test_image()
    layer_digest = manifest.layers[0].digest
    layer_hex = layer_digest.hex()
    layer_blob = blobs[layer_hex]
    fixture.serve_image("team/app", "redir", manifest, blobs)
    # First GET of the layer blob 307s to a CDN path, with the HTML stub
    # Go's http.Redirect emits for GET requests.
    fixture.override(
        "GET", rf"/blobs/sha256:{layer_hex}",
        Response(307, {"location": "https://cdn.test/real-blob"},
                 b'<a href="https://cdn.test/real-blob">Temporary '
                 b"Redirect</a>.\n\n"))
    fixture.override("GET", r"cdn\.test/real-blob", Response(
        200, {}, layer_blob))
    c = client(store, fixture)
    # Injected transports own all traffic, including cross-origin
    # redirect follows — no hand-wiring needed.
    assert c.cdn_transport is fixture
    path = c.pull_layer(layer_digest)
    with open(path, "rb") as f:
        assert f.read() == layer_blob


def test_pull_302_relative_redirect(store, fixture):
    """302 with a relative Location (both allowed by the v2 spec) must
    resolve against the registry origin and still verify."""
    manifest, config_blob, blobs = make_test_image()
    layer_digest = manifest.layers[0].digest
    layer_hex = layer_digest.hex()
    fixture.serve_image("team/app", "r302", manifest, blobs)
    fixture.override(
        "GET", rf"/blobs/sha256:{layer_hex}",
        Response(302, {"location": "/cdn/real-blob"}, b"<a>Found</a>"))
    fixture.override("GET", r"registry\.test/cdn/real-blob",
                     Response(200, {}, blobs[layer_hex]))
    path = client(store, fixture).pull_layer(layer_digest)
    with open(path, "rb") as f:
        assert f.read() == blobs[layer_hex]


def _serve_index(fixture, platforms, media_type=
                 "application/vnd.oci.image.index.v1+json"):
    """Serve per-platform images + an index fanning out to them.
    Returns {os/arch[/variant]: (manifest, manifest_digest_hex)}."""
    import hashlib as hl
    import json as json_mod
    entries = []
    by_platform = {}
    for i, plat in enumerate(platforms):
        parts = plat.split("/")
        manifest, _cfg, blobs = make_test_image(
            files={f"etc/{plat}".replace("/", "-"): plat.encode()})
        raw = manifest.to_bytes()
        digest_hex = hl.sha256(raw).hexdigest()
        fixture.manifests[f"team/app:sha256:{digest_hex}"] = raw
        fixture.blobs.update(blobs)
        platform = {"os": parts[0], "architecture": parts[1]}
        if len(parts) > 2:
            platform["variant"] = parts[2]
        entries.append({
            "mediaType": "application/vnd.oci.image.manifest.v1+json",
            "size": len(raw), "digest": f"sha256:{digest_hex}",
            "platform": platform})
        by_platform[plat] = (manifest, digest_hex)
    index = {"schemaVersion": 2, "manifests": entries}
    if media_type:
        index["mediaType"] = media_type
    fixture.manifests["team/app:multi"] = json_mod.dumps(index).encode()
    return by_platform


def test_pull_manifest_resolves_index_to_default_platform(store, fixture):
    """Multi-arch indexes resolve to linux/amd64 by default — a
    capability the reference lacks (it errors on indexes)."""
    by_platform = _serve_index(
        fixture, ["linux/arm64/v8", "linux/amd64", "windows/amd64"])
    pulled = client(store, fixture).pull_manifest("multi")
    want, _ = by_platform["linux/amd64"]
    assert pulled.config.digest == want.config.digest
    assert pulled.layer_digests() == want.layer_digests()


def test_pull_manifest_index_platform_override(store, fixture, monkeypatch):
    by_platform = _serve_index(
        fixture, ["linux/arm64/v8", "linux/amd64"],
        media_type="application/vnd.docker.distribution.manifest.list.v2+json")
    monkeypatch.setenv("MAKISU_TPU_PLATFORM", "linux/arm64/v8")
    pulled = client(store, fixture).pull_manifest("multi")
    want, _ = by_platform["linux/arm64/v8"]
    assert pulled.config.digest == want.config.digest


def test_pull_manifest_index_missing_platform_lists_available(
        store, fixture, monkeypatch):
    _serve_index(fixture, ["linux/arm64/v8"])
    monkeypatch.setenv("MAKISU_TPU_PLATFORM", "linux/s390x")
    with pytest.raises(ValueError, match="linux/arm64/v8"):
        client(store, fixture).pull_manifest("multi")


def test_pull_manifest_index_tampered_child_refused(store, fixture):
    """The index's child manifest is fetched BY DIGEST, so a registry
    serving different bytes under that digest is caught."""
    import json as json_mod
    by_platform = _serve_index(fixture, ["linux/amd64"])
    _, digest_hex = by_platform["linux/amd64"]
    raw = fixture.manifests[f"team/app:sha256:{digest_hex}"]
    fixture.manifests[f"team/app:sha256:{digest_hex}"] = raw + b"\n"
    with pytest.raises(ValueError, match="digest mismatch"):
        client(store, fixture).pull_manifest("multi")


def test_pull_image_through_index_end_to_end(store, fixture):
    """cli pull of a multi-arch tag: index -> platform manifest ->
    config + layers all land digest-verified."""
    _serve_index(fixture, ["linux/amd64", "linux/arm64"])
    pulled = client(store, fixture).pull(
        ImageName("registry.test", "team/app", "multi"))
    for desc in [pulled.config] + list(pulled.layers):
        assert store.layers.exists(desc.digest.hex())


def test_pull_manifest_zstd_layers_gated_on_libzstd(store, fixture,
                                                    monkeypatch):
    """zstd layers are accepted when libzstd can decode them (kept
    verbatim under their own media type) and rejected up front with an
    error naming libzstd when it can't (tests/test_zstdio.py covers
    the decode side end to end)."""
    import json as json_mod

    from makisu_tpu_torch.utils import zstdio
    manifest, config_blob, blobs = make_test_image()
    raw = json_mod.loads(manifest.to_bytes())
    raw["mediaType"] = MEDIA_TYPE_OCI_MANIFEST
    raw["config"]["mediaType"] = "application/vnd.oci.image.config.v1+json"
    for layer in raw["layers"]:
        layer["mediaType"] = "application/vnd.oci.image.layer.v1.tar+zstd"
    fixture.manifests["team/app:zstd"] = json_mod.dumps(raw).encode()
    monkeypatch.setattr(zstdio, "available", lambda: False)
    with pytest.raises(ValueError, match="libzstd"):
        client(store, fixture).pull_manifest("zstd")
    monkeypatch.setattr(zstdio, "available", lambda: True)
    pulled = client(store, fixture).pull_manifest("zstd")
    assert pulled.layers[0].media_type == \
        "application/vnd.oci.image.layer.v1.tar+zstd"


def test_blob_redirect_chain_followed(store, fixture):
    """CDN-fronted registries produce multi-hop chains (302 -> 302 ->
    200); pull_layer follows them bounded instead of erroring after one
    hop."""
    manifest, config_blob, blobs = make_test_image()
    fixture.serve_image("team/app", "v1", manifest, blobs)
    layer_hex = manifest.layers[0].digest.hex()
    blob_url = f".*/blobs/sha256:{layer_hex}$"
    fixture.override("GET", blob_url, Response(302, {"location": "/hop1"},
                                               b"<html>moved</html>"))
    fixture.override(
        "GET", "/hop1$",
        Response(302, {"location":
                       f"/v2/team/app/blobs/sha256:{layer_hex}"},
                 b"<html>moved again</html>"))
    c = client(store, fixture)
    path = c.pull_layer(manifest.layers[0].digest)
    import hashlib
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == layer_hex


def test_blob_redirect_loop_bounded(store, fixture):
    manifest, config_blob, blobs = make_test_image()
    fixture.serve_image("team/app", "v1", manifest, blobs)
    layer_hex = manifest.layers[0].digest.hex()
    blob_url = f".*/blobs/sha256:{layer_hex}$"
    for _ in range(7):
        fixture.override(
            "GET", blob_url,
            Response(302, {"location":
                           f"/v2/team/app/blobs/sha256:{layer_hex}"},
                     b""))
    c = client(store, fixture)
    with pytest.raises(ValueError, match="redirect hops"):
        c.pull_layer(manifest.layers[0].digest)


def test_pull_manifest_index_variant_semantics(store, fixture, monkeypatch):
    """Bare os/arch accepts the index's sole variant (linux/arm64 →
    arm64/v8); an EXPLICIT variant never silently substitutes."""
    by_platform = _serve_index(fixture, ["linux/arm64/v8", "linux/amd64"])
    monkeypatch.setenv("MAKISU_TPU_PLATFORM", "linux/arm64")
    pulled = client(store, fixture).pull_manifest("multi")
    want, _ = by_platform["linux/arm64/v8"]
    assert pulled.config.digest == want.config.digest
    monkeypatch.setenv("MAKISU_TPU_PLATFORM", "linux/arm64/v6")
    with pytest.raises(ValueError, match="linux/arm64/v8"):
        client(store, fixture).pull_manifest("multi")


# -- the miniregistry, spec level (tests/test_miniregistry.py) ---------------

@pytest.fixture()
def reg():
    with MiniRegistry() as r:
        yield r


def _conn(reg):
    host, _, port = reg.addr.partition(":")
    return http.client.HTTPConnection(host, int(port), timeout=10)


def _req(reg, method, path, body=None, headers=None):
    c = _conn(reg)
    c.request(method, path, body=body, headers=headers or {})
    resp = c.getresponse()
    data = resp.read()
    c.close()
    return resp, data


def _digest(data: bytes) -> str:
    return "sha256:" + hashlib.sha256(data).hexdigest()


def test_api_version_check(reg):
    resp, _ = _req(reg, "GET", "/v2/")
    assert resp.status == 200
    assert resp.headers["Docker-Distribution-Api-Version"] == \
        "registry/2.0"


def test_monolithic_post_upload_and_pull(reg):
    blob = b"monolithic payload"
    d = _digest(blob)
    resp, _ = _req(reg, "POST", f"/v2/lib/app/blobs/uploads/?digest={d}",
                   body=blob)
    assert resp.status == 201
    assert resp.headers["Docker-Content-Digest"] == d
    resp, data = _req(reg, "GET", f"/v2/lib/app/blobs/{d}")
    assert resp.status == 200 and data == blob
    # HEAD: headers only
    resp, data = _req(reg, "HEAD", f"/v2/lib/app/blobs/{d}")
    assert resp.status == 200 and data == b""
    assert resp.headers["Docker-Content-Digest"] == d


def test_chunked_upload_range_discipline(reg):
    blob = b"0123456789" * 100
    resp, _ = _req(reg, "POST", "/v2/lib/app/blobs/uploads/")
    assert resp.status == 202
    loc = resp.headers["Location"]
    assert resp.headers["Docker-Upload-UUID"]
    # In-order chunks with Content-Range accepted, ranges echoed.
    resp, _ = _req(reg, "PATCH", loc, body=blob[:400],
                   headers={"Content-Range": "0-399"})
    assert resp.status == 202
    assert resp.headers["Range"] == "0-399"
    # Out-of-order chunk: 416 with the current range.
    resp, _ = _req(reg, "PATCH", loc, body=blob[500:],
                   headers={"Content-Range": "500-999"})
    assert resp.status == 416
    assert resp.headers["Range"] == "0-399"
    resp, _ = _req(reg, "PATCH", loc, body=blob[400:],
                   headers={"Content-Range": "400-999"})
    assert resp.status == 202
    d = _digest(blob)
    resp, _ = _req(reg, "PUT", f"{loc}?digest={d}")
    assert resp.status == 201
    resp, data = _req(reg, "GET", f"/v2/lib/app/blobs/{d}")
    assert resp.status == 200 and data == blob


def test_upload_digest_mismatch_rejected(reg):
    resp, _ = _req(reg, "POST", "/v2/lib/app/blobs/uploads/")
    loc = resp.headers["Location"]
    _req(reg, "PATCH", loc, body=b"actual content")
    wrong = _digest(b"different content")
    resp, data = _req(reg, "PUT", f"{loc}?digest={wrong}")
    assert resp.status == 400
    assert json.loads(data)["errors"][0]["code"] == "DIGEST_INVALID"
    # The upload session is still consumable after the failed commit.
    right = _digest(b"actual content")
    resp, _ = _req(reg, "PUT", f"{loc}?digest={right}")
    assert resp.status == 201


def test_blob_unknown_error_shape(reg):
    resp, data = _req(reg, "GET", f"/v2/lib/app/blobs/{_digest(b'no')}")
    assert resp.status == 404
    err = json.loads(data)["errors"][0]
    assert err["code"] == "BLOB_UNKNOWN"


def _push_blob(reg, name, blob):
    d = _digest(blob)
    resp, _ = _req(reg, "POST", f"/v2/{name}/blobs/uploads/?digest={d}",
                   body=blob)
    assert resp.status == 201
    return d


def _schema2(config_digest, config_size, layers):
    return {
        "schemaVersion": 2,
        "mediaType": "application/vnd.docker.distribution.manifest"
                     ".v2+json",
        "config": {
            "mediaType": "application/vnd.docker.container.image.v1+json",
            "digest": config_digest, "size": config_size,
        },
        "layers": [
            {"mediaType": "application/vnd.docker.image.rootfs.diff"
                          ".tar.gzip", "digest": d, "size": s}
            for d, s in layers
        ],
    }


def test_manifest_push_requires_referenced_blobs(reg):
    cfg = b'{"os": "linux"}'
    cfg_d = _push_blob(reg, "lib/app", cfg)
    man = _schema2(cfg_d, len(cfg), [(_digest(b"missing layer"), 13)])
    resp, data = _req(
        reg, "PUT", "/v2/lib/app/manifests/v1",
        body=json.dumps(man).encode(),
        headers={"Content-Type": man["mediaType"]})
    assert resp.status == 400
    assert json.loads(data)["errors"][0]["code"] == \
        "MANIFEST_BLOB_UNKNOWN"


def test_manifest_roundtrip_by_tag_and_digest(reg):
    cfg, layer = b'{"os": "linux"}', b"layer bytes"
    cfg_d = _push_blob(reg, "lib/app", cfg)
    layer_d = _push_blob(reg, "lib/app", layer)
    man = _schema2(cfg_d, len(cfg), [(layer_d, len(layer))])
    raw = json.dumps(man).encode()
    resp, _ = _req(reg, "PUT", "/v2/lib/app/manifests/v1", body=raw,
                   headers={"Content-Type": man["mediaType"]})
    assert resp.status == 201
    man_d = resp.headers["Docker-Content-Digest"]
    assert man_d == _digest(raw)
    for ref in ("v1", man_d):
        resp, data = _req(reg, "GET", f"/v2/lib/app/manifests/{ref}")
        assert resp.status == 200 and data == raw
        assert resp.headers["Content-Type"] == man["mediaType"]
        assert resp.headers["Docker-Content-Digest"] == man_d
    resp, data = _req(reg, "GET", "/v2/lib/app/tags/list")
    assert json.loads(data) == {"name": "lib/app", "tags": ["v1"]}


def test_manifest_put_by_digest_must_match(reg):
    cfg = b"{}"
    cfg_d = _push_blob(reg, "lib/app", cfg)
    man = _schema2(cfg_d, len(cfg), [])
    raw = json.dumps(man).encode()
    wrong = _digest(b"other")
    resp, data = _req(reg, "PUT", f"/v2/lib/app/manifests/{wrong}",
                      body=raw,
                      headers={"Content-Type": man["mediaType"]})
    assert resp.status == 400
    assert json.loads(data)["errors"][0]["code"] == "DIGEST_INVALID"


def test_manifest_list_requires_sub_manifests(reg):
    idx = {
        "schemaVersion": 2,
        "mediaType": "application/vnd.docker.distribution.manifest"
                     ".list.v2+json",
        "manifests": [{
            "mediaType": "application/vnd.docker.distribution.manifest"
                         ".v2+json",
            "digest": _digest(b"nope"), "size": 4,
            "platform": {"os": "linux", "architecture": "amd64"},
        }],
    }
    resp, data = _req(reg, "PUT", "/v2/lib/app/manifests/multi",
                      body=json.dumps(idx).encode(),
                      headers={"Content-Type": idx["mediaType"]})
    assert resp.status == 400
    assert json.loads(data)["errors"][0]["code"] == \
        "MANIFEST_BLOB_UNKNOWN"


def test_blob_range_requests(reg):
    """Range GETs over a real socket: 206 with exactly the requested
    slice (the chunk-pack consumer path), 200 for malformed or
    multi-range specs (serving the whole blob is always legal), and
    clamping at the blob's end."""
    data = bytes(range(256)) * 40  # 10240 bytes
    digest = _digest(data)
    resp, _ = _req(reg, "POST",
                   "/v2/r/app/blobs/uploads/?digest=" + digest,
                   body=data)
    assert resp.status == 201

    resp, body = _req(reg, "GET", f"/v2/r/app/blobs/{digest}",
                      headers={"Range": "bytes=100-355"})
    assert resp.status == 206
    assert body == data[100:356]

    # Clamped past EOF.
    resp, body = _req(reg, "GET", f"/v2/r/app/blobs/{digest}",
                      headers={"Range": "bytes=10200-999999"})
    assert resp.status == 206
    assert body == data[10200:]

    # Unsupported shapes degrade to the full blob.
    for bad in ("bytes=5-2", "bytes=-100", "bytes=0-1,5-9", "chars=1-2"):
        resp, body = _req(reg, "GET", f"/v2/r/app/blobs/{digest}",
                          headers={"Range": bad})
        assert resp.status == 200, bad
        assert body == data


def test_cross_repo_mount(reg):
    blob = b"shared base layer"
    d = _push_blob(reg, "lib/base", blob)
    resp, _ = _req(reg, "POST",
                   f"/v2/lib/app/blobs/uploads/?mount={d}&from=lib/base")
    assert resp.status == 201
    resp, data = _req(reg, "GET", f"/v2/lib/app/blobs/{d}")
    assert resp.status == 200 and data == blob
    # Mount of a missing blob falls back to a fresh upload session.
    resp, _ = _req(
        reg, "POST",
        f"/v2/lib/app/blobs/uploads/?mount={_digest(b'no')}&from=lib/base")
    assert resp.status == 202
    assert resp.headers["Docker-Upload-UUID"]


def test_blobs_are_repo_scoped(reg):
    d = _push_blob(reg, "lib/one", b"scoped")
    resp, _ = _req(reg, "GET", f"/v2/lib/other/blobs/{d}")
    assert resp.status == 404


# -- both packages on one loopback registry ----------------------------------

@pytest.fixture
def no_mounts_or_wait(monkeypatch):
    """Tmp build roots must not inherit the host's mount table, and
    COPY-only builds skip MemFS's one-second wait before each commit."""
    mountinfo.set_mountpoints_for_testing(set())
    monkeypatch.setattr(memfs.MemFS, "_sync", lambda self: None)
    monkeypatch.setattr(ref_memfs.MemFS, "_sync", lambda self: None)
    yield
    mountinfo.set_mountpoints_for_testing(None)


@pytest.fixture
def mini():
    with MiniRegistry() as r:
        yield r


HASHERS = {"reference": "tpu", "port": "gpu"}


def run_cli(pkg, tmp_path, *argv, log=None):
    """One command of either package's CLI, logging JSON to ``log``."""
    head = ["--log-fmt", "json"]
    if log is not None:
        head += ["--log-output", str(log)]
    if pkg == "reference":
        return ref_cli.main(head + list(argv))
    return one_shot_main(head + list(argv))


def build(pkg, tmp_path, ctx, storage, tag, *extra, hasher=None, log=None):
    root = tmp_path / f"root-{pkg}-{storage.name}-{tag.replace('/', '_')}"
    root.mkdir(exist_ok=True)
    return run_cli(pkg, tmp_path, "build", str(ctx), "-t", tag,
                   "--storage", str(storage), "--root", str(root),
                   "--hasher", hasher or HASHERS[pkg], *extra, log=log)


def small_ctx(path, seed, dockerfile="FROM scratch\nCOPY . /app/\n"):
    make_context(path, seed=seed, nfiles=6, text_kb=6, blob_kb=(48, 8))
    (path / "Dockerfile").write_text(dockerfile)
    return path


def raw_kv(storage):
    with open(storage / "cache_key_value.json") as f:
        return {k: (json.loads(v) if v.startswith("{") else v)
                for k, (v, _ts) in json.load(f).items()}


@pytest.mark.parametrize("pusher", ["reference", "port"])
def test_from_a_registry_base_matches_reference(tmp_path, no_mounts_or_wait,
                                                mini, pusher):
    """A base pushed by ``pusher``; both packages then build FROM it into
    fresh storages: the same manifests, diff_ids, configs (minus
    ``created``) and cache entries."""
    base_ctx = small_ctx(tmp_path / "base", seed=21)
    assert build(pusher, tmp_path, base_ctx, tmp_path / "base-store",
                 "lib/base:1", "--push", mini.addr, hasher="cpu") == 0
    app = small_ctx(tmp_path / "app", seed=22,
                    dockerfile=f"FROM {mini.addr}/lib/base:1\n"
                               "COPY app /srv/app/\nENV MODE=derived\n")
    logs = {}
    for pkg in ("reference", "port"):
        logs[pkg] = tmp_path / f"{pkg}.log"
        assert build(pkg, tmp_path, app, tmp_path / pkg, "test/app:1",
                     log=logs[pkg]) == 0
    ma, ca = load_image(tmp_path / "reference")
    mb, cb = load_image(tmp_path / "port")
    assert ma["layers"] == mb["layers"] and len(mb["layers"]) == 2
    assert ca["rootfs"]["diff_ids"] == cb["rootfs"]["diff_ids"]
    assert timeless(ca) == timeless(cb)
    assert kv_entries(tmp_path / "reference") == kv_entries(tmp_path / "port")
    assert count_lines(logs["port"], "applying FROM layer") == 1
    # The pull saved the base's manifest under its name.
    assert (tmp_path / "port" / "manifests" / "lib" / "base"
            / "1.json").exists()


def repo_blobs(mini, repo):
    return mini.state.repos[repo].blobs


@pytest.mark.parametrize("backend", ["zlib", "pgzip"])
def test_pushed_layers_packs_and_pins_match_reference(
        tmp_path, no_mounts_or_wait, mini, backend):
    """The reference (tpu hasher) and the port (gpu hasher) push the same
    context with ``--push``: equal layer blobs, equal chunk packs (blobs
    and the entries' pack maps) and equal pin manifests."""
    ctx = small_ctx(tmp_path / "ctx", seed=23)
    for pkg in ("reference", "port"):
        assert build(pkg, tmp_path, ctx, tmp_path / pkg, f"{pkg}/app:1",
                     "--push", mini.addr, "--gzip-backend", backend) == 0
    kv_ref, kv_port = raw_kv(tmp_path / "reference"), \
        raw_kv(tmp_path / "port")
    assert kv_ref == kv_port
    layer_entries = [e for e in kv_port.values() if isinstance(e, dict)]
    assert layer_entries and all(e.get("packs") for e in layer_entries)
    ref_repo, port_repo = mini.state.repos["reference/app"], \
        mini.state.repos["port/app"]
    manifests = [json.loads(r.manifests["1"][1])
                 for r in (ref_repo, port_repo)]
    assert manifests[0]["layers"] == manifests[1]["layers"]
    pack_hexes = {p for e in layer_entries for p, _ in e["packs"]}
    wanted = {d["digest"] for d in manifests[1]["layers"]} | {
        "sha256:" + h for h in pack_hexes}
    for digest in wanted:
        assert port_repo.blobs[digest] == ref_repo.blobs[digest]
    # Each pack holds exactly its members' bytes, in index order.
    for e in layer_entries:
        for pack_hex, members in e["packs"]:
            blob = port_repo.blobs["sha256:" + pack_hex]
            assert hashlib.sha256(blob).hexdigest() == pack_hex
            assert len(blob) == sum(e["chunks"][i][1] for i in members)
        hexes = [c[2] for c in e["chunks"]]
        assert sorted(hexes[i] for _, m in e["packs"] for i in m) == \
            sorted(set(hexes))
    pins = sorted(t for t in port_repo.tags if t.startswith("makisu-packs-"))
    assert pins and pins == sorted(
        t for t in ref_repo.tags if t.startswith("makisu-packs-"))
    for tag in pins:
        raw = port_repo.manifests[tag][1]
        assert raw == ref_repo.manifests[tag][1]
        assert {l["mediaType"] for l in json.loads(raw)["layers"]} == \
            {PACK_MEDIA_TYPE}


PAYLOAD_DOCKERFILE = "FROM scratch\nCOPY blob.bin /blob.bin\n"


def plan_build(*args):
    """One builder of ``tests/test_chunk_dedup.py``'s registry cases (its
    own layer store and chunk CAS, the KV and the registry shared), in a
    copy of the context as a build process of its own: the chunk
    observer that attaching chunk dedup binds must not outlive it."""
    return contextvars.copy_context().run(_plan_build, *args)


def _plan_build(pkg, tmp_path, fixture, kv, repo, tag, store_name,
                chunk_name, ctx_dir):
    root = tmp_path / f"root-{tag}"
    root.mkdir(exist_ok=True)
    if pkg == "reference":
        store = RefImageStore(str(tmp_path / store_name))
        client = RefRegistryClient(store, "registry.test", repo,
                                   transport=fixture)
        ctx = RefBuildContext(str(root), str(ctx_dir), store,
                              hasher=TPUHasher(), sync_wait=0.0)
        mgr = RefCacheManager(kv, store, registry_client=client)
        ref_attach(mgr, str(tmp_path / chunk_name))
        plan = RefBuildPlan(ctx, RefImageName("", repo, tag), [], mgr,
                            ref_parse_file(PAYLOAD_DOCKERFILE),
                            allow_modify_fs=False, force_commit=True)
    else:
        store = ImageStore(str(tmp_path / store_name))
        client = RegistryClient(store, "registry.test", repo,
                                transport=fixture)
        ctx = BuildContext(str(root), str(ctx_dir), store,
                           hasher=GPUHasher(device="cpu"))
        mgr = CacheManager(kv, store, registry_client=client)
        attach_chunk_dedup(mgr, str(tmp_path / chunk_name))
        plan = BuildPlan(ctx, ImageName("", repo, tag), [], mgr,
                         parse_file(PAYLOAD_DOCKERFILE),
                         allow_modify_fs=False, force_commit=True)
    manifest = plan.execute()
    mgr.wait_for_push()
    return manifest, store, mgr


def payload_ctx(tmp_path, seed, size):
    ctx_dir = tmp_path / "ctx"
    ctx_dir.mkdir()
    (ctx_dir / "blob.bin").write_bytes(np.random.default_rng(seed).integers(
        0, 256, size=size, dtype=np.uint8).tobytes())
    return ctx_dir


PAIRS = [("reference", "port"), ("port", "reference")]


@pytest.mark.parametrize("a,b", PAIRS, ids=["ref-to-port", "port-to-ref"])
def test_chunks_distribute_through_registry_plane(tmp_path,
                                                  no_mounts_or_wait, a, b):
    """Builder A of one package, builder B of the other, separate chunk
    stores, only the KV and the registry shared: with the layer blob
    gone from the registry, B applies the layer from chunk packs A
    pushed, and rebuilds the blob byte for byte."""
    ctx_dir = payload_ctx(tmp_path, 3, 120_000)
    kv, fixture = MemoryStore(), RegistryFixture()
    m1, _, _ = plan_build(a, tmp_path, fixture, kv, "t/remote", "a",
                          "store-a", "chunks-a", ctx_dir)
    layer_hex = m1.layers[0].digest.hex()
    evicted = fixture.blobs.pop(layer_hex)
    m2, store_b, mgr_b = plan_build(b, tmp_path, fixture, kv, "t/remote",
                                    "b", "store-b", "chunks-b", ctx_dir)
    assert [str(l.digest) for l in m1.layers] == \
        [str(l.digest) for l in m2.layers]
    assert not store_b.layers.exists(layer_hex)
    packs = [u for m, u in fixture.requests
             if m == "GET" and "/blobs/" in u]
    assert packs  # B fetched pack blobs from the registry
    mgr_b.materialize_pending()
    with store_b.layers.open(layer_hex) as f:
        assert f.read() == evicted


@pytest.mark.parametrize("a,b", PAIRS, ids=["ref-to-port", "port-to-ref"])
def test_chunks_survive_registry_gc(tmp_path, no_mounts_or_wait, a, b):
    """The pack pin manifest A tagged keeps its packs through the
    registry's GC; B, of the other package, rebuilds the layer from
    them."""
    ctx_dir = payload_ctx(tmp_path, 9, 150_000)
    kv, fixture = MemoryStore(), RegistryFixture()
    m1, _, _ = plan_build(a, tmp_path, fixture, kv, "cache/gc", "a",
                          "store-a", "chunks-a", ctx_dir)
    layer_hex = m1.layers[0].digest.hex()
    assert f"cache/gc:makisu-packs-{layer_hex[:40]}" in fixture.manifests
    removed = fixture.gc()
    assert layer_hex in removed and fixture.blobs
    m2, store_b, mgr_b = plan_build(b, tmp_path, fixture, kv, "cache/gc",
                                    "b", "store-b", "chunks-b", ctx_dir)
    assert [str(l.digest) for l in m1.layers] == \
        [str(l.digest) for l in m2.layers]
    mgr_b.materialize_pending()
    assert store_b.layers.exists(layer_hex)
    with store_b.layers.open(layer_hex) as f:
        assert hashlib.sha256(f.read()).hexdigest() == layer_hex


def tree_files(root):
    """relative path -> bytes (or link target) of every file under root."""
    out = {}
    for dirpath, dirnames, names in os.walk(root):
        for name in names + [d for d in dirnames
                             if os.path.islink(os.path.join(dirpath, d))]:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            out[rel] = (os.readlink(path) if os.path.islink(path)
                        else open(path, "rb").read())
    return out


def test_pull_push_diff_and_oci_layouts_match_reference(
        tmp_path, no_mounts_or_wait, mini, capsys):
    """Two images pushed by the port; each package then pulls (with an
    OCI layout, as a directory and as an archive, and an extracted
    rootfs), diffs the two images, and pushes a docker-save tar: the
    same stores, layouts, trees, diff lines and registry manifests."""
    for tag, seed in (("lib/app:1", 31), ("lib/app:2", 32)):
        ctx = small_ctx(tmp_path / f"ctx{seed}", seed=seed)
        extra = ["--dest", str(tmp_path / "image.tar")] \
            if tag.endswith(":1") else []
        assert build("port", tmp_path, ctx, tmp_path / "src", tag,
                     "--push", mini.addr, *extra, hasher="cpu") == 0
    out = {}
    for pkg in ("reference", "port"):
        storage = tmp_path / f"pull-{pkg}"
        layout = tmp_path / f"oci-{pkg}"
        extract = tmp_path / f"rootfs-{pkg}"
        assert run_cli(pkg, tmp_path, "pull", f"{mini.addr}/lib/app:1",
                       "--storage", str(storage), "--oci-dest", str(layout),
                       "--extract", str(extract)) == 0
        assert run_cli(pkg, tmp_path, "pull", f"{mini.addr}/lib/app:2",
                       "--storage", str(storage), "--oci-dest",
                       str(tmp_path / f"oci-{pkg}.tar")) == 0
        capsys.readouterr()
        assert run_cli(pkg, tmp_path, "diff", f"{mini.addr}/lib/app:1",
                       f"{mini.addr}/lib/app:2", "--storage",
                       str(tmp_path / f"diff-{pkg}")) == 0
        diff = capsys.readouterr().out.splitlines()
        assert run_cli(pkg, tmp_path, "push", str(tmp_path / "image.tar"),
                       "-t", f"{pkg}/pushed:1", "--push", mini.addr,
                       "--storage", str(tmp_path / f"push-{pkg}")) == 0
        out[pkg] = {
            "store": {k: v for k, v in tree_files(storage).items()
                      if not k.startswith("sandbox")},
            "layout": tree_files(layout),
            "archive": (tmp_path / f"oci-{pkg}.tar").read_bytes(),
            "rootfs": tree_files(extract),
            "diff": [line for line in diff if not line.startswith("{")],
            "pushed": mini.state.repos[f"{pkg}/pushed"].manifests["1"],
        }
    assert out["port"] == out["reference"]
    assert out["port"]["diff"]  # the two images differ
    assert any(k.endswith(".js") for k in out["port"]["rootfs"])
    with tarfile.open(tmp_path / "oci-port.tar") as tf:
        assert "oci-layout" in tf.getnames()
    pushed = json.loads(out["port"]["pushed"][1])
    assert pushed["layers"] and all(
        d["digest"] in mini.state.repos["port/pushed"].blobs
        for d in pushed["layers"])


def test_pull_delta_and_remote_caches_stay_unported(tmp_path):
    """``pull --delta``/``--report-out``, the remote KV caches and the
    build's storage budget are ported (they parse, as the reference's
    parser parses them; ``tests/test_torch_serve.py``,
    ``test_torch_peers.py`` and ``test_torch_build.py`` drive them
    against loopback servers and local dirs only, never a real
    registry). ``pull --storage-remote`` stays an argparse error in both
    packages: only ``build`` and ``worker`` take it."""
    parser = cli.make_parser()
    args = parser.parse_args(["pull", "x/y:1", "--delta", "sock",
                              "--report-out", "r.json"])
    assert (args.delta, args.report_out) == ("sock", "r.json")
    args = parser.parse_args(["build", str(tmp_path), "-t", "a:1",
                              "--redis-cache-addr", "127.0.0.1:1",
                              "--http-cache-addr", "127.0.0.1:2"])
    assert (args.redis_cache_addr, args.http_cache_addr) == \
        ("127.0.0.1:1", "127.0.0.1:2")
    argv = ["build", str(tmp_path), "-t", "a:1", "--storage-budget", "1",
            "--storage-remote", "d"]
    args = parser.parse_args(argv)
    ref_args = ref_cli.make_parser().parse_args(argv)
    assert (args.storage_budget, args.storage_remote) == (1, "d") == \
        (ref_args.storage_budget, ref_args.storage_remote)
    for pkg_main in (lambda a: cli.main(a, device="cpu"), ref_cli.main):
        with pytest.raises(SystemExit) as e:
            pkg_main(["pull", "x/y:1", "--storage-remote", "d"])
        assert e.value.code == 2


def test_build_load_and_oci_dest(tmp_path, no_mounts_or_wait):
    """``--load`` posts the docker-save tar to the daemon's unix socket
    (a stand-in server here) and ``--oci-dest`` writes the layout: both
    hold the built image's layers."""
    import socketserver
    import threading
    from http.server import BaseHTTPRequestHandler

    got = {}

    class Daemon(BaseHTTPRequestHandler):
        def do_POST(self):
            # A file body goes out chunked (no Content-Length).
            body = bytearray()
            while True:
                n = int(self.rfile.readline().strip(), 16)
                body += self.rfile.read(n)
                self.rfile.readline()
                if n == 0:
                    break
            got[self.path] = bytes(body)
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *args):
            pass

    class UnixServer(socketserver.ThreadingMixIn,
                     socketserver.UnixStreamServer):
        daemon_threads = True

        def get_request(self):
            conn, _ = super().get_request()
            return conn, ("local", 0)

    sock = str(tmp_path / "docker.sock")
    server = UnixServer(sock, Daemon)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        ctx = small_ctx(tmp_path / "ctx", seed=41)
        assert build("port", tmp_path, ctx, tmp_path / "s", "test/app:1",
                     "--load", "--docker-host", f"unix://{sock}",
                     "--docker-version", "1.40", "--oci-dest",
                     str(tmp_path / "oci"), hasher="cpu") == 0
    finally:
        server.shutdown()
        server.server_close()
    manifest, config = load_image(tmp_path / "s")
    with tarfile.open(fileobj=io.BytesIO(got["/v1.40/images/load"])) as tf:
        [export] = json.load(tf.extractfile("manifest.json"))
        assert export["RepoTags"] == ["test/app:1"]
        diff_ids = ["sha256:" + hashlib.sha256(
            tf.extractfile(n).read()).hexdigest() for n in export["Layers"]]
    assert diff_ids == config["rootfs"]["diff_ids"]
    index = json.loads((tmp_path / "oci" / "index.json").read_bytes())
    [desc] = index["manifests"]
    oci = json.loads((tmp_path / "oci" / "blobs" / "sha256"
                      / desc["digest"].split(":")[1]).read_bytes())
    assert oci["mediaType"] == MEDIA_TYPE_OCI_MANIFEST
    assert [d["digest"] for d in oci["layers"]] == \
        [d["digest"] for d in manifest["layers"]]


# -- the pack plane (tests/test_chunk_dedup.py's pack cases) -----------------

def test_plan_pack_runs_matches_reference():
    import random

    from makisu_tpu.cache import chunks as ref_chunks
    from makisu_tpu_torch.cache import chunks as port_chunks

    rnd = random.Random(5)
    for _ in range(40):
        rows, off = [], {}
        for i in range(rnd.randint(1, 80)):
            pack = f"{rnd.randrange(4):064x}"
            n = rnd.randint(1, 60_000)
            rows.append((f"{i:064x}", n, pack, off.get(pack, 0)))
            off[pack] = off.get(pack, 0) + n
        missing = {r[0] for r in rows if rnd.random() < 0.4}
        for gap, frac in ((None, None), (0, 0.9), (1 << 20, -1.0)):
            assert port_chunks.plan_pack_runs(rows, missing, gap, frac) \
                == ref_chunks.plan_pack_runs(rows, missing, gap, frac)


def test_pack_roundtrip_property_randomized(tmp_path):
    """Arbitrary chunk layouts (sizes, repeated digests): the port's packs
    equal the reference's, and a consumer fetching them through
    ensure_available, ranged or whole, gets every chunk bit-exactly."""
    import gzip as gz
    import random

    from makisu_tpu.cache.chunks import ChunkStore as RefChunkStore
    from makisu_tpu_torch.cache import ChunkStore

    rnd = random.Random(77)
    for trial in range(6):
        blobs = []
        for i in range(rnd.randint(1, 60)):
            if i > 2 and rnd.random() < 0.2:
                blobs.append(blobs[rnd.randrange(i)])
            else:
                blobs.append(rnd.randbytes(rnd.randint(1, 30_000)))
        stream = b"".join(blobs)
        triples, pos = [], 0
        for data in blobs:
            triples.append((pos, len(data), hashlib.sha256(data).hexdigest()))
            pos += len(data)
        blob_path = tmp_path / f"layer{trial}.gz"
        blob_path.write_bytes(gz.compress(stream, mtime=0))
        producer = ChunkStore(str(tmp_path / f"prod{trial}"))
        added = producer.index_layer(str(blob_path), triples)
        packs = producer.build_packs(triples, added)
        ref = RefChunkStore(str(tmp_path / f"ref{trial}"))
        assert packs == ref.build_packs(
            triples, ref.index_layer(str(blob_path), triples))
        assert sorted(triples[i][2] for _, m in packs for i in m) == \
            sorted(added)
        pack_bytes = {p: producer.get(p) for p, _ in packs}
        producer.drop_local_packs(packs)
        consumer = ChunkStore(str(tmp_path / f"cons{trial}"))

        class PackRegistry:
            def pull_layer(self, digest):
                consumer.cas.write_bytes(digest.hex(),
                                         pack_bytes[digest.hex()])

            def pull_blob_range(self, digest, start, end, trial=trial):
                if trial % 2:
                    return None  # the whole-pack route
                return "partial", pack_bytes[digest.hex()][start:end]

        consumer.registry = PackRegistry()
        assert consumer.ensure_available(
            triples, [[p, members] for p, members in packs])
        for offset, length, hex_digest in triples:
            assert consumer.get(hex_digest) == \
                stream[offset:offset + length]


def test_single_member_pack_aliases_its_chunk_safely(tmp_path):
    import gzip as gz

    from makisu_tpu_torch.cache import ChunkStore

    data = b"q" * 5000
    chunk_hex = hashlib.sha256(data).hexdigest()
    blob_path = tmp_path / "layer.gz"
    blob_path.write_bytes(gz.compress(data, mtime=0))
    store = ChunkStore(str(tmp_path / "chunks"))
    triples = [(0, len(data), chunk_hex)]
    added = store.index_layer(str(blob_path), triples)
    packs = store.build_packs(triples, added)
    assert packs == [(chunk_hex, [0])]
    store.drop_local_packs(packs)
    assert store.cas.exists(chunk_hex)
    consumer = ChunkStore(str(tmp_path / "chunks2"))

    class OneBlobRegistry:
        def pull_layer(self, digest):
            assert digest.hex() == chunk_hex
            consumer.cas.write_bytes(chunk_hex, data)

        def pull_blob_range(self, digest, start, end):
            return None

    consumer.registry = OneBlobRegistry()
    assert consumer.ensure_available(triples, [[chunk_hex, [0]]])
    assert consumer.cas.exists(chunk_hex)


def push_layers(pkg, store, mgr, fixture, repo, manifest):
    client_cls = RefRegistryClient if pkg == "reference" else RegistryClient
    client = client_cls(store, "registry.test", repo, transport=fixture)
    client.materialize_blob = mgr.materialize
    for layer in manifest.layers:
        client.push_layer(layer.digest)


@pytest.mark.parametrize("a,b", PAIRS, ids=["ref-to-port", "port-to-ref"])
def test_warm_rebuild_after_edit_moves_no_blob_bytes(
        tmp_path, no_mounts_or_wait, a, b):
    """B (one package) built v1; A (the other) builds v2, a 10-byte
    insert, and pushes. B's rebuild of v2 hits, fetches only the novel
    chunks out of A's packs (ranged), never the blob, never writes it,
    and its push uploads nothing."""
    rng = np.random.default_rng(3)
    v1 = rng.integers(0, 256, size=600_000, dtype=np.uint8).tobytes()
    v2 = v1[:5_000] + b"EDITEDEDIT" + v1[5_000:]
    kv, fixture = MemoryStore(), RegistryFixture()

    def one(pkg, tag, store_name, chunk_name, payload, push=False):
        ctx_dir = tmp_path / f"ctx-{tag}"
        ctx_dir.mkdir()
        (ctx_dir / "blob.bin").write_bytes(payload)
        manifest, store, mgr = plan_build(
            pkg, tmp_path, fixture, kv, "cache/ns", tag, store_name,
            chunk_name, ctx_dir)
        if push:
            push_layers(pkg, store, mgr, fixture, "cache/ns", manifest)
        return manifest, store

    one(b, "b-v1", "store-b", "chunks-b", v1)
    m_a, _ = one(a, "a-v2", "store-a", "chunks-a", v2, push=True)
    layer_hex = m_a.layers[0].digest.hex()
    assert layer_hex in fixture.blobs
    before = len(fixture.requests)
    m_b, store_b = one(b, "b-v2", "store-b", "chunks-b", v2, push=True)
    new = fixture.requests[before:]
    assert [str(l.digest) for l in m_b.layers] == \
        [str(l.digest) for l in m_a.layers]
    assert [u for m, u in new if m == "GET" and layer_hex in u] == []
    gets = [u for m, u in new if m == "GET" and "/blobs/sha256:" in u]
    assert 0 < len(gets) < 20
    assert not store_b.layers.exists(layer_hex)
    assert [u for m, u in new
            if m in ("POST", "PATCH", "PUT") and "/blobs/" in u] == []


@pytest.mark.parametrize("a,b", PAIRS, ids=["ref-to-port", "port-to-ref"])
def test_pack_fetch_verifies_and_degrades_on_corruption(
        tmp_path, no_mounts_or_wait, a, b):
    """Every pack zeroed in the registry: B's carve refuses the corrupt
    members, the pull takes the blob route, and B's chunk CAS holds only
    chunks whose bytes match their names."""
    ctx_dir = payload_ctx(tmp_path, 22, 300_000)
    kv, fixture = MemoryStore(), RegistryFixture()
    m_a, store_a, mgr_a = plan_build(a, tmp_path, fixture, kv, "t/corrupt",
                                     "a", "store-a", "chunks-a", ctx_dir)
    push_layers(a, store_a, mgr_a, fixture, "t/corrupt", m_a)
    entries = [json.loads(v) for v in kv._data.values()
               if v.startswith("{")]
    pack_hexes = {p for e in entries for p, _ in e.get("packs", [])}
    assert pack_hexes
    for pack_hex in pack_hexes:
        fixture.blobs[pack_hex] = b"\x00" * len(fixture.blobs[pack_hex])
    m_b, store_b, _ = plan_build(b, tmp_path, fixture, kv, "t/corrupt", "b",
                                 "store-b", "chunks-b", ctx_dir)
    assert [str(l.digest) for l in m_b.layers] == \
        [str(l.digest) for l in m_a.layers]
    assert store_b.layers.exists(m_a.layers[0].digest.hex())
    root = tmp_path / "chunks-b"
    for shard in os.listdir(root):
        if shard != "_tmp":
            for name in os.listdir(root / shard):
                data = (root / shard / name).read_bytes()
                assert hashlib.sha256(data).hexdigest() == name


@pytest.mark.parametrize("a,b", PAIRS, ids=["ref-to-port", "port-to-ref"])
def test_packs_disabled_restores_per_chunk_blobs(
        tmp_path, no_mounts_or_wait, monkeypatch, a, b):
    monkeypatch.setenv("MAKISU_TPU_CHUNK_PACKS", "0")
    ctx_dir = payload_ctx(tmp_path, 23, 200_000)
    kv, fixture = MemoryStore(), RegistryFixture()
    m_a, _, _ = plan_build(a, tmp_path, fixture, kv, "t/nopack", "a",
                           "store-a", "chunks-a", ctx_dir)
    entries = [json.loads(v) for v in kv._data.values()
               if v.startswith("{")]
    assert entries and not any(e.get("packs") for e in entries)
    assert any(t.startswith("t/nopack:makisu-chunks-")
               for t in fixture.manifests)
    before = len(fixture.requests)
    m_b, _, _ = plan_build(b, tmp_path, fixture, kv, "t/nopack", "b",
                           "store-b", "chunks-b", ctx_dir)
    assert [str(l.digest) for l in m_b.layers] == \
        [str(l.digest) for l in m_a.layers]
    gets = [u for m, u in fixture.requests[before:]
            if m == "GET" and "/blobs/sha256:" in u]
    assert len(gets) > 10  # one per chunk


class _ShiftingRegistry(RegistryFixture):
    """Answers every Range GET with 206 and a body of the right length,
    taken ``shift`` bytes later, with a Content-Range saying so (or,
    ``header=None``, with no Content-Range at all)."""

    def __init__(self, shift, header="shifted"):
        super().__init__()
        self.shift = shift
        self.header = header

    def round_trip(self, method, url, headers, body=None, timeout=60.0,
                   stream_to=None):
        rng = (headers or {}).get("Range", "")
        if method == "GET" and rng.startswith("bytes="):
            resp = super().round_trip(method, url, {}, body, timeout)
            first, last = (int(v) for v in rng[len("bytes="):].split("-"))
            first += self.shift
            last += self.shift
            data = resp.body[first:last + 1]
            out = {}
            if self.header is not None:
                out["content-range"] = \
                    f"bytes {first}-{last}/{len(resp.body)}"
            return Response(206, out, data)
        return super().round_trip(method, url, headers, body, timeout,
                                  stream_to)


@pytest.mark.parametrize("shift,header,kind", [
    (7, "shifted", None),   # right length, wrong offsets: refused
    (0, "shifted", "partial"),  # names exactly the requested range
    (0, None, "partial"),   # no header: the length check holds alone
])
def test_206_content_range_must_name_the_requested_range(
        store, tmp_path, shift, header, kind):
    blob = np.random.default_rng(5).integers(
        0, 256, 4096, dtype=np.uint8).tobytes()
    reg = _ShiftingRegistry(shift, header)
    digest = Digest.from_hex(hashlib.sha256(blob).hexdigest())
    reg.blobs[digest.hex()] = blob
    c = client(store, reg)
    got = c.pull_blob_range(digest, 1000, 1500)
    path = str(tmp_path / "range.bin")
    got_file = c.pull_blob_range_to_file(digest, 1000, 1500, path)
    if kind is None:
        assert got is None and got_file is None
    else:
        assert got == ("partial", blob[1000:1500])
        assert got_file[:2] == ("partial", 500)
        with open(path, "rb") as f:
            assert f.read() == blob[1000:1500]
