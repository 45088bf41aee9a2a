"""The port's distribution plane (``makisu_tpu_torch/serve/``) on the
CPU, held against the JAX package's.

Every case of ``tests/test_serve.py`` but its two fleet cases (those run
in ``tests/test_torch_peers.py`` on two workers) runs against the port:
recipe integrity, coalesced-range planning, delta-pull byte identity and
economics, corrupt-range and lying-recipe rejection, the seekable-zstd
wire and the worker's per-server scoping. The port's builds use
``GPUHasher(device="cpu")`` (the kernels' plain versions), the
reference's ``TPUHasher`` on ``JAX_PLATFORMS=cpu``. Then the two packages
meet byte for byte: recipes sealed on the same chunk triples (canonical
body, digest and HMAC), pack tables, zpack twins and their frame rows,
the zstd encoders both ways, and the recipes, tables and twins of one
context built by each; and on the wire both ways, the port's client
against the reference's serve endpoint and the reverse.
"""

import contextvars
import hashlib
import io
import json
import os

import numpy as np
import pytest

from makisu_tpu.builder import BuildPlan as RefBuildPlan
from makisu_tpu.cache import CacheManager as RefCacheManager
from makisu_tpu.cache import MemoryStore as RefMemoryStore
from makisu_tpu.cache import chunks as ref_chunks
from makisu_tpu.chunker import TPUHasher
from makisu_tpu.context import BuildContext as RefBuildContext
from makisu_tpu.docker import image as ref_image
from makisu_tpu.dockerfile import parse_file as ref_parse_file
from makisu_tpu.registry import RegistryClient as RefRegistryClient
from makisu_tpu.serve import ServeServer as RefServeServer
from makisu_tpu.serve import client as ref_client
from makisu_tpu.serve import recipe as ref_recipe
from makisu_tpu.serve import server as ref_server
from makisu_tpu.snapshot import memfs as ref_memfs
from makisu_tpu.storage import ImageStore as RefImageStore
from makisu_tpu.utils import zstdio as ref_zstdio
from makisu_tpu_torch.builder import BuildPlan
from makisu_tpu_torch.cache import CacheManager, MemoryStore
from makisu_tpu_torch.cache.chunks import (
    ChunkStore,
    attach_chunk_dedup,
    plan_frame_runs,
)
from makisu_tpu_torch.chunker.hasher import GPUHasher
from makisu_tpu_torch.context import BuildContext
from makisu_tpu_torch.docker.image import (
    MEDIA_TYPE_LAYER,
    Descriptor,
    Digest,
    DigestPair,
    ImageName,
)
from makisu_tpu_torch.dockerfile import parse_file
from makisu_tpu_torch.registry import RegistryClient, RegistryFixture
from makisu_tpu_torch.serve import ServeServer, pull_image_delta
from makisu_tpu_torch.serve import recipe as recipe_mod
from makisu_tpu_torch.serve import server as serve_server_mod
from makisu_tpu_torch.serve.client import (
    ServeClient,
    fetch_missing,
    plan_runs,
)
from makisu_tpu_torch.snapshot import memfs
from makisu_tpu_torch.storage import ImageStore
from makisu_tpu_torch.utils import metrics, mountinfo, zstdio


@pytest.fixture(autouse=True)
def _serve_enabled(monkeypatch):
    """Publishing on for every test here, both packages' serve-store
    registries reset so one test's stores never answer for another's,
    no host mount table, and no one-second wait before each commit."""
    monkeypatch.setenv("MAKISU_TPU_SERVE", "1")
    monkeypatch.setattr(memfs.MemFS, "_sync", lambda self: None)
    monkeypatch.setattr(ref_memfs.MemFS, "_sync", lambda self: None)
    mountinfo.set_mountpoints_for_testing(set())
    serve_server_mod.reset_stores()
    ref_server.reset_stores()
    yield
    serve_server_mod.reset_stores()
    ref_server.reset_stores()
    mountinfo.set_mountpoints_for_testing(None)


# -- recipe integrity ---------------------------------------------------------


def _recipe_doc():
    return {"schema": recipe_mod.RECIPE_SCHEMA,
            "layer": {"tar": "12" * 32, "gzip": "ab" * 32,
                      "size": 5, "gz": ""},
            "chunks": [["cd" * 32, 5, "ef" * 32, 0]]}


def test_recipe_seal_verify_roundtrip():
    doc = recipe_mod.seal(_recipe_doc(), key=b"")
    assert recipe_mod.verify(doc, key=b"")
    # Any body tamper breaks the self-digest.
    tampered = dict(doc)
    tampered["chunks"] = [["cd" * 32, 6, "ef" * 32, 0]]
    assert not recipe_mod.verify(tampered, key=b"")


def test_recipe_malformed_documents_refused():
    """A sealed but structurally broken document is a miss, not a
    KeyError inside a pull or a peer fetch."""
    for mangle in (
            lambda d: d.pop("layer"),
            lambda d: d.pop("chunks"),
            lambda d: d["layer"].pop("gzip"),
            lambda d: d["layer"].__setitem__("size", "big"),
            lambda d: d["chunks"].append(["cd" * 32, 5, "ef" * 32]),
            lambda d: d["chunks"].append(["nothex", 5, "ef" * 32, 0]),
            lambda d: d["chunks"].append(["cd" * 32, 0, "ef" * 32, 0]),
            lambda d: d.__setitem__("packs", "notadict"),
            lambda d: d.__setitem__("packs", {"ef" * 32: 0}),
            lambda d: d.__setitem__("packs", {"nothex": 7}),
    ):
        doc = _recipe_doc()
        mangle(doc)
        recipe_mod.seal(doc, key=b"")  # a valid digest over the lie
        assert not recipe_mod.verify(doc, key=b""), doc
        assert not ref_recipe.verify(doc, key=b""), doc


def test_recipe_signature_required_when_keyed():
    signed = recipe_mod.seal(_recipe_doc(), key=b"k1")
    assert recipe_mod.verify(signed, key=b"k1")
    # A wrong key and an unsigned recipe both refuse under a keyed
    # verifier.
    assert not recipe_mod.verify(signed, key=b"k2")
    unsigned = recipe_mod.seal(_recipe_doc(), key=b"")
    assert not recipe_mod.verify(unsigned, key=b"k1")
    # A keyless client accepts both (nothing to verify against).
    assert recipe_mod.verify(signed, key=b"")


@pytest.mark.parametrize("key", [b"", b"shared-serve-key"],
                         ids=["unsigned", "signed"])
def test_seal_and_verify_agree_with_the_reference(key):
    """The canonical body, self-digest and HMAC of a recipe are the
    reference's byte for byte, and each package verifies the other's."""
    doc = _recipe_doc()
    doc["packs"] = {"ef" * 32: 5}
    doc["zpacks"] = {"ef" * 32: [[0, 5, 0, 14]]}
    port = recipe_mod.seal(json.loads(json.dumps(doc)), key=key)
    ref = ref_recipe.seal(json.loads(json.dumps(doc)), key=key)
    assert recipe_mod.canonical_body(port) == ref_recipe.canonical_body(ref)
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert bool(port["sig"]) == bool(key)
    assert ref_recipe.verify(port, key=key)
    assert recipe_mod.verify(ref, key=key)


def _chunk_store_pair(tmp_path, payloads):
    """The same chunks in a port and a reference chunk CAS."""
    port = ChunkStore(str(tmp_path / "port" / "chunks"))
    ref = ref_chunks.ChunkStore(str(tmp_path / "ref" / "chunks"))
    triples, off = [], 0
    for data in payloads:
        fp = hashlib.sha256(data).hexdigest()
        port.put(fp, data)
        ref.put(fp, data)
        triples.append((off, len(data), fp))
        off += len(data)
    return port, ref, triples


def _pair_for(seed, size=10):
    return DigestPair(
        tar_digest=Digest.from_hex(f"{seed:02x}" * 32),
        gzip_descriptor=Descriptor(MEDIA_TYPE_LAYER, size,
                                   Digest.from_hex(f"{seed + 1:02x}" * 32)))


def _ref_pair_for(seed, size=10):
    return ref_image.DigestPair(
        tar_digest=ref_image.Digest.from_hex(f"{seed:02x}" * 32),
        gzip_descriptor=ref_image.Descriptor(
            ref_image.MEDIA_TYPE_LAYER, size,
            ref_image.Digest.from_hex(f"{seed + 1:02x}" * 32)))


def _tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


@pytest.mark.parametrize("key", ["", "k-serve"], ids=["unsigned", "signed"])
def test_publish_writes_the_reference_bytes(tmp_path, monkeypatch, key):
    """Two layers published on the same chunk triples by both packages'
    recipe stores: the same recipe documents (rows, pack sizes, frame
    indexes, digest and HMAC) and byte-equal pack tables, zpack twins and
    recipe files on disk."""
    monkeypatch.setenv("MAKISU_TPU_SERVE_KEY", key)
    monkeypatch.setenv("MAKISU_TPU_PACK_TARGET_MB", "1")
    monkeypatch.setenv("MAKISU_TPU_PACK_FRAME_KB", "48")
    rng = np.random.default_rng(11)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                if i % 2 else (b"text line %d\n" % i) * (n // 12)
                for i, n in enumerate([30_000, 200_000, 70_000, 500_000,
                                       250_000, 9_000])]
    port_cas, ref_cas, triples = _chunk_store_pair(tmp_path, payloads)
    port_rs = recipe_mod.RecipeStore(str(tmp_path / "port" / "serve"),
                                     str(tmp_path / "port" / "chunks"))
    ref_rs = ref_recipe.RecipeStore(str(tmp_path / "ref" / "serve"),
                                    str(tmp_path / "ref" / "chunks"))
    for seed, rows in ((0x10, triples), (0x20, triples[2:4])):
        if seed == 0x20:  # a second layer reusing two chunks
            rows = [(0, rows[0][1], rows[0][2]),
                    (rows[0][1], rows[1][1], rows[1][2])]
        port_doc = port_rs.publish(_pair_for(seed), rows, "zlib-6", port_cas)
        ref_doc = ref_rs.publish(_ref_pair_for(seed), rows, "zlib-6",
                                 ref_cas)
        assert port_doc is not None and port_doc == ref_doc
        assert recipe_mod.verify(port_doc)
        assert ref_recipe.verify(port_doc)
    assert len(port_doc["packs"]) >= 1
    assert port_doc["zpacks"]
    port_files = _tree_bytes(tmp_path / "port" / "serve")
    assert port_files == _tree_bytes(tmp_path / "ref" / "serve")
    assert {p.split("/")[0] for p in port_files} == \
        {"recipes", "packs", "zpacks"}


def test_published_recipe_carries_true_pack_sizes(tmp_path):
    """A later layer referencing a sliver of a shared pack still sees the
    pack's true size in its recipe's ``packs`` map: the client's
    runs-vs-whole decision uses the registry path's denominator."""
    store = ChunkStore(str(tmp_path / "chunks"))
    rs = recipe_mod.RecipeStore(str(tmp_path / "serve"),
                                str(tmp_path / "chunks"))
    c1, c2 = b"a" * 1000, b"b" * 3000
    fps = [hashlib.sha256(c).hexdigest() for c in (c1, c2)]
    for fp, data in zip(fps, (c1, c2)):
        store.put(fp, data)
    doc1 = rs.publish(_pair_for(0x10),
                      [(0, 1000, fps[0]), (1000, 3000, fps[1])],
                      None, store)
    assert doc1 is not None and recipe_mod.verify(doc1, key=b"")
    (pack_hex,) = {row[2] for row in doc1["chunks"]}
    assert doc1["packs"] == {pack_hex: 4000}
    # Layer 2 reuses only c1: its rows reference 1000 bytes of the pack,
    # but the size map carries the full 4000.
    doc2 = rs.publish(_pair_for(0x20), [(0, 1000, fps[0])], None, store)
    assert doc2 is not None and recipe_mod.verify(doc2, key=b"")
    assert doc2["chunks"][0][2] == pack_hex
    assert doc2["packs"] == {pack_hex: 4000}


def test_standalone_serve_server_is_read_only(tmp_path, monkeypatch):
    """ServeServer leaves the process-wide publishing switch alone: it
    never indexes layers, and the flip would put recipe-publish cost on
    builds an embedder runs later in the process."""
    monkeypatch.delenv("MAKISU_TPU_SERVE", raising=False)
    monkeypatch.setattr(serve_server_mod, "_publishing", False)
    server = ServeServer(str(tmp_path / "s.sock"), str(tmp_path))
    try:
        assert not serve_server_mod.publish_enabled()
    finally:
        server.server_close()


def test_stream_triples_offsets_are_running_sum():
    rows = [["aa" * 32, 10, "p" * 64, 0], ["bb" * 32, 7, "p" * 64, 10]]
    assert recipe_mod.stream_triples(rows) == [
        (0, 10, "aa" * 32), (10, 7, "bb" * 32)]


# -- range planning -----------------------------------------------------------


def _rows(pack, spans):
    """[(fp, off, length)] -> recipe rows in one pack."""
    return [[fp, length, pack, off] for fp, off, length in spans]


def test_plan_runs_coalesces_adjacent_spans():
    pack = "ab" * 32
    rows = _rows(pack, [("f1", 0, 100), ("f2", 100, 50),
                        ("f3", 5_000_000, 80)])
    run_jobs, whole_jobs = plan_runs(rows, {"f1", "f2", "f3"},
                                     pack_sizes={pack: 50_000_000})
    assert not whole_jobs
    assert len(run_jobs) == 1
    _, runs = run_jobs[0]
    # f1+f2 adjacent: one run; f3 megabytes away: its own. Three missing
    # chunks cost two requests.
    assert len(runs) == 2
    assert [(s[0], s[1]) for s in runs[0]] == [(0, 100), (100, 50)]
    assert runs[1][0][0] == 5_000_000


def test_plan_runs_gap_tolerance_merges_nearby_spans():
    pack = "cd" * 32
    rows = _rows(pack, [("f1", 0, 100), ("f2", 200, 100)])
    # A 100-byte gap (a held chunk between) still coalesces: one request
    # over-fetches 100 bytes instead of paying a second round trip.
    run_jobs, _ = plan_runs(rows, {"f1", "f2"},
                            pack_sizes={pack: 10_000_000})
    (_, runs), = run_jobs
    assert len(runs) == 1
    start = runs[0][0][0]
    end = runs[0][-1][0] + runs[0][-1][1]
    assert (start, end) == (0, 300)


def test_plan_runs_mostly_needed_pack_fetches_whole():
    pack = "ef" * 32
    rows = _rows(pack, [("f1", 0, 600), ("f2", 600, 300)])
    run_jobs, whole_jobs = plan_runs(rows, {"f1", "f2"},
                                     pack_sizes={pack: 1000})
    assert whole_jobs == [pack]
    assert not run_jobs


def test_fetch_missing_survives_dual_coordinate_recipe():
    """A sealed, well-formed recipe can still lie: one fingerprint mapped
    to two pack coordinates. The first wins for the planner and the carve
    table: one fetch, no KeyError out of the engine."""
    data = b"Z" * 1000
    fp = hashlib.sha256(data).hexdigest()
    rows = [[fp, 1000, "a" * 64, 0], [fp, 1000, "b" * 64, 0]]
    fetched_packs = []

    def fetch_range(pack_hex, start, end, limit=None):
        fetched_packs.append(pack_hex)
        return "partial", data[start:end]

    stored = {}
    got, _ = fetch_missing(fetch_range, rows, {fp},
                           lambda f, b: stored.__setitem__(f, b))
    assert got == {fp}
    assert stored[fp] == data
    assert fetched_packs == ["a" * 64]


def test_parse_range_semantics():
    parse = serve_server_mod.parse_range
    assert parse("bytes=0-99", 1000) == (0, 100)
    assert parse("bytes=900-", 1000) == (900, 1000)
    assert parse("bytes=900-5000", 1000) == (900, 1000)  # clamped
    assert parse("bytes=1000-1099", 1000) == "unsatisfiable"
    # No, unparseable, multi or inverted ranges degrade to a full answer
    # (an inverted range must not give a negative Content-Length).
    assert parse(None, 1000) is None
    assert parse("bytes=a-b", 1000) is None
    assert parse("bytes=0-1,5-9", 1000) is None
    assert parse("bytes=5-3", 1000) is None


# -- end-to-end delta pulls ---------------------------------------------------


def _payload(seed, size=1_500_000):
    return np.random.default_rng(seed).integers(
        0, 256, size=size, dtype=np.uint8).tobytes()


def _text_payload(seed, size=1_500_000):
    """Compressible but chunkable content (log-like lines with random
    ids), where the seekable-zstd wire wins; on random bytes zstd loses
    and the client rightly keeps the raw wire."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 2 ** 48, size=size // 40 + 1)
    text = b"".join(b"req %012x served from cache tier A\n" % int(i)
                    for i in ids)
    return text[:size]


PORT = {"ImageStore": ImageStore, "RegistryClient": RegistryClient,
        "BuildContext": BuildContext, "CacheManager": CacheManager,
        "MemoryStore": MemoryStore, "attach": attach_chunk_dedup,
        "parse_file": parse_file, "BuildPlan": BuildPlan,
        "ImageName": ImageName, "ServeServer": ServeServer,
        "hasher": lambda: GPUHasher(device="cpu"), "ctx_kwargs": {}}
REFERENCE = {"ImageStore": RefImageStore,
             "RegistryClient": RefRegistryClient,
             "BuildContext": RefBuildContext,
             "CacheManager": RefCacheManager, "MemoryStore": RefMemoryStore,
             "attach": ref_chunks.attach_chunk_dedup,
             "parse_file": ref_parse_file, "BuildPlan": RefBuildPlan,
             "ImageName": ref_image.ImageName, "ServeServer": RefServeServer,
             "hasher": TPUHasher, "ctx_kwargs": {"sync_wait": 0.0}}


class _Plane:
    """One builder storage, a registry fixture and a serve socket: the
    publishing side of the distribution plane, build by build, built by
    the port (default) or the reference."""

    def __init__(self, tmp_path, pkg=None):
        self.pkg = pkg or PORT
        self.tmp = tmp_path
        self.kv = self.pkg["MemoryStore"]()
        self.fixture = RegistryFixture()
        self.storage = str(tmp_path / "builder-storage")
        self.server = None

    def build_and_push(self, tag, payload, ctx_dir=None):
        # In a copy of the context, as a build process of its own: the
        # chunk observer that attach binds must not outlive the build.
        return contextvars.copy_context().run(self._build_and_push, tag,
                                              payload, ctx_dir)

    def _build_and_push(self, tag, payload, ctx_dir):
        pkg = self.pkg
        if ctx_dir is None:
            ctx_dir = self.tmp / f"ctx-{tag}"
            ctx_dir.mkdir(exist_ok=True)
            (ctx_dir / "blob.bin").write_bytes(payload)
        root = self.tmp / f"root-{tag}"
        root.mkdir(exist_ok=True)
        store = pkg["ImageStore"](self.storage)
        client = pkg["RegistryClient"](store, "registry.test", "t/app",
                                       transport=self.fixture)
        ctx = pkg["BuildContext"](str(root), str(ctx_dir), store,
                                  hasher=pkg["hasher"](), **pkg["ctx_kwargs"])
        mgr = pkg["CacheManager"](self.kv, store, registry_client=client)
        pkg["attach"](mgr, os.path.join(self.storage, "chunks"))
        stages = pkg["parse_file"]("FROM scratch\nCOPY blob.bin /blob.bin\n")
        name = pkg["ImageName"]("registry.test", "t/app", tag)
        plan = pkg["BuildPlan"](ctx, name, [], mgr, stages,
                                allow_modify_fs=False, force_commit=True)
        manifest = plan.execute()
        mgr.wait_for_push()
        push_client = pkg["RegistryClient"](store, "registry.test", "t/app",
                                            transport=self.fixture)
        push_client.materialize_blob = mgr.materialize
        mgr.materialize_pending()
        push_client.push(name)
        return manifest

    def serve(self):
        sock = str(self.tmp / "serve.sock")
        self.server = self.pkg["ServeServer"](sock, self.storage)
        self.server.serve_background()
        return sock

    def close(self):
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()

    def puller(self, name="client", pkg=None):
        pkg = pkg or PORT
        store = pkg["ImageStore"](str(self.tmp / f"{name}-storage"))
        reg = pkg["RegistryClient"](store, "registry.test", "t/app",
                                    transport=self.fixture)
        return store, reg


@pytest.fixture
def plane(tmp_path):
    p = _Plane(tmp_path)
    yield p
    p.close()


def _same_layers(store_a, store_b, layers):
    for desc in layers:
        hx = desc.digest.hex()
        with store_a.layers.open(hx) as fa, store_b.layers.open(hx) as fb:
            assert fa.read() == fb.read(), f"layer {hx} differs"


def test_delta_pull_one_edit_byte_identity(plane):
    """Pull v1 (seeds the client's chunk CAS), a 1-edit rebuild, pull v2:
    the v2 pull fetches under 10% of the full image's bytes and every
    reconstituted layer equals a cold full pull byte for byte."""
    v1 = _payload(7)
    v2 = v1[:9_000] + b"EDIT-ONE-FILE" + v1[9_000:]
    plane.build_and_push("v1", v1)
    sock = plane.serve()

    cstore, creg = plane.puller()
    n1 = ImageName("registry.test", "t/app", "v1")
    _, rep1 = pull_image_delta(creg, cstore, n1, sock)
    # A cold delta pull: everything arrives, over the pack wire.
    assert rep1["delta_layers"] >= 1, rep1
    assert rep1["fallback_layers"] == 0, rep1

    plane.build_and_push("v2", v2)
    n2 = ImageName("registry.test", "t/app", "v2")
    _, rep2 = pull_image_delta(creg, cstore, n2, sock)
    assert rep2["delta_layers"] >= 1, rep2
    assert rep2["fetched_fraction"] < 0.10, rep2
    # The novel region is contiguous: a handful of range requests, not
    # one per chunk.
    delta_rows = [r for r in rep2["layers"] if r["route"] == "delta"]
    assert sum(r["requests"] for r in delta_rows) < \
        sum(r["chunks_missing"] for r in delta_rows) + 2

    ostore, oreg = plane.puller("oracle")
    _same_layers(ostore, cstore, oreg.pull(n2).layers)


def test_delta_pull_unpublished_layer_falls_back_to_blob(plane,
                                                         monkeypatch):
    """No recipe (publishing off during the build): pull --delta takes
    the registry blob route, still correct."""
    monkeypatch.setenv("MAKISU_TPU_SERVE", "0")
    plane.build_and_push("v1", _payload(11, 400_000))
    monkeypatch.setenv("MAKISU_TPU_SERVE", "1")
    sock = plane.serve()
    cstore, creg = plane.puller()
    n1 = ImageName("registry.test", "t/app", "v1")
    _, rep = pull_image_delta(creg, cstore, n1, sock)
    assert rep["delta_layers"] == 0, rep
    assert rep["fallback_layers"] >= 1, rep
    for desc in creg.pull_manifest("v1").layers:
        assert cstore.layers.exists(desc.digest.hex())


def _flip_bytes(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0xFF]))


def test_corrupt_pack_range_rejected(plane):
    """A serving CAS corrupted on disk: carved chunks fail their sha256
    and are never stored, the delta route fails, and the pull takes the
    registry blob route: corrupt serve bytes waste bandwidth, never
    install."""
    plane.build_and_push("v1", _payload(13, 600_000))
    sock = plane.serve()
    # A byte flipped in every served chunk of 4 KiB or more, and in every
    # seekable frame file (written at publish from the then-healthy CAS,
    # it would still serve the original bytes).
    flipped = 0
    for dirpath, _, names in os.walk(os.path.join(plane.storage, "chunks")):
        for fname in names:
            path = os.path.join(dirpath, fname)
            if not recipe_mod.is_hex_digest(fname) or \
                    os.path.getsize(path) < 4096:
                continue
            _flip_bytes(path, 100)
            flipped += 1
    assert flipped, "expected chunk files to corrupt"
    zpack_dir = os.path.join(plane.storage, "serve", "zpacks")
    for fname in os.listdir(zpack_dir):
        _flip_bytes(os.path.join(zpack_dir, fname), 50)

    cstore, creg = plane.puller()
    n1 = ImageName("registry.test", "t/app", "v1")
    _, rep = pull_image_delta(creg, cstore, n1, sock)
    assert rep["delta_layers"] == 0, rep
    assert rep["fallback_layers"] >= 1, rep
    for desc in creg.pull_manifest("v1").layers:
        hx = desc.digest.hex()
        with cstore.layers.open(hx) as f:
            assert hashlib.sha256(f.read()).hexdigest() == hx


def test_lying_recipe_never_installs(plane):
    """A recipe re-sealed after a row was dropped passes verification,
    but its size or reconstituted digests refuse it: the blob route."""
    manifest = plane.build_and_push("v1", _payload(17, 400_000))
    hex_digest = manifest.layers[0].digest.hex()
    store = serve_server_mod.store_for(plane.storage)
    doc = store.recipe(hex_digest)
    assert doc is not None
    doc["chunks"] = doc["chunks"][:-1]
    recipe_mod.seal(doc)
    path = os.path.join(plane.storage, "serve", "recipes",
                        f"{hex_digest}.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    sock = plane.serve()
    cstore, creg = plane.puller()
    n1 = ImageName("registry.test", "t/app", "v1")
    _, rep = pull_image_delta(creg, cstore, n1, sock)
    assert rep["delta_layers"] == 0, rep
    for desc in creg.pull_manifest("v1").layers:
        assert cstore.layers.exists(desc.digest.hex())


def test_serve_pack_endpoint_range_semantics(plane):
    """206 with Content-Range for a span, 200 without Range, 416 past the
    end, 404 for an unknown pack, 400 for a bad name."""
    manifest = plane.build_and_push("v1", _payload(19, 400_000))
    sock = plane.serve()
    store = serve_server_mod.store_for(plane.storage)
    doc = store.recipe(manifest.layers[0].digest.hex())
    pack_hex = doc["chunks"][0][2]
    size = store.pack_size(pack_hex)
    assert size > 0
    client = ServeClient(sock)
    kind, body = client.pack_range(pack_hex, 0, min(1000, size))
    assert kind == "partial" and len(body) == min(1000, size)
    status, _, body = client._get(f"/packs/{pack_hex}")
    assert status == 200 and len(body) == size
    status, _, _ = client._get(
        f"/packs/{pack_hex}", headers={"Range": f"bytes={size}-"})
    assert status == 416
    status, _, _ = client._get(f"/packs/{'0' * 64}")
    assert status == 404
    status, _, _ = client._get("/packs/not-a-digest")
    assert status == 400


# -- seekable-zstd packs --------------------------------------------------------


def test_zstd_encoders_equal_the_reference_both_ways():
    """The same libzstd at the same level: ``compress`` and a streamed
    ``ZstdWriter`` give the reference's bytes, and each package decodes
    the other's frames and streams."""
    data = _text_payload(3, 300_000)
    frame = zstdio.compress(data)
    assert frame == ref_zstdio.compress(data)
    assert ref_zstdio.decompress(frame, len(data)) == data
    assert zstdio.decompress(ref_zstdio.compress(data, 9), len(data)) == data
    with pytest.raises(ValueError):
        zstdio.decompress(frame[:-7], len(data))
    outs = []
    for mod in (zstdio, ref_zstdio):
        buf = io.BytesIO()
        with mod.ZstdWriter(buf) as w:
            for i in range(0, len(data), 70_001):
                w.write(data[i:i + 70_001])
        assert w.raw_size == len(data)
        assert w.compressed_size == len(buf.getvalue())
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert zstdio.ZstdReader(io.BytesIO(outs[1])).read() == data
    assert ref_zstdio.ZstdReader(io.BytesIO(outs[0])).read() == data


def test_seekable_frame_index_roundtrip(tmp_path):
    """Publish writes the compressed twin and its frame index: frames are
    whole-chunk groups, decode on their own and concatenate to the raw
    pack; a fresh store (another process) reloads the dict-form table
    with its frames."""
    store = ChunkStore(str(tmp_path / "chunks"))
    rs = recipe_mod.RecipeStore(str(tmp_path / "serve"),
                                str(tmp_path / "chunks"))
    chunks = [os.urandom(50_000) for _ in range(10)]
    triples, off = [], 0
    for data in chunks:
        fp = hashlib.sha256(data).hexdigest()
        store.put(fp, data)
        triples.append((off, len(data), fp))
        off += len(data)
    doc = rs.publish(_pair_for(0x12, off), triples, None, store)
    assert doc is not None and recipe_mod.verify(doc, key=b"")
    (pack_hex,) = {row[2] for row in doc["chunks"]}
    frames = doc["zpacks"][pack_hex]
    assert frames and recipe_mod._frame_rows_valid(frames)
    raw = b"".join(chunks)
    assert frames[0][0] == 0
    assert sum(r[1] for r in frames) == len(raw)
    zpath = os.path.join(str(tmp_path / "serve"), "zpacks",
                         f"{pack_hex}.zst")
    zblob = open(zpath, "rb").read()
    assert len(zblob) == frames[-1][2] + frames[-1][3]
    rebuilt = b"".join(zstdio.decompress(zblob[z_off:z_off + z_len], raw_len)
                       for _, raw_len, z_off, z_len in frames)
    assert rebuilt == raw
    rs2 = recipe_mod.RecipeStore(str(tmp_path / "serve"),
                                 str(tmp_path / "chunks"))
    assert rs2.pack_frames(pack_hex) == [[int(v) for v in row]
                                         for row in frames]
    assert rs2.zpack_size(pack_hex) == len(zblob)
    # The reference's store reads the port's table and twin alike.
    ref_rs = ref_recipe.RecipeStore(str(tmp_path / "serve"),
                                    str(tmp_path / "chunks"))
    assert ref_rs.pack_frames(pack_hex) == rs2.pack_frames(pack_hex)
    assert ref_rs.pack_members(pack_hex) == rs2.pack_members(pack_hex)


def test_malformed_frame_index_demotes_to_raw_serving(tmp_path):
    """A pack table whose frame rows are garbage keeps serving its intact
    member table raw: frames never 404 the pack."""
    os.makedirs(tmp_path / "serve" / "packs", exist_ok=True)
    pack_hex = "ab" * 32
    with open(tmp_path / "serve" / "packs" / f"{pack_hex}.json", "w") as f:
        json.dump({"members": [["cd" * 32, 100]],
                   "frames": [["x", 1, 2, 3]]}, f)
    rs = recipe_mod.RecipeStore(str(tmp_path / "serve"),
                                str(tmp_path / "chunks"))
    assert rs.pack_members(pack_hex) == [("cd" * 32, 100)]
    assert rs.pack_frames(pack_hex) is None
    assert rs.zpack_size(pack_hex) == 0


def test_plan_frame_runs_maps_spans_to_frames():
    # 4 frames of 100 raw bytes, 40 compressed each at z offsets 0..120.
    frames = [[0, 100, 0, 40], [100, 100, 40, 40],
              [200, 100, 80, 40], [300, 100, 120, 40]]
    # A span inside frame 0 and one across frames 2 and 3: frame 1 is not
    # needed, so at gap=0 its 40 bytes split the plan into two runs, and
    # the crossing span names both its frames.
    spans = [(20, 10, "f1"), (290, 20, "f2")]
    runs = plan_frame_runs(frames, spans, gap=0)
    assert runs == [[[0, 100, 0, 40]],
                    [[200, 100, 80, 40], [300, 100, 120, 40]]]
    assert runs == ref_chunks.plan_frame_runs(frames, spans, gap=0)
    # A generous gap coalesces them into one request; frame 1's bytes
    # are fetched inside the range but stay out of the run's rows.
    runs = plan_frame_runs(frames, spans, gap=1000)
    assert len(runs) == 1 and len(runs[0]) == 3
    assert [r[0] for r in runs[0]] == [0, 200, 300]
    # Needed frames that are z-adjacent always share a run.
    runs = plan_frame_runs(frames, [(120, 10, "f1"), (290, 20, "f2")],
                           gap=0)
    assert len(runs) == 1 and len(runs[0]) == 3


def test_serve_zpack_endpoint_ranged_mid_pack_frame(plane):
    """/zpacks: a mid-pack frame fetched by compressed Range decodes to
    exactly that frame's raw bytes; 416 past the end; 404 for a frameless
    hex; 400 for a bad name."""
    manifest = plane.build_and_push("v1", _payload(29))
    sock = plane.serve()
    store = serve_server_mod.store_for(plane.storage)
    doc = store.recipe(manifest.layers[0].digest.hex())
    pack_hex = doc["chunks"][0][2]
    frames = store.pack_frames(pack_hex)
    assert frames and len(frames) >= 3, "expected a multi-frame pack"
    raw_off, raw_len, z_off, z_len = frames[len(frames) // 2]
    client = ServeClient(sock)
    kind, body = client.zpack_range(pack_hex, z_off, z_off + z_len)
    assert kind == "partial" and len(body) == z_len
    rawbuf = zstdio.decompress(body, raw_len)
    kind, rawspan = client.pack_range(pack_hex, raw_off, raw_off + raw_len)
    assert kind == "partial" and rawbuf == rawspan
    zsize = store.zpack_size(pack_hex)
    status, _, _ = client._get(
        f"/zpacks/{pack_hex}", headers={"Range": f"bytes={zsize}-"})
    assert status == 416
    status, _, _ = client._get(f"/zpacks/{'0' * 64}")
    assert status == 404
    status, _, _ = client._get("/zpacks/not-a-digest")
    assert status == 400


def _zstd_requests(g):
    return (g.counter_total(metrics.SERVE_PACK_REQUESTS, kind="zrange")
            + g.counter_total(metrics.SERVE_PACK_REQUESTS, kind="zfull"))


def test_delta_pull_rides_compressed_wire(plane):
    """A 1-edit delta pull of compressible content moves fewer wire bytes
    than the raw-pack plan would (bytes_fetched < bytes_raw_wire, with
    zstd requests on the wire), byte-identical to a cold pull."""
    g = metrics.global_registry()
    before_z = _zstd_requests(g)
    v1 = _text_payload(31)
    v2 = v1[:9_000] + b"EDIT" + v1[9_000:]
    plane.build_and_push("v1", v1)
    sock = plane.serve()
    cstore, creg = plane.puller()
    pull_image_delta(creg, cstore,
                     ImageName("registry.test", "t/app", "v1"), sock)
    plane.build_and_push("v2", v2)
    n2 = ImageName("registry.test", "t/app", "v2")
    _, rep = pull_image_delta(creg, cstore, n2, sock)
    assert rep["delta_layers"] >= 1, rep
    assert rep["bytes_fetched"] < rep["bytes_raw_wire"], rep
    assert _zstd_requests(g) - before_z >= 1, \
        "the delta never touched the compressed wire"
    ostore, oreg = plane.puller("oracle")
    _same_layers(ostore, cstore, oreg.pull(n2).layers)


def test_old_client_keeps_raw_pack_wire(plane, monkeypatch):
    """A puller without zstd rides the raw /packs wire end to end: the
    same bytes installed, no /zpacks request."""
    plane.build_and_push("v1", _payload(37, 600_000))
    sock = plane.serve()
    g = metrics.global_registry()
    before_z = g.counter_total(metrics.SERVE_PACK_REQUESTS, kind="zrange")
    monkeypatch.setattr(zstdio, "available", lambda: False)
    cstore, creg = plane.puller()
    n1 = ImageName("registry.test", "t/app", "v1")
    _, rep = pull_image_delta(creg, cstore, n1, sock)
    assert rep["delta_layers"] >= 1, rep
    assert rep["bytes_fetched"] == rep["bytes_raw_wire"], rep
    assert g.counter_total(metrics.SERVE_PACK_REQUESTS,
                           kind="zrange") == before_z
    for desc in creg.pull_manifest("v1").layers:
        assert cstore.layers.exists(desc.digest.hex())


def test_lying_frame_never_installs(plane):
    """Corrupted frame files: decoding fails or carved chunks fail their
    sha256; nothing corrupt installs, and the raw pack wire (or the blob
    route) delivers the right bytes."""
    plane.build_and_push("v1", _text_payload(41, 600_000))
    zpack_dir = os.path.join(plane.storage, "serve", "zpacks")
    for fname in os.listdir(zpack_dir):
        path = os.path.join(zpack_dir, fname)
        blob = bytearray(open(path, "rb").read())
        for i in range(0, len(blob), 97):
            blob[i] ^= 0xA5
        open(path, "wb").write(bytes(blob))
    sock = plane.serve()
    cstore, creg = plane.puller()
    n1 = ImageName("registry.test", "t/app", "v1")
    pull_image_delta(creg, cstore, n1, sock)
    for desc in creg.pull_manifest("v1").layers:
        hx = desc.digest.hex()
        with cstore.layers.open(hx) as f:
            assert hashlib.sha256(f.read()).hexdigest() == hx


# -- the worker's serving surface -------------------------------------------------


def test_worker_serves_recipes_and_packs_for_own_roots_only(plane):
    """A worker answers /recipes and /packs only for storages its own
    builds used (the per-server scoping of /chunks)."""
    from makisu_tpu_torch.worker import WorkerServer
    manifest = plane.build_and_push("v1", _payload(23, 400_000))
    hex_digest = manifest.layers[0].digest.hex()
    servers = []
    for name in ("wa", "wb"):
        server = WorkerServer(str(plane.tmp / f"{name}.sock"), device="cpu")
        servers.append((server, server.serve_background()))
    try:
        server_a, server_b = servers[0][0], servers[1][0]
        server_a.add_served_chunk_root(plane.storage)
        client_a = ServeClient(server_a.socket_path)
        doc = client_a.recipe(hex_digest)
        assert doc is not None
        pack_hex = doc["chunks"][0][2]
        assert client_a.pack_range(pack_hex, 0, 100) is not None
        # Worker B never built against this storage: 404s.
        client_b = ServeClient(server_b.socket_path)
        assert client_b.recipe(hex_digest) is None
        assert client_b.pack_range(pack_hex, 0, 100) is None
        # The serve digest of /healthz counts A's storage only.
        assert server_a.health()["serve"]["recipes"] == 1
        assert server_b.health()["serve"]["recipes"] == 0
    finally:
        for server, thread in servers:
            server.shutdown()
            server.server_close()
            thread.join(timeout=5)


# -- both packages ---------------------------------------------------------------


def test_one_context_publishes_the_reference_bytes(tmp_path):
    """The same context built by the port (gpu hasher on the plain
    versions) and by the reference (tpu hasher on JAX's CPU): the same
    layers, and the recipes, pack tables and zpack twins each publishes
    are equal byte for byte."""
    ctx_dir = tmp_path / "ctx"
    ctx_dir.mkdir()
    (ctx_dir / "blob.bin").write_bytes(
        _text_payload(43, 700_000) + _payload(43, 300_000))
    trees = {}
    for label, pkg in (("port", PORT), ("reference", REFERENCE)):
        p = _Plane(tmp_path / label, pkg)
        (tmp_path / label).mkdir()
        manifest = p.build_and_push("v1", None, ctx_dir=ctx_dir)
        trees[label] = (
            [d.digest.hex() for d in manifest.layers],
            _tree_bytes(os.path.join(p.storage, "serve")))
    assert trees["port"][0] == trees["reference"][0]
    port_files, ref_files = trees["port"][1], trees["reference"][1]
    assert sorted(port_files) == sorted(ref_files)
    assert {p.split("/")[0] for p in port_files} == \
        {"recipes", "packs", "zpacks"}
    assert port_files == ref_files


@pytest.mark.parametrize("direction", ["port-client-ref-server",
                                       "ref-client-port-server"])
def test_delta_pull_wire_both_ways(tmp_path, direction):
    """One package builds and serves v1 and an edited v2, the other
    delta-pulls both through its own client: the v2 pull fetches under
    10% of the image, and the layers equal the registry's digests."""
    port_client = direction.startswith("port-client")
    plane = _Plane(tmp_path, REFERENCE if port_client else PORT)
    v1 = _payload(47, 800_000)
    v2 = v1[:5_000] + b"EDIT" + v1[5_000:]
    try:
        plane.build_and_push("v1", v1)
        sock = plane.serve()
        cpkg = PORT if port_client else REFERENCE
        pull = pull_image_delta if port_client else \
            ref_client.pull_image_delta
        cstore, creg = plane.puller(pkg=cpkg)
        _, rep1 = pull(creg, cstore,
                       cpkg["ImageName"]("registry.test", "t/app", "v1"),
                       sock)
        assert rep1["delta_layers"] >= 1 and rep1["fallback_layers"] == 0
        plane.build_and_push("v2", v2)
        _, rep2 = pull(creg, cstore,
                       cpkg["ImageName"]("registry.test", "t/app", "v2"),
                       sock)
        assert rep2["delta_layers"] >= 1 and rep2["fallback_layers"] == 0
        assert rep2["fetched_fraction"] < 0.10, rep2
        assert rep2["schema"] == "makisu-tpu.serve-pull.v1"
        for desc in creg.pull_manifest("v2").layers:
            hx = desc.digest.hex()
            with cstore.layers.open(hx) as f:
                assert hashlib.sha256(f.read()).hexdigest() == hx
    finally:
        plane.close()
