"""The port's build command against the JAX package's, end to end.

``makisu_tpu.cli.main([... "--hasher", "tpu"])`` and
``makisu_tpu_torch.cli.main([... "--hasher", "gpu"], device="cpu")``
build the same seeded contexts: manifests, diff_ids, configs (apart from
their wall-clock ``created`` stamps) and the cache entries' digests,
chunk lists and gzip ids are equal. A storage dir filled by either
builder gives the other a cache hit at every step. RUN layers, which no
two builds reproduce, are checked on their own: blob and tar digests,
chunk tiling, hashlib digests and the plain Gear cut oracle.
"""

import gzip
import hashlib
import io
import json
import os
import tarfile

import numpy as np
import pytest
import torch

from makisu_tpu import cli as ref_cli
from makisu_tpu.snapshot import memfs as ref_memfs
from makisu_tpu.worker import session as ref_session
from makisu_tpu_torch import cli
from makisu_tpu_torch.ops import gear, gear_cuda
from makisu_tpu_torch.snapshot import memfs
from makisu_tpu_torch.utils import mountinfo
from makisu_tpu_torch.worker import session


@pytest.fixture(autouse=True)
def _no_mounts():
    """Tmp build roots must not inherit the host's mount table."""
    mountinfo.set_mountpoints_for_testing(set())
    yield
    mountinfo.set_mountpoints_for_testing(None)


@pytest.fixture(autouse=True)
def _no_shared_hash(monkeypatch):
    """A worker of either package, in an earlier test of this process,
    sets MAKISU_TPU_SHARED_HASH=1 for the process; these builds launch S1
    themselves."""
    monkeypatch.setenv("MAKISU_TPU_SHARED_HASH", "0")


@pytest.fixture(autouse=True)
def fresh_sessions():
    """No resident session outlives a test, in either package."""
    session.manager().reset()
    ref_session.manager().reset()
    yield
    session.manager().reset()
    ref_session.manager().reset()


def one_shot_main(argv, device="cpu"):
    """``cli.main`` as a process of its own, as each ``makisu build``
    is: a fresh session manager, so no build reuses another's session
    (the cases here count what a one-shot build reads and applies). Its
    sessions close with it, releasing their inotify instances."""
    mgr = session.SessionManager()
    token = session.bind_manager(mgr)
    try:
        return cli.main(argv, device=device)
    finally:
        session.reset_manager(token)
        mgr.reset()


@pytest.fixture
def no_sync_wait(monkeypatch):
    """Skip MemFS's one-second wait before each commit. It only orders
    mtimes after RUN steps, so COPY-only builds are unaffected."""
    monkeypatch.setattr(memfs.MemFS, "_sync", lambda self: None)
    monkeypatch.setattr(ref_memfs.MemFS, "_sync", lambda self: None)


def make_context(path, seed=0, nfiles=60, text_kb=12, blob_kb=(256, 640)):
    """A seeded context: text-like files (some repeated), nested dirs,
    binaries, an empty dir and a symlink."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, size=int(k), dtype=np.uint8))
             for k in rng.integers(2, 9, size=500)]
    bodies = []
    for k in range(nfiles):
        if bodies and k % 6 == 5:
            body = bodies[int(rng.integers(0, len(bodies)))]
        else:
            pick = rng.integers(0, len(words),
                                size=int(rng.integers(50, text_kb * 200)))
            body = b" ".join(words[i] for i in pick.tolist())
            bodies.append(body)
        f = path / "app" / f"pkg{k // 8}" / f"f{k:03d}.js"
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_bytes(body)
    for b, kb in enumerate(blob_kb):
        (path / f"blob{b}.bin").write_bytes(
            rng.integers(0, 256, size=kb * 1024, dtype=np.uint8).tobytes())
    (path / "app" / "empty").mkdir()
    os.symlink("pkg0/f000.js", path / "app" / "link.js")
    (path / "hello.txt").write_text("hello\n")


DOCKERFILE_COPY = """\
FROM scratch
ARG VERSION=1.0
COPY app /srv/app/
ADD blob0.bin blob1.bin /data/
COPY hello.txt /etc/hello-${VERSION}.txt
ENV APP_ENV=prod PATH=/srv/app:/bin
LABEL team=build version=${VERSION}
EXPOSE 8080 9090/udp
USER 1000:1000
VOLUME /var/cache
STOPSIGNAL 15
HEALTHCHECK --interval=30s --timeout=5s CMD ["/bin/check"]
MAINTAINER someone@example.com
WORKDIR /srv/app
CMD ["serve"]
ENTRYPOINT ["/srv/app/run"]
"""

DOCKERFILE_MULTISTAGE = """\
FROM scratch AS build
COPY app /work/app/
COPY blob0.bin /work/out.bin #!COMMIT

FROM scratch
COPY --from=build /work/out.bin /app/out.bin
COPY --from=build /work/app/pkg1 /app/pkg1/
COPY hello.txt /app/
ENV APP_READY=1
CMD ["/bin/cat", "/app/hello.txt"]
"""


def port_build(ctx, storage, root, *extra, hasher="gpu", log=None):
    argv = ["--log-fmt", "json"]
    if log is not None:
        argv += ["--log-output", str(log)]
    argv += ["build", str(ctx), "-t", "test/app:1", "--storage",
             str(storage), "--root", str(root), "--hasher", hasher, *extra]
    return one_shot_main(argv)


def ref_build(ctx, storage, root, *extra, hasher="tpu", log=None):
    argv = ["--log-fmt", "json", "--log-level", "info"]
    if log is not None:
        argv += ["--log-output", str(log)]
    argv += ["build", str(ctx), "-t", "test/app:1", "--storage",
             str(storage), "--root", str(root), "--hasher", hasher, *extra]
    return ref_cli.main(argv)


def load_image(storage):
    with open(storage / "manifests" / "test" / "app" / "1.json") as f:
        manifest = json.load(f)
    cfg_hex = manifest["config"]["digest"].split(":")[1]
    with open(storage / "layers" / cfg_hex[:2] / cfg_hex, "rb") as f:
        config = json.loads(f.read())
    return manifest, config


def timeless(config):
    """The config without its wall-clock stamps."""
    config = json.loads(json.dumps(config))
    config.pop("created")
    for h in config.get("history", []):
        h.pop("created")
    return config


def kv_entries(storage):
    """cache id -> entry, with makisu_tpu's chunk-pack mapping dropped
    (packs are the registry's wire form, which the port has not got)."""
    with open(storage / "cache_key_value.json") as f:
        raw = json.load(f)
    out = {}
    for key, (value, _ts) in raw.items():
        if value.startswith("{"):
            value = json.loads(value)
            value.pop("packs", None)
        out[key] = value
    return out


def assert_same_image(a, b):
    ma, ca = load_image(a)
    mb, cb = load_image(b)
    assert ma["layers"] == mb["layers"]
    assert ca["rootfs"]["diff_ids"] == cb["rootfs"]["diff_ids"]
    assert timeless(ca) == timeless(cb)
    assert kv_entries(a) == kv_entries(b)
    return ma, ca


def plain_cut_ends(tar: bytes) -> list[int]:
    data = np.frombuffer(tar, dtype=np.uint8)
    data = np.concatenate([data, np.zeros((-len(data)) % 32, np.uint8)])
    words = gear.gear_bitmap(torch.from_numpy(data)).numpy()
    return gear.select_boundaries_np(
        gear.candidates_np(words, 0, len(tar)), len(tar)).tolist()


def check_layers(storage):
    """Every layer of the image: digests, KV chunk list tiling the tar,
    hashlib chunk digests and the plain cut oracle. Returns the number of
    chunks checked."""
    manifest, config = load_image(storage)
    entries = {e["gzip"]: e for e in kv_entries(storage).values()
               if isinstance(e, dict)}
    nchunks = 0
    for desc, diff_id in zip(manifest["layers"],
                             config["rootfs"]["diff_ids"]):
        hex_digest = desc["digest"].split(":")[1]
        blob = (storage / "layers" / hex_digest[:2] / hex_digest) \
            .read_bytes()
        assert hashlib.sha256(blob).hexdigest() == hex_digest
        assert len(blob) == desc["size"]
        tar = gzip.decompress(blob)
        assert "sha256:" + hashlib.sha256(tar).hexdigest() == diff_id
        chunks = entries[desc["digest"]]["chunks"]
        pos = 0
        for off, n, hex_chunk in chunks:
            assert off == pos and n > 0
            assert hashlib.sha256(tar[off:off + n]).hexdigest() == hex_chunk
            pos += n
        assert pos == len(tar)
        assert [off + n for off, n, _ in chunks] == plain_cut_ends(tar)
        nchunks += len(chunks)
    return nchunks


def count_lines(log_path, text):
    with open(log_path) as f:
        return sum(text in json.loads(line)["msg"] for line in f)


# -- parity with the JAX package ---------------------------------------------

@pytest.mark.parametrize("commit", ["implicit", "explicit"])
def test_copy_add_metadata_build_matches_reference(tmp_path, no_sync_wait,
                                                   commit):
    ctx = tmp_path / "ctx"
    make_context(ctx, seed=1)
    (ctx / "Dockerfile").write_text(DOCKERFILE_COPY)
    for d in ("r1", "r2"):
        (tmp_path / d).mkdir()
    args = ("--commit", commit, "--build-arg", "VERSION=2.5")
    assert ref_build(ctx, tmp_path / "ref", tmp_path / "r1", *args) == 0
    assert port_build(ctx, tmp_path / "port", tmp_path / "r2", *args,
                      "--dest", str(tmp_path / "image.tar")) == 0
    manifest, config = assert_same_image(tmp_path / "ref",
                                         tmp_path / "port")
    assert config["config"]["Labels"] == {"team": "build",
                                          "version": "2.5"}
    assert config["config"]["Healthcheck"]["Interval"] == 30 * 10**9
    assert len(manifest["layers"]) == (3 if commit == "implicit" else 1)
    assert check_layers(tmp_path / "port") > 100
    # The docker-save tar holds the same layers.
    with tarfile.open(tmp_path / "image.tar") as tf:
        [export] = json.load(tf.extractfile("manifest.json"))
        assert export["RepoTags"] == ["test/app:1"]
        diff_ids = ["sha256:" + hashlib.sha256(
            tf.extractfile(name).read()).hexdigest()
            for name in export["Layers"]]
    assert diff_ids == config["rootfs"]["diff_ids"]


def test_multistage_copy_from_matches_reference(tmp_path, no_sync_wait):
    ctx = tmp_path / "ctx"
    make_context(ctx, seed=2, nfiles=24)
    (ctx / "Dockerfile").write_text(DOCKERFILE_MULTISTAGE)
    for d in ("r1", "r2"):
        (tmp_path / d).mkdir()
    args = ("--modifyfs", "--commit", "explicit")
    assert ref_build(ctx, tmp_path / "ref", tmp_path / "r1", *args) == 0
    assert port_build(ctx, tmp_path / "port", tmp_path / "r2", *args) == 0
    manifest, _ = assert_same_image(tmp_path / "ref", tmp_path / "port")
    assert len(manifest["layers"]) == 1
    assert check_layers(tmp_path / "port") > 10
    # The stages' files were cleaned out of the build root.
    assert os.listdir(tmp_path / "r2") == []


def test_cpu_hasher_matches_reference_and_leaves_cuda_alone(
        tmp_path, no_sync_wait, monkeypatch):
    ctx = tmp_path / "ctx"
    make_context(ctx, seed=3, nfiles=12, blob_kb=(32, 8))
    (ctx / "Dockerfile").write_text(DOCKERFILE_COPY)
    for d in ("r1", "r2"):
        (tmp_path / d).mkdir()
    assert ref_build(ctx, tmp_path / "ref", tmp_path / "r1",
                     hasher="cpu") == 0

    def no_cuda(*a, **k):
        raise AssertionError("the cpu hasher asked for CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    monkeypatch.setattr(torch.cuda, "init", no_cuda)
    argv = ["--log-fmt", "json", "build", str(ctx), "-t", "test/app:1",
            "--storage", str(tmp_path / "port"), "--root",
            str(tmp_path / "r2"), "--hasher", "cpu"]
    assert cli.main(argv) == 0  # device=None: the default
    assert not torch.cuda.is_initialized()
    assert_same_image(tmp_path / "ref", tmp_path / "port")
    assert not any("chunks" in e for e in kv_entries(tmp_path / "port")
                   .values() if isinstance(e, dict))


@pytest.mark.parametrize("first", ["reference", "port"])
def test_storage_is_shared_across_builders(tmp_path, no_sync_wait, first):
    ctx = tmp_path / "ctx"
    make_context(ctx, seed=4, nfiles=16, blob_kb=(48, 8))
    (ctx / "Dockerfile").write_text(DOCKERFILE_COPY)
    builders = {"reference": ref_build, "port": port_build}
    second = "port" if first == "reference" else "reference"
    storage = tmp_path / "storage"
    for d in ("r1", "r2"):
        (tmp_path / d).mkdir()
    log1, log2 = tmp_path / "first.log", tmp_path / "second.log"
    assert builders[first](ctx, storage, tmp_path / "r1", log=log1) == 0
    before = load_image(storage)
    assert builders[second](ctx, storage, tmp_path / "r2", log=log2) == 0
    after = load_image(storage)
    committed = count_lines(log1, "committed layer")
    assert committed == len(before[0]["layers"]) == 3
    assert count_lines(log2, "committed layer") == 0
    assert count_lines(log2, "cache hit") == committed
    assert count_lines(log2, " -> ") == committed
    assert after[0]["layers"] == before[0]["layers"]
    assert timeless(after[1]) == timeless(before[1])


def pgzip_chunk_route(tmp_path, first, second):
    """``first`` builds with pgzip into one storage; with the blobs local
    ``second`` hits at every step and builds the same image. Then every
    blob is deleted and ``second`` rebuilds with ``--dest``: a lazy
    chunk-route hit at every step, each layer applied from chunks and its
    pgzip blob reconstituted byte for byte."""
    ctx = tmp_path / "ctx"
    make_context(ctx, seed=5, nfiles=8, blob_kb=(160, 8))
    (ctx / "Dockerfile").write_text(DOCKERFILE_COPY)
    storage = tmp_path / "storage"
    for d in ("r1", "r2", "r3"):
        (tmp_path / d).mkdir()
    assert first(ctx, storage, tmp_path / "r1", "--gzip-backend",
                 "pgzip") == 0
    ref_image = load_image(storage)
    entries = kv_entries(storage)
    assert {e["gz"] for e in entries.values()
            if isinstance(e, dict)} == {"pgzip-6-131072"}
    log = tmp_path / "second.log"
    assert second(ctx, storage, tmp_path / "r2", log=log) == 0
    assert count_lines(log, " -> ") == 3
    assert count_lines(log, "committed layer") == 0
    manifest, config = load_image(storage)
    assert manifest["layers"] == ref_image[0]["layers"]
    assert config["rootfs"]["diff_ids"] == ref_image[1]["rootfs"]["diff_ids"]
    assert kv_entries(storage) == entries

    deleted = {}
    for desc in manifest["layers"]:
        hex_digest = desc["digest"].split(":")[1]
        path = storage / "layers" / hex_digest[:2] / hex_digest
        deleted[path] = path.read_bytes()
        path.unlink()
    log = tmp_path / "third.log"
    assert second(ctx, storage, tmp_path / "r3", "--dest",
                  str(tmp_path / "image.tar"), log=log) == 0
    assert count_lines(log, "(lazy: ") == 3
    assert count_lines(log, "chunks (no blob, no gzip)") == 3
    assert count_lines(log, "committed layer") == 0
    assert count_lines(log, "reconstituted layer") == 3
    assert load_image(storage)[0]["layers"] == manifest["layers"]
    for path, blob in deleted.items():
        assert path.read_bytes() == blob


def test_pgzip_entries_are_misses_for_the_port(tmp_path, no_sync_wait):
    """Formerly a divergence (a pgzip entry whose blob was gone was a miss
    for the port); now a reference pgzip entry is a chunk-route hit for
    the port, and the port reconstitutes the reference's pgzip blob byte
    for byte."""
    pgzip_chunk_route(tmp_path, ref_build, port_build)


def test_port_pgzip_entries_serve_the_reference_from_chunks(
        tmp_path, no_sync_wait):
    """The other direction: the port writes pgzip, the reference replays
    it from the chunks the port indexed."""
    pgzip_chunk_route(tmp_path, port_build, ref_build)


def test_from_a_local_image(tmp_path, no_sync_wait):
    ctx = tmp_path / "ctx"
    make_context(ctx, seed=6, nfiles=8, blob_kb=(16, 8))
    (ctx / "Dockerfile").write_text(DOCKERFILE_COPY)
    (ctx / "Dockerfile.derived").write_text(
        "FROM test/app:1\nCOPY hello.txt /derived.txt\n")
    for d in ("r1", "r2", "r3", "r4"):
        (tmp_path / d).mkdir()
    for name, build, root in (("ref", ref_build, "r1"),
                              ("port", port_build, "r2")):
        assert build(ctx, tmp_path / name, tmp_path / root) == 0
    args = ("-f", str(ctx / "Dockerfile.derived"))
    assert ref_build(ctx, tmp_path / "ref", tmp_path / "r3", *args) == 0
    assert port_build(ctx, tmp_path / "port", tmp_path / "r4", *args) == 0
    manifest, config = assert_same_image(tmp_path / "ref",
                                         tmp_path / "port")
    assert len(manifest["layers"]) == 4
    assert config["config"]["Entrypoint"] == ["/srv/app/run"]


@pytest.mark.parametrize("cpus", [1, 8])
def test_inline_and_threaded_sinks_build_the_same_image(
        tmp_path, no_sync_wait, monkeypatch, cpus):
    """The layer sink compresses on a worker thread on multicore hosts
    only; either way the image and its cache entries are identical to
    the reference's."""
    ctx = tmp_path / "ctx"
    make_context(ctx, seed=7, nfiles=10, blob_kb=(24, 8))
    (ctx / "Dockerfile").write_text(DOCKERFILE_COPY)
    for d in ("r1", "r2"):
        (tmp_path / d).mkdir()
    assert ref_build(ctx, tmp_path / "ref", tmp_path / "r1") == 0
    monkeypatch.setattr("os.cpu_count", lambda: cpus)
    assert port_build(ctx, tmp_path / "port", tmp_path / "r2") == 0
    assert_same_image(tmp_path / "ref", tmp_path / "port")


def test_gzip_backend_auto_matches_reference_with_native(tmp_path,
                                                         no_sync_wait):
    """Fault C1 closed: with both native libraries present, ``auto``
    commits pgzip in both packages, so the manifests and the KV ``gz``
    ids are equal, and every layer went through the native sink."""
    ctx = tmp_path / "ctx"
    make_context(ctx, seed=9, nfiles=14, blob_kb=(200, 8))
    (ctx / "Dockerfile").write_text(DOCKERFILE_COPY)
    for d in ("r1", "r2"):
        (tmp_path / d).mkdir()
    log = tmp_path / "port.log"
    assert ref_build(ctx, tmp_path / "ref", tmp_path / "r1",
                     "--gzip-backend", "auto") == 0
    assert port_build(ctx, tmp_path / "port", tmp_path / "r2",
                      "--gzip-backend", "auto", log=log) == 0
    manifest, _ = assert_same_image(tmp_path / "ref", tmp_path / "port")
    entries = [e for e in kv_entries(tmp_path / "port").values()
               if isinstance(e, dict)]
    assert {e["gz"] for e in entries} == {"pgzip-6-131072"}
    assert len(entries) == len(manifest["layers"]) == 3
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    commits = [r for r in recs if r["msg"].startswith("committed layer")]
    assert [r["sink"] for r in commits] == ["native"] * 3
    assert any(r["msg"] == "gzip backend auto-selected: pgzip"
               for r in recs)
    assert check_layers(tmp_path / "port") > 10


def read_ahead_tar(tmp_path, entries, mode):
    """The layer tar ``Layer.commit`` writes in ``mode``: ``serial`` (no
    pool), ``buffer`` (a Python tar writer fed prefetched bytes) or
    ``warm`` (the native writer with a pool, which streams every file in
    C++ with no read-ahead)."""
    from makisu_tpu_torch.chunker.hasher import CPUHasher, LayerSink
    from makisu_tpu_torch.snapshot.layer import Layer

    layer = Layer()
    for src, dst, hdr in entries:
        layer.add_header(src, dst, hdr)
    workers = 1 if mode == "serial" else 4
    path = tmp_path / f"{mode}.gz"
    with open(path, "wb") as out:
        sink = (CPUHasher().open_layer(out, "zlib-1") if mode == "warm"
                else LayerSink(out, "zlib-1"))
        assert sink.route == ("native" if mode == "warm" else "python")
        with sink.open_tar() as tw:
            layer.commit(tw, workers=workers)
        sink.finish()
    return gzip.decompress(path.read_bytes())


@pytest.mark.parametrize("mode", ["serial", "buffer", "warm"])
def test_read_ahead_modes_write_the_serial_tar(tmp_path, monkeypatch, mode):
    from makisu_tpu.snapshot.layer import Layer as RefLayer
    from makisu_tpu_torch.snapshot import layer as layer_mod

    ctx = tmp_path / "ctx"
    make_context(ctx, seed=10, nfiles=40, blob_kb=(300, 12))
    entries = []
    with tarfile.open(fileobj=io.BytesIO(), mode="w") as tf:
        for dirpath, dirs, files in os.walk(ctx):
            dirs.sort()
            for name in sorted(dirs + files):
                src = os.path.join(dirpath, name)
                rel = os.path.relpath(src, ctx)
                entries.append((src, "/" + rel, tf.gettarinfo(src, rel)))
    prefetched, reads = [], []
    real_take = layer_mod._ReadAhead.take
    real_read = layer_mod._ReadAhead._read

    def take(self, key):
        data = real_take(self, key)
        prefetched.append(data is not None)
        return data

    def read(self, src, size):
        reads.append(src)
        return real_read(self, src, size)

    monkeypatch.setattr(layer_mod._ReadAhead, "take", take)
    monkeypatch.setattr(layer_mod._ReadAhead, "_read", read)
    got = read_ahead_tar(tmp_path, entries, mode)
    # makisu_tpu's serial writer gives the same bytes.
    ref = RefLayer()
    for src, dst, hdr in entries:
        ref.add_header(src, dst, hdr)
    want = io.BytesIO()
    with tarfile.open(fileobj=want, mode="w|") as tw:
        ref.commit(tw, workers=1)
    assert got == want.getvalue()
    eligible = sum(hdr.isreg() and hdr.size > 0 for _, _, hdr in entries)
    if mode == "buffer":
        # Buffer mode hands every file's bytes to the writer.
        assert len(prefetched) == len(entries) and eligible > 40
        assert sum(prefetched) == len(set(reads)) == eligible
    else:
        # No pool, or the native writer: no file is read ahead.
        assert prefetched == reads == []


# -- RUN layers: the port's own checks ---------------------------------------

def test_run_layers_are_chunked_exactly(tmp_path):
    ctx = tmp_path / "ctx"
    make_context(ctx, seed=8, nfiles=20, blob_kb=(96,))
    (ctx / "Dockerfile").write_text(
        "FROM scratch AS build\n"
        "COPY app /work/app/\n"
        "RUN cat work/app/pkg0/*.js > work/all.js && echo built > "
        "work/f.txt #!COMMIT\n"
        "FROM scratch\n"
        "COPY --from=build /work/all.js /work/f.txt /app/\n"
        "ADD blob0.bin /app/\n"
        "RUN echo second > app/second.txt #!COMMIT\n"
        "ENV MODE=run\n")
    root = tmp_path / "root"
    root.mkdir()
    log = tmp_path / "build.log"
    assert port_build(ctx, tmp_path / "storage", root, "--modifyfs",
                      "--commit", "explicit", "--dest",
                      str(tmp_path / "image.tar"), log=log) == 0
    assert count_lines(log, "committed layer") == 2
    assert check_layers(tmp_path / "storage") > 10
    with tarfile.open(tmp_path / "image.tar") as tf:
        [export] = json.load(tf.extractfile("manifest.json"))
        names = set()
        for layer in export["Layers"]:
            with tarfile.open(fileobj=io.BytesIO(
                    tf.extractfile(layer).read())) as lt:
                names |= set(lt.getnames())
    assert {"app/all.js", "app/f.txt", "app/blob0.bin",
            "app/second.txt"} <= names
    with open(log) as f:
        commits = [json.loads(line) for line in f
                   if "committed layer" in line]
    for rec in commits:
        assert rec["gear_blocks"] >= 1 and rec["span_launches"] >= 1
        assert rec["session_s"] > 0


# -- CLI flows ----------------------------------------------------------------

@pytest.fixture
def simple_ctx(tmp_path):
    ctx = tmp_path / "ctx"
    ctx.mkdir()
    (ctx / "hello.txt").write_text("hello\n")
    (tmp_path / "root").mkdir()
    return ctx


def build_rc(tmp_path, ctx, dockerfile, *extra, log=None):
    (ctx / "Dockerfile").write_text(dockerfile)
    return port_build(ctx, tmp_path / "storage", tmp_path / "root",
                      *extra, log=log)


def test_run_without_modifyfs_fails(tmp_path, simple_ctx):
    assert build_rc(tmp_path, simple_ctx,
                    "FROM scratch\nRUN echo hi > f.txt\n") == 1


def test_bogus_target_fails(tmp_path, simple_ctx):
    log = tmp_path / "log"
    assert build_rc(tmp_path, simple_ctx, "FROM scratch AS a\n",
                    "--target", "nope", log=log) == 1
    assert count_lines(log, "target stage not found") == 1


def test_missing_dockerfile_fails(tmp_path, simple_ctx):
    assert port_build(simple_ctx, tmp_path / "storage", tmp_path / "root",
                      "-f", str(tmp_path / "absent")) == 1


def test_registry_from_is_not_ported(tmp_path, simple_ctx):
    """A FROM image neither in the local store nor in its registry fails
    the build (rc 1). The registry route itself is ported: the pull goes
    through the port's client (here to an empty in-process registry, so
    nothing leaves the process) and its 404 is the build's error."""
    from makisu_tpu_torch.registry import RegistryFixture
    from makisu_tpu_torch.registry import client as port_client

    fixture = RegistryFixture()
    port_client.set_transport_factory(lambda name: fixture)
    try:
        log = tmp_path / "log"
        assert build_rc(tmp_path, simple_ctx,
                        "FROM alpine:3.19\nCOPY hello.txt /h\n",
                        log=log) == 1
    finally:
        port_client.set_transport_factory(None)
    assert [u for m, u in fixture.requests if m == "GET"] == [
        "https://index.docker.io/v2/library/alpine/manifests/3.19"]
    assert count_lines(log, "HTTP 404") == 1


@pytest.mark.parametrize("flag", [
    ["--jax-profile", "d"], ["--gzip-backend=native"],
    ["--gzip-backend", "native"], ["--hasher", "tpu"]])
def test_unported_flags_are_rejected(tmp_path, simple_ctx, flag):
    with pytest.raises(SystemExit) as e:
        build_rc(tmp_path, simple_ctx, "FROM scratch\n", *flag)
    assert e.value.code == 2


@pytest.mark.parametrize("flag", [
    ["--storage-budget=10"], ["--storage-remote=REMOTE"],
    ["--storage-budget", "10"], ["--storage-remote", "REMOTE"]])
def test_storage_flags_set_the_build_storage_governance(
        tmp_path, simple_ctx, flag, monkeypatch):
    """``--storage-budget MB`` budgets the build's storage dir alone
    (in bytes, as the reference's ``set_budget_for``) and runs one
    eviction pass after the build; ``--storage-remote DIR`` names the
    process's remote tier (``configure``), as in the reference."""
    from makisu_tpu_torch.storage import contentstore
    monkeypatch.setattr(contentstore, "_config", {
        "budget_bytes": None, "remote_dir": None,
        "tenant_quota_bytes": None})
    monkeypatch.setattr(contentstore, "_dir_budgets", {})
    flag = [f.replace("REMOTE", str(tmp_path / "remote")) for f in flag]
    assert build_rc(tmp_path, simple_ctx,
                    "FROM scratch\nCOPY hello.txt /h\n", *flag) == 0
    storage = str(tmp_path / "storage")
    cstore = contentstore.store_for(storage)
    if "budget" in flag[0]:
        assert contentstore.budget_bytes_for(storage) == 10 << 20
        assert contentstore.budget_bytes_for(str(tmp_path)) == 0
        last = cstore.describe()["last_eviction"]
        assert last["budget_bytes"] == 10 << 20 and last["evicted"] == 0
    else:
        assert contentstore.remote_tier_dir() == str(tmp_path / "remote")
        assert cstore.describe()["remote_tier"] == str(tmp_path / "remote")
        assert cstore.maybe_evict() is None  # unbudgeted: no pass


def test_version_prints_the_build_hash(capsys):
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out.strip() == ref_cli.makisu_tpu.BUILD_HASH


def test_gpu_hasher_without_cuda_fails_the_build(tmp_path, simple_ctx,
                                                 monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (simple_ctx / "Dockerfile").write_text(
        "FROM scratch\nCOPY hello.txt /h\n")
    argv = ["build", str(simple_ctx), "-t", "test/app:1", "--storage",
            str(tmp_path / "storage"), "--root", str(tmp_path / "root")]
    assert cli.main(argv) == 1  # the default hasher and device: the card
    assert not (tmp_path / "storage" / "manifests" / "test").exists()


def test_device_error_fails_the_build_without_fallback(
        tmp_path, simple_ctx, monkeypatch, no_sync_wait):
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise RuntimeError("device lost")

    monkeypatch.setattr(gear_cuda, "gear_bitmap", broken)
    log = tmp_path / "log"
    assert build_rc(tmp_path, simple_ctx,
                    "FROM scratch\nCOPY hello.txt /h\n", log=log) == 1
    assert calls == [1]
    assert count_lines(log, "device lost") == 1
    assert count_lines(log, "committed layer") == 0
    assert not (tmp_path / "storage" / "manifests" / "test").exists()
